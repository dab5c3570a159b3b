"""PyTorch/CUDA port of the programmable memory controller.

A package beside the JAX reference ``repro``, laid out module for module
(``repro_torch.core``, ``repro_torch.kernels``, ``repro_torch.configs``,
``repro_torch.models``, ``repro_torch.launch``), importing neither JAX nor
``repro``. ``convert`` carries state across from the reference package.
Entry points run on the GPU (``device="cuda"``) unless the caller asks for
the CPU; CUDA kernels are built from ``kernels/csrc`` on first use.
"""

from repro_torch.core import (HotRowCache, MemoryController,
                              MemoryControllerConfig, PAPER_COMBINED_CONFIG,
                              PAPER_EVAL_CONFIG)

__all__ = [
    "HotRowCache", "MemoryController", "MemoryControllerConfig",
    "PAPER_COMBINED_CONFIG", "PAPER_EVAL_CONFIG",
]
