"""Public DMA-engine op: shape-agnostic bulk copy through staging buffers.

Chunks the flat payload into ``max_transaction_bytes`` transactions (the
DMA Request Mapper) and runs the multi-channel kernel; the kernel masks
the tail transaction, so nothing is padded in memory. Value-identical to a
copy of ``src``. Counterpart of ``repro.kernels.dma_copy.ops``.
"""

from __future__ import annotations

import torch

from repro_torch.core.config import DMAConfig
from repro_torch.kernels.dma_copy.kernel import staged_copy


def chunk_elems(config: DMAConfig, itemsize: int) -> int:
    """Elements of one transaction: at least 128, as the reference plans."""
    return max(128, config.max_transaction_bytes // itemsize)


def dma_copy(src: torch.Tensor, *, config: DMAConfig | None = None,
             out: torch.Tensor | None = None) -> torch.Tensor:
    """A copy of ``src`` through the staging kernel (its plain version on a
    CPU tensor), of ``src``'s shape; with ``out`` (a contiguous 1-D tensor
    of ``src``'s dtype and size, for example a region of a bulk write's
    destination) the copy lands there and ``out`` is returned."""
    config = config or DMAConfig()
    flat = src.reshape(-1)
    dst = torch.empty_like(flat) if out is None else out
    staged_copy(dst, flat, chunk_elems=chunk_elems(config, flat.element_size()),
                channels=config.num_parallel_dma)
    return dst.view(src.shape) if out is None else dst
