"""Architecture & shape configs (one module per assigned arch).

Counterpart of ``repro.configs``: the same ten configurations, copied.
"""

from repro_torch.configs.base import (ArchConfig, MoESpec, SSMSpec,
                                      ShapeConfig, SHAPES, supported_shapes)
from repro_torch.configs.registry import (ARCH_IDS, all_archs, canonical,
                                          get_arch)

__all__ = ["ArchConfig", "MoESpec", "SSMSpec", "ShapeConfig", "SHAPES",
           "supported_shapes", "ARCH_IDS", "all_archs", "canonical",
           "get_arch"]
