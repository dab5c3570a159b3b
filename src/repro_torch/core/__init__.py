"""Core — the paper's programmable memory controller in PyTorch.

The unified request-routing IP is ``controller.MemoryController``; the
scheduler's data plane is ``scheduler.sort_requests``; ``timing`` carries
the DRAM timing parameters and Eq. 1. Counterpart of ``repro.core`` for
the names this slice of the port covers.
"""

from repro_torch.core.config import (CacheConfig, ChannelConfig, DMAConfig,
                                     DRAMSchedConfig,
                                     MemoryControllerConfig,
                                     PAPER_COMBINED_CONFIG,
                                     PAPER_EVAL_CONFIG, SchedulerConfig)
from repro_torch.core.controller import (HotRowCache, MemoryController,
                                         sorted_gather, sorted_scatter)
from repro_torch.core.timing import (DDR4_2400, DRAMTimings, HBM_V5E,
                                     t_schedule)

__all__ = [
    "CacheConfig", "ChannelConfig", "DMAConfig", "DRAMSchedConfig",
    "MemoryControllerConfig",
    "SchedulerConfig", "PAPER_EVAL_CONFIG", "PAPER_COMBINED_CONFIG",
    "HotRowCache", "MemoryController", "sorted_gather", "sorted_scatter",
    "DDR4_2400", "HBM_V5E", "DRAMTimings", "t_schedule",
]
