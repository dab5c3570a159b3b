"""Core — the paper's programmable memory controller in PyTorch.

The unified request-routing IP is ``controller.MemoryController``; the
scheduler's data plane is ``scheduler.sort_requests``; the DMA engine is
``dma_engine`` and the cache engine ``cache_engine``; ``timing`` carries
the DRAM timing parameters and Eq. 1. Counterpart of ``repro.core`` for
the names the port covers so far.
"""

from repro_torch.core.config import (CacheConfig, ChannelConfig, DMAConfig,
                                     DRAMSchedConfig,
                                     MemoryControllerConfig,
                                     PAPER_COMBINED_CONFIG,
                                     PAPER_EVAL_CONFIG, SchedulerConfig)
from repro_torch.core.cache_engine import (CacheState, FilterResult,
                                           access_rw, filter_trace_rw, flush,
                                           hit_rate_oracle, init_cache,
                                           lookup, simulate_trace,
                                           simulate_trace_rw)
from repro_torch.core.controller import (HotRowCache, MemoryController,
                                         sorted_gather, sorted_scatter)
from repro_torch.core.dma_engine import (TransferPlan, bulk_copy, bulk_write,
                                         channel_vmem_bytes,
                                         modeled_transfer_cycles,
                                         plan_transfer)
from repro_torch.core.timing import (DDR4_2400, DRAMTimings, HBM_V5E,
                                     t_schedule)

__all__ = [
    "CacheConfig", "ChannelConfig", "DMAConfig", "DRAMSchedConfig",
    "MemoryControllerConfig",
    "SchedulerConfig", "PAPER_EVAL_CONFIG", "PAPER_COMBINED_CONFIG",
    "HotRowCache", "MemoryController", "sorted_gather", "sorted_scatter",
    "DDR4_2400", "HBM_V5E", "DRAMTimings", "t_schedule",
    "CacheState", "FilterResult", "access_rw", "filter_trace_rw", "flush",
    "hit_rate_oracle", "init_cache", "lookup", "simulate_trace",
    "simulate_trace_rw",
    "TransferPlan", "bulk_copy", "bulk_write", "channel_vmem_bytes",
    "modeled_transfer_cycles", "plan_transfer",
]
