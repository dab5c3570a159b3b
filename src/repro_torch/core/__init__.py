"""Core — the paper's programmable memory controller in PyTorch.

The unified request-routing IP is ``controller.MemoryController``; the
scheduler's data plane is ``scheduler.sort_requests``; the DMA engine is
``dma_engine`` and the cache engine ``cache_engine``; ``timing`` carries
the DRAM/HBM cost model (Eq. 1-3) and the cycle-level simulator behind
the paper-claim numbers, which ``pipeline`` and ``channels`` compose and
``MemoryController.simulate`` / ``modeled_*`` drive. Counterpart of
``repro.core``, the reference package, for the names the port covers.
"""

from repro_torch.core.capture import TraceCapture, active_capture
from repro_torch.core.channels import (AddressMap, ArbiterStats,
                                       ChannelSimResult, arbitrate_ports,
                                       simulate_channels,
                                       simulate_multiport_channels)
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
from repro_torch.core.pipeline import (PipelineContext, PipelineResult,
                                       RequestStream, StageStats,
                                       default_stages, run_pipeline)
from repro_torch.core.timing import (DDR4_2400, DRAMTimings, HBM_V5E,
                                     SchedSimResult, roofline_time_s,
                                     simulate_dram_access,
                                     simulate_dram_sched,
                                     simulate_dram_sched_seq, t_schedule,
                                     turnaround_cycles)

__all__ = [
    "TraceCapture", "active_capture",
    "CacheConfig", "ChannelConfig", "DMAConfig", "DRAMSchedConfig",
    "MemoryControllerConfig",
    "SchedulerConfig", "PAPER_EVAL_CONFIG", "PAPER_COMBINED_CONFIG",
    "HotRowCache", "MemoryController", "sorted_gather", "sorted_scatter",
    "AddressMap", "ArbiterStats", "ChannelSimResult", "arbitrate_ports",
    "simulate_channels", "simulate_multiport_channels", "PipelineContext",
    "PipelineResult", "RequestStream", "StageStats", "default_stages",
    "run_pipeline", "DDR4_2400", "HBM_V5E", "DRAMTimings",
    "SchedSimResult", "roofline_time_s", "simulate_dram_access",
    "simulate_dram_sched", "simulate_dram_sched_seq", "t_schedule",
    "turnaround_cycles",
    "CacheState", "FilterResult", "access_rw", "filter_trace_rw", "flush",
    "hit_rate_oracle", "init_cache", "lookup", "simulate_trace",
    "simulate_trace_rw",
    "TransferPlan", "bulk_copy", "bulk_write", "channel_vmem_bytes",
    "modeled_transfer_cycles", "plan_transfer",
]
