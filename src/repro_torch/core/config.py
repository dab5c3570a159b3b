"""Memory-controller configuration — the paper's Table I as a validated config.

A field-for-field copy of ``repro.core.config`` (the JAX package), kept
here because ``repro_torch`` imports nothing from ``repro``; the parity
test ``tests/test_torch_config.py`` holds the two copies equal.

The paper exposes every controller knob as a synthesis-time HDL parameter;
a ``MemoryControllerConfig`` is the same knob set, validated once at
construction. ``vmem_footprint_bytes`` keeps its name for parity with the
reference; on the GPU it reads as the on-chip (shared-memory) budget.

Dependency classes mirror Table I:
  PL   — platform (accelerator generation / memory interface) constraints,
  RS   — resource (on-chip memory budget) constraints,
  SPEC — functional specification of the attached accelerator (model),
  TUNE — tunable; the reference's ``repro.core.autotune`` searches these.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional


def _check_range(name: str, value: int, lo: int, hi: int) -> None:
    if not lo <= value <= hi:
        raise ValueError(
            f"{name}={value} outside supported range [{lo}, {hi}] "
            "(see Table I of the paper)"
        )


def _check_pow2(name: str, value: int) -> None:
    if value < 1 or value & (value - 1):
        raise ValueError(f"{name}={value} must be a power of two")


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """Memory scheduler parameters (Table I, 'Memory Scheduler')."""

    enabled: bool = True
    # Max requests reordered per batch. Paper range 4-128; Fig. 6 explores up
    # to 512 before resource use becomes impractical. [TUNE]
    batch_size: int = 64
    # Max cycles spent on batch formation before a partial batch is issued.
    # Prevents deadlock under low traffic. [TUNE]
    timeout_cycles: int = 16
    # Bypass scheduling when the incoming stream is already sequential or
    # traffic is low (paper §V-C).
    bypass_sequential: bool = True
    # Parallel<->serial data conditioning latency around the sorting network
    # (paper: < 2 cycles).
    data_cond_cycles: int = 2

    def __post_init__(self) -> None:
        _check_range("scheduler.batch_size", self.batch_size, 4, 512)
        _check_pow2("scheduler.batch_size", self.batch_size)
        _check_range("scheduler.timeout_cycles", self.timeout_cycles, 4, 40)


@dataclasses.dataclass(frozen=True)
class CacheConfig:
    """Cache engine parameters (Table I, 'Cache')."""

    enabled: bool = True
    # Cache line width in *bits* to match the paper's table (256-1024 typical;
    # Table III explores to 4096).
    line_width_bits: int = 512
    num_lines: int = 4096
    # Degree of set-associativity. [TUNE]
    associativity: int = 4
    # Write policy for WRITE requests (write-allocate both ways):
    # "write_back" keeps dirty lines in Data RAM until eviction (victim
    # flush on the MEM pipeline), "write_through" mirrors every write to
    # DRAM immediately. [TUNE]
    write_policy: str = "write_back"

    def __post_init__(self) -> None:
        _check_range("cache.line_width_bits", self.line_width_bits, 256, 4096)
        _check_range("cache.num_lines", self.num_lines, 256, 32768)
        _check_range("cache.associativity", self.associativity, 1, 16)
        _check_pow2("cache.num_lines", self.num_lines)
        _check_pow2("cache.associativity", self.associativity)
        if self.associativity > self.num_lines:
            raise ValueError("associativity cannot exceed num_lines")
        if self.write_policy not in ("write_back", "write_through"):
            raise ValueError(
                f"cache.write_policy={self.write_policy!r} must be "
                "'write_back' or 'write_through'")

    @property
    def line_bytes(self) -> int:
        return self.line_width_bits // 8

    @property
    def num_sets(self) -> int:
        return self.num_lines // self.associativity

    @property
    def capacity_bytes(self) -> int:
        return self.num_lines * self.line_bytes


@dataclasses.dataclass(frozen=True)
class ChannelConfig:
    """Memory-channel / address-mapping parameters (Table-I-style front end).

    The paper's controller is synthesized against one memory interface;
    HBM-class parts expose several independent channels behind the same
    address space. These knobs pick how the flat physical address is
    decomposed into (channel, bank, row) — the choice that the Memory
    Controller Wall study (arXiv:1910.06726) shows dominates sustained
    bandwidth on FPGA memory interfaces. [PL+TUNE]
    """

    #: independent DRAM channels simulated in parallel (1 = the paper's
    #: single-interface design; 8 covers HBM2 stack halves).
    num_channels: int = 1
    #: block-interleave granularity in bytes — consecutive blocks of this
    #: size round-robin across channels (ignored by "row_interleave",
    #: which interleaves at DRAM-row granularity).
    interleave_bytes: int = 256
    #: channel-select policy:
    #:   "row_interleave"   — consecutive DRAM rows rotate channels,
    #:   "block_interleave" — consecutive interleave_bytes blocks rotate,
    #:   "xor"              — block index XOR-folded with higher address
    #:                        bits (breaks power-of-two stride camping).
    policy: str = "row_interleave"

    _POLICIES = ("row_interleave", "block_interleave", "xor")

    def __post_init__(self) -> None:
        _check_range("channels.num_channels", self.num_channels, 1, 16)
        _check_pow2("channels.num_channels", self.num_channels)
        _check_range("channels.interleave_bytes", self.interleave_bytes,
                     64, 1 << 20)
        _check_pow2("channels.interleave_bytes", self.interleave_bytes)
        if self.policy not in self._POLICIES:
            raise ValueError(
                f"channels.policy={self.policy!r} must be one of "
                f"{self._POLICIES}")


@dataclasses.dataclass(frozen=True)
class DRAMSchedConfig:
    """DRAM command-scheduler parameters (the controller's back end).

    The front-end batch scheduler reorders *requests* before they reach
    the memory interface; this config governs how the interface itself
    issues *DRAM commands* out of its pending queue — the reordering
    class "The Memory Controller Wall" (arXiv:1910.06726) shows
    separates naive interface IPs from real controllers. [TUNE]

    ``policy``:
      "fifo"        — strict arrival order (the pre-scheduler model);
      "frfcfs"      — first-ready, first-come-first-served: within a
                      ``reorder_window`` lookahead, the oldest request
                      that hits an already-open row is issued first;
                      misses are issued oldest-first when no pending
                      request is row-ready;
      "frfcfs_cap"  — FR-FCFS with a starvation cap: once
                      ``starvation_cap`` younger requests have been
                      issued past a waiting request, it is forced out
                      next (bounds per-request slip; property-tested).

    ``t_rfc`` / ``t_refi`` model refresh (in DRAM command clocks):
    every ``t_refi`` cycles of service a channel stalls for ``t_rfc``
    and all its banks precharge (open rows close). ``t_refi=0``
    disables refresh (the pre-refresh model).
    """

    policy: str = "fifo"
    #: lookahead window (pending DRAM commands eligible for promotion).
    #: 1 degenerates to FIFO regardless of policy.
    reorder_window: int = 1
    #: max younger issues past a waiting request before it is forced
    #: (only consulted by "frfcfs_cap").
    starvation_cap: int = 16
    #: refresh cycle time (stall per refresh), DRAM clocks.
    t_rfc: int = 0
    #: average refresh interval, DRAM clocks; 0 disables refresh.
    t_refi: int = 0

    _POLICIES = ("fifo", "frfcfs", "frfcfs_cap")

    def __post_init__(self) -> None:
        if self.policy not in self._POLICIES:
            raise ValueError(
                f"dram_sched.policy={self.policy!r} must be one of "
                f"{self._POLICIES}")
        _check_range("dram_sched.reorder_window", self.reorder_window,
                     1, 512)
        _check_range("dram_sched.starvation_cap", self.starvation_cap,
                     1, 1 << 20)
        if self.t_rfc < 0 or self.t_refi < 0:
            raise ValueError("dram_sched t_rfc/t_refi must be >= 0")
        if self.t_refi and self.t_rfc >= self.t_refi:
            raise ValueError(
                f"dram_sched.t_rfc={self.t_rfc} must be strictly less "
                f"than t_refi={self.t_refi}: the channel would refresh "
                "longer than it services")

    @property
    def effective_window(self) -> int:
        """The window actually applied: FIFO never reorders."""
        return 1 if self.policy == "fifo" else self.reorder_window


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """RAS / fault-injection parameters (the controller's reliability
    back end — ARCHITECTURE.md §10).

    Real DDR4/HBM parts ship ECC, write-CRC retry and refresh-rate
    escalation because the controller must keep serving through faults;
    this config drives a *deterministic, seeded* fault model on the DRAM
    service stream plus the controller's response policies. All
    injection is a pure function of ``(seed, channel, request index,
    attempt)`` — re-running a trace reproduces the same storm
    bit-for-bit.

    Injection knobs:
      ``transient_ber``      — per-access transient error probability;
      ``weak_row_fraction``  — fraction of DRAM rows that are weak
                               (chosen by a seeded hash of the row id);
      ``weak_row_ber``       — *additional* per-access error
                               probability on weak rows (hot spots);
      ``outage_windows``     — ``(channel, start, end)`` intervals in
                               DRAM clocks during which that channel
                               cannot issue (transient outage: pending
                               work stalls, nothing is dropped);
      ``failed_channels``    — channels failed for the whole run; the
                               ``AddressMap`` re-maps their traffic to
                               the surviving channels.

    Error-handling knobs:
      ``ecc``                — "secded" detects every injected error
                               and corrects the non-DUE ones at
                               ``ecc_correction_clocks`` per corrected
                               access; "none" makes read errors silent;
      ``due_fraction``       — fraction of detected errors that exceed
                               SECDED correction (reads only) and must
                               be replayed;
      ``write_crc``          — when True, errored writes fail the link
                               CRC and replay; when False they are
                               silent corruption;
      ``max_replays``        — bound on replays per request; a request
                               whose last allowed attempt still errors
                               is counted *dropped* (surfaced in
                               ``FaultStats``, never silently lost);
      ``backoff_clocks``     — base replay backoff in DRAM clocks,
                               doubling per failed attempt
                               (``backoff << (attempt-1)``); 0 replays
                               immediately (the naive policy).

    Degradation knobs:
      ``row_retire_threshold``     — errors charged to one row before
                                     it is retired to a spare (0 off);
      ``max_retired_rows``         — spare rows per channel;
      ``refresh_escalate_threshold`` — injected errors per escalation
                                     level: each level halves the
                                     effective ``t_refi`` (0 off);
      ``refresh_escalate_max``     — cap on escalation levels.
    """

    seed: int = 0
    transient_ber: float = 0.0
    weak_row_fraction: float = 0.0
    weak_row_ber: float = 0.0
    due_fraction: float = 0.0
    ecc: str = "secded"
    ecc_correction_clocks: int = 4
    write_crc: bool = True
    max_replays: int = 4
    backoff_clocks: int = 16
    row_retire_threshold: int = 0
    max_retired_rows: int = 64
    refresh_escalate_threshold: int = 0
    refresh_escalate_max: int = 3
    failed_channels: tuple = ()
    outage_windows: tuple = ()

    _ECC = ("none", "secded")

    def __post_init__(self) -> None:
        for name in ("transient_ber", "weak_row_fraction", "weak_row_ber",
                     "due_fraction"):
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"faults.{name}={v} must be in [0, 1]")
        if self.ecc not in self._ECC:
            raise ValueError(
                f"faults.ecc={self.ecc!r} must be one of {self._ECC}")
        _check_range("faults.ecc_correction_clocks",
                     self.ecc_correction_clocks, 0, 1 << 10)
        _check_range("faults.max_replays", self.max_replays, 0, 64)
        _check_range("faults.backoff_clocks", self.backoff_clocks,
                     0, 1 << 20)
        _check_range("faults.row_retire_threshold",
                     self.row_retire_threshold, 0, 1 << 20)
        _check_range("faults.max_retired_rows", self.max_retired_rows,
                     0, 1 << 16)
        _check_range("faults.refresh_escalate_threshold",
                     self.refresh_escalate_threshold, 0, 1 << 30)
        _check_range("faults.refresh_escalate_max",
                     self.refresh_escalate_max, 0, 8)
        if self.seed < 0:
            raise ValueError("faults.seed must be >= 0")
        for ch in self.failed_channels:
            if not isinstance(ch, int) or ch < 0:
                raise ValueError(
                    "faults.failed_channels must be non-negative channel "
                    "indices")
        if len(set(self.failed_channels)) != len(self.failed_channels):
            raise ValueError("faults.failed_channels has duplicates")
        for win in self.outage_windows:
            if (len(win) != 3 or any(int(x) != x for x in win)
                    or win[0] < 0 or win[1] < 0 or win[2] <= win[1]):
                raise ValueError(
                    f"faults.outage_windows entry {win!r} must be "
                    "(channel, start, end) with 0 <= start < end in "
                    "DRAM clocks")

    @property
    def injects(self) -> bool:
        """True when the service stream can see any injected event
        (errors or transient outage stalls)."""
        return bool(self.transient_ber > 0.0
                    or (self.weak_row_fraction > 0.0
                        and self.weak_row_ber > 0.0)
                    or self.outage_windows)

    @property
    def active(self) -> bool:
        """True when the fault layer changes *anything* about the run;
        False degenerates bit-identically to the fault-free pipeline."""
        return self.injects or bool(self.failed_channels)

    def backoff_for(self, attempt: int) -> int:
        """Backoff in DRAM clocks before replay number ``attempt``
        (1-based), doubling per failed attempt."""
        return self.backoff_clocks << max(0, attempt - 1)

    def outage_windows_for(self, channel: int) -> list[tuple[int, int]]:
        """Sorted ``(start, end)`` outage intervals for one channel."""
        return sorted((int(s), int(e)) for ch, s, e in self.outage_windows
                      if int(ch) == channel)


@dataclasses.dataclass(frozen=True)
class DMAConfig:
    """DMA engine parameters (Table I, 'Direct Memory Access')."""

    enabled: bool = True
    # Largest single bulk transaction (256B - 256KB).
    max_transaction_bytes: int = 16384
    # Number of parallel DMA buffers/channels (1-8). On TPU this is the
    # depth of in-flight async HBM copies. [SPEC+TUNE]
    num_parallel_dma: int = 4
    # Staging buffer per channel; on TPU this is VMEM occupied per channel.
    buffer_bytes: int = 16384

    def __post_init__(self) -> None:
        _check_range("dma.max_transaction_bytes", self.max_transaction_bytes,
                     256, 256 * 1024)
        _check_range("dma.num_parallel_dma", self.num_parallel_dma, 1, 8)
        _check_range("dma.buffer_bytes", self.buffer_bytes, 256, 1 << 20)


@dataclasses.dataclass(frozen=True)
class MemoryControllerConfig:
    """Top-level controller config (paper Table I, 'Overall Design')."""

    # --- platform (PL) ---
    # External memory interface width. DDR4 on U250 is 64B (512b); TPU v5e
    # HBM transactions are modeled at 512B bursts.
    mem_if_data_width_bytes: int = 512
    mem_if_addr_width: int = 31
    # --- application spec (SPEC) ---
    app_io_data_width_bytes: int = 64
    app_addr_width: int = 32
    num_pes: int = 8
    # --- engines ---
    scheduler: SchedulerConfig = dataclasses.field(default_factory=SchedulerConfig)
    cache: CacheConfig = dataclasses.field(default_factory=CacheConfig)
    dma: DMAConfig = dataclasses.field(default_factory=DMAConfig)
    channels: ChannelConfig = dataclasses.field(default_factory=ChannelConfig)
    dram_sched: DRAMSchedConfig = dataclasses.field(
        default_factory=DRAMSchedConfig)
    #: RAS / fault-injection model; ``None`` (or an all-zero-rate
    #: config) is the perfectly-reliable device and degenerates
    #: bit-identically to the fault-free pipeline.
    faults: Optional[FaultConfig] = None
    # FLIT generation + path-selection latency budget (paper: <= 10 cycles).
    ctrl_overhead_cycles: int = 10

    def __post_init__(self) -> None:
        _check_range("mem_if_data_width_bytes", self.mem_if_data_width_bytes,
                     64, 512)
        _check_range("mem_if_addr_width", self.mem_if_addr_width, 20, 36)
        _check_range("app_io_data_width_bytes", self.app_io_data_width_bytes,
                     1, 512)
        _check_range("app_addr_width", self.app_addr_width, 20, 40)
        _check_range("num_pes", self.num_pes, 1, 128)
        _check_range("ctrl_overhead_cycles", self.ctrl_overhead_cycles, 0, 10)
        if not (self.scheduler.enabled or self.cache.enabled
                or self.dma.enabled):
            raise ValueError(
                "at least one engine (scheduler/cache/dma) must be enabled")
        if self.faults is not None:
            nch = self.channels.num_channels
            bad = [c for c in self.faults.failed_channels if c >= nch]
            if bad:
                raise ValueError(
                    f"faults.failed_channels {bad} outside "
                    f"[0, num_channels={nch})")
            if len(self.faults.failed_channels) >= nch:
                raise ValueError(
                    "faults.failed_channels would fail every channel — "
                    "at least one must survive")
            bad = [w for w in self.faults.outage_windows if w[0] >= nch]
            if bad:
                raise ValueError(
                    f"faults.outage_windows channels {bad} outside "
                    f"[0, num_channels={nch})")

    # ---- derived resource model (paper §V-B analogue) --------------------
    def vmem_footprint_bytes(self) -> int:
        """On-chip (VMEM) bytes claimed by the configured engines.

        FPGA URAM/BRAM consumption (Table III / Fig. 5 / Fig. 6) maps to the
        VMEM working set on TPU. Used by benchmarks and by the autotuner's
        resource constraint.
        """
        total = 0
        if self.cache.enabled:
            # data + tags (tag ~ 4B/line) + LRU age (4B/line)
            total += self.cache.capacity_bytes + 8 * self.cache.num_lines
        if self.dma.enabled:
            # double-buffered staging per channel
            total += 2 * self.dma.num_parallel_dma * self.dma.buffer_bytes
        if self.scheduler.enabled:
            # key/value pairs being sorted, double-buffered input queues —
            # replicated per memory channel (each channel owns a scheduler
            # front end; one channel is the paper's single-interface case).
            n = self.scheduler.batch_size
            total += self.channels.num_channels * (
                2 * n * 8 + 2 * n * self.app_io_data_width_bytes)
        # DRAM command scheduler: each channel holds a reorder CAM of
        # pending commands (addr tag + bank/row decode + age counter,
        # ~16B per entry). A 1-deep window is the plain FIFO head.
        total += (self.channels.num_channels
                  * self.dram_sched.effective_window * 16)
        if self.faults is not None and self.faults.active:
            # RAS state per channel: replay CAM (bounded by the reorder
            # window, addr tag + attempt counter + ready stamp ~ 24B),
            # the row-retirement indirection CAM (row tag + spare id,
            # 16B per retirable row) and an error-counter CAM of the
            # same depth.
            total += self.channels.num_channels * (
                self.dram_sched.effective_window * 24
                + self.faults.max_retired_rows * 24)
        return total

    def describe(self) -> str:
        lines = [
            "MemoryControllerConfig:",
            f"  mem-if {self.mem_if_data_width_bytes}B / "
            f"addr {self.mem_if_addr_width}b, "
            f"app-io {self.app_io_data_width_bytes}B, PEs={self.num_pes}",
            f"  scheduler: enabled={self.scheduler.enabled} "
            f"batch={self.scheduler.batch_size} "
            f"timeout={self.scheduler.timeout_cycles}",
            f"  cache: enabled={self.cache.enabled} "
            f"line={self.cache.line_width_bits}b x {self.cache.num_lines} "
            f"ways={self.cache.associativity} "
            f"({self.cache.capacity_bytes / 1024:.0f} KiB)",
            f"  dma: enabled={self.dma.enabled} "
            f"channels={self.dma.num_parallel_dma} "
            f"txn<={self.dma.max_transaction_bytes}B",
            f"  mem channels: {self.channels.num_channels} "
            f"({self.channels.policy}, "
            f"interleave={self.channels.interleave_bytes}B)",
            f"  dram sched: {self.dram_sched.policy} "
            f"window={self.dram_sched.effective_window} "
            f"cap={self.dram_sched.starvation_cap} "
            f"refresh={'off' if not self.dram_sched.t_refi else f'{self.dram_sched.t_rfc}/{self.dram_sched.t_refi}'}",
            f"  vmem footprint ~ {self.vmem_footprint_bytes() / 1024:.1f} KiB",
        ]
        if self.faults is not None:
            f = self.faults
            lines.insert(-1, (
                f"  faults: ber={f.transient_ber:g} "
                f"weak={f.weak_row_fraction:g}@{f.weak_row_ber:g} "
                f"ecc={f.ecc} replays<={f.max_replays} "
                f"backoff={f.backoff_clocks} "
                f"failed_ch={list(f.failed_channels)} "
                f"outages={len(f.outage_windows)}"))
        return "\n".join(lines)


def scheduler_sort_stages(batch_size: int) -> int:
    """Bitonic network stage count for a batch of N: log2(N)(log2(N)+1)/2."""
    logn = int(math.log2(batch_size))
    return logn * (logn + 1) // 2


# Paper Table IV — the configuration used for the GCN/CNN evaluation.
PAPER_EVAL_CONFIG = MemoryControllerConfig(
    cache=CacheConfig(line_width_bits=512, num_lines=4096, associativity=4),
    dma=DMAConfig(buffer_bytes=16 * 1024, num_parallel_dma=4),
    scheduler=SchedulerConfig(batch_size=64, timeout_cycles=16),
)

# The headline *combined* configuration: Table IV's cache + scheduler
# engines composed with the 4-channel front end — the setting where the
# paper's access-time wins come from the composition of the stages
# rather than any stage alone (the `simulate()` pipeline's default
# benchmark target; `benchmarks/perf_pipeline.py`).
PAPER_COMBINED_CONFIG = MemoryControllerConfig(
    cache=CacheConfig(line_width_bits=512, num_lines=4096, associativity=4),
    dma=DMAConfig(buffer_bytes=16 * 1024, num_parallel_dma=4),
    scheduler=SchedulerConfig(batch_size=64, timeout_cycles=16),
    channels=ChannelConfig(num_channels=4, policy="row_interleave"),
)
