"""Unified request-stream pipeline — the controller as ONE staged simulator.

The paper's controller is a single datapath: multi-port front end →
internal caching → request scheduler → DRAM interface, with DMA overlap.
This module composes the repo's stage primitives the same way: a
:class:`RequestStream` (pe_id, addr, rw, arrival order, per-request tags)
flows through :class:`Stage` objects —

    AddressMap → PortArbiter → CacheFilter → BatchScheduler
                             → DRAMService → DMAOverlap

— each emitting typed per-stage statistics into one
:class:`PipelineResult` (end-to-end makespan, per-stage cycle breakdown,
per-channel occupancy, cache hit rate, arbiter fairness). This is the
composition the headline Fig. 7 numbers come from: caching *and*
multi-channel scheduling together, not costed by independent oracles.

Stage contract (docs/ARCHITECTURE.md §7):

* a stage may **annotate** (AddressMap adds channel / local_addr),
  **permute** (PortArbiter, BatchScheduler), **drop** (CacheFilter
  removes served hits; the scheduler's write coalescing merges duplicate
  rows) or **insert** (CacheFilter emits victim write-backs) requests —
  it never changes what a request *means*;
* a stage charges only the cycles its hardware exposes
  (``StageStats.cycles``); overlap credits live in one place
  (:class:`DMAOverlapStage`), so the breakdown sums to the makespan;
* channels are independent after mapping, so every stage past the
  AddressMap operates per channel on ``local_addr`` (each channel owns
  an arbiter, a cache bank and a scheduler front end — the same
  partition argument as the set-parallel trace engine).

In the FPGA each PE's FLITs pass its port arbiter *before* the address
decode; in the model the AddressMap is a pure annotation (it reorders
nothing), so it runs first to hand every per-channel arbiter its queue —
the composed datapath is identical, and per-port FIFO order is preserved
into every channel queue either way.

The four legacy ``MemoryController.modeled_*`` entry points are thin
wrappers over stage subsets of this pipeline and are property-tested
bit-identical to their pre-refactor outputs
(``tests/core/test_pipeline.py``); ``autotune.tune`` scores full
pipeline results, so cache geometry × num_channels × mapping policy are
tuned jointly.

Counterpart of the reference's ``repro.core.pipeline``, copied
expression for expression; numpy on the host, like the reference's. Its
``CacheFilterStage`` runs the port's ``cache_engine.filter_trace_rw``,
whose ``engine="auto"`` is the sequential walk until ROADMAP A5.2 ports
the set-parallel engine (bit-identical by the reference's own tests).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.core import cache_engine
from repro_torch.core import channels as channels_mod
from repro_torch.core import scheduler as scheduler_mod
from repro_torch.core.config import (CacheConfig, ChannelConfig,
                                     DRAMSchedConfig, FaultConfig,
                                     MemoryControllerConfig, SchedulerConfig)
from repro_torch.core.timing import (DRAMTimings, SimResult, refuse_trace,
                                     simulate_dram_access,
                                     simulate_dram_sched,
                                     t_overlapped_schedule)

_INT64_MAX = np.iinfo(np.int64).max


# ---------------------------------------------------------------------------
# The carrier
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RequestStream:
    """Struct-of-arrays request stream — the single carrier every stage
    consumes and produces.

    ``addr`` is the flat physical byte address, ``rw`` the access type
    (0=read / 1=write), ``pe_id`` the originating port, ``seq`` the
    arrival-order stamp (the FLIT read-pointer; synthetic requests
    inherit the stamp of the request that caused them). ``channel`` /
    ``local_addr`` are AddressMap annotations; ``tags`` holds free-form
    per-request annotations (e.g. ``"writeback"`` marks the synthetic
    victim flushes the CacheFilter inserts).

    ``arrival_cycle`` is the open-loop arrival stamp in FPGA cycles:
    request i enters its port FIFO at that time and may not be granted
    or issued earlier. ``None`` (or all zeros) is the closed-loop
    degenerate case — every request pending from cycle 0 — and the
    pipeline then reproduces the pre-serving results bit-identically
    (property-tested).
    """

    addr: np.ndarray                      # (N,) int64
    rw: np.ndarray                        # (N,) int32
    pe_id: np.ndarray                     # (N,) int64
    seq: np.ndarray                       # (N,) int64
    channel: np.ndarray | None = None     # (N,) int64 — AddressMap
    local_addr: np.ndarray | None = None  # (N,) int64 — AddressMap
    arrival_cycle: np.ndarray | None = None  # (N,) float64 — FPGA cycles
    tags: dict = dataclasses.field(default_factory=dict)

    def __len__(self) -> int:
        return int(self.addr.shape[0])

    @property
    def has_arrivals(self) -> bool:
        """True when some request arrives after cycle 0 (i.e. the
        stream is genuinely open-loop, not the closed-loop degeneracy)."""
        return (self.arrival_cycle is not None
                and bool(self.arrival_cycle.any()))

    def select(self, idx: np.ndarray) -> "RequestStream":
        """Sub-stream / permutation view (fancy-indexes every array)."""
        return RequestStream(
            addr=self.addr[idx], rw=self.rw[idx], pe_id=self.pe_id[idx],
            seq=self.seq[idx],
            channel=None if self.channel is None else self.channel[idx],
            local_addr=(None if self.local_addr is None
                        else self.local_addr[idx]),
            arrival_cycle=(None if self.arrival_cycle is None
                           else self.arrival_cycle[idx]),
            tags={k: v[idx] for k, v in self.tags.items()})

    @classmethod
    def from_rows(
        cls,
        row_ids,
        rw=None,
        *,
        row_bytes: int,
        pe_id=None,
        arrival_cycle=None,
    ) -> "RequestStream":
        """The single validated ingestion point for row-granular traces
        (every ``modeled_*`` entry point and ``simulate()`` build their
        stream here — the ``row_ids * row_bytes`` / dtype-coercion
        boilerplate lives nowhere else).
        """
        if row_bytes <= 0:
            raise ValueError(f"row_bytes={row_bytes} must be positive")
        row_ids = np.asarray(row_ids)
        if row_ids.dtype.kind not in "iu":
            raise TypeError(
                f"row_ids must be an integer array, got {row_ids.dtype}")
        row_ids = row_ids.ravel()
        n = row_ids.shape[0]
        if n and int(row_ids.min()) < 0:
            raise ValueError(
                f"row_ids contain negative ids (min={int(row_ids.min())}); "
                "physical row addresses must be non-negative")
        if n and int(row_ids.max()) > _INT64_MAX // row_bytes:
            raise ValueError(
                f"row id {int(row_ids.max())} * row_bytes {row_bytes} "
                "overflows the int64 address space")
        addr = row_ids.astype(np.int64) * row_bytes
        return cls.from_addrs(addr, rw, pe_id=pe_id,
                              arrival_cycle=arrival_cycle)

    @classmethod
    def from_addrs(cls, addrs, rw=None, *, pe_id=None,
                   arrival_cycle=None) -> "RequestStream":
        """Ingest a byte-address trace (the channels-layer entry)."""
        addr = np.asarray(addrs, dtype=np.int64).ravel()
        n = addr.shape[0]
        if rw is None:
            rw_arr = np.zeros(n, np.int32)
        else:
            rw_arr = np.asarray(rw, dtype=np.int32).ravel()
            if rw_arr.shape[0] != n:
                raise ValueError("rw must have one entry per request")
            if n and not np.isin(rw_arr, (0, 1)).all():
                raise ValueError("rw entries must be 0 (read) or 1 (write)")
        if pe_id is None:
            pe = np.zeros(n, np.int64)
        else:
            pe = np.asarray(pe_id, dtype=np.int64).ravel()
            if pe.shape[0] != n:
                raise ValueError("pe_id must have one entry per request")
        arr = None
        if arrival_cycle is not None:
            arr = np.asarray(arrival_cycle, dtype=np.float64).ravel()
            if arr.shape[0] != n:
                raise ValueError(
                    "arrival_cycle must have one entry per request")
            if n and (not np.isfinite(arr).all() or arr.min() < 0):
                raise ValueError(
                    "arrival_cycle entries must be finite and >= 0")
        return cls(addr=addr, rw=rw_arr, pe_id=pe,
                   seq=np.arange(n, dtype=np.int64), arrival_cycle=arr)


# ---------------------------------------------------------------------------
# Context, stats, result
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PipelineContext:
    """Static configuration plus the stage-to-stage blackboard."""

    channels: ChannelConfig
    scheduler: SchedulerConfig | None
    cache: CacheConfig | None
    timings: DRAMTimings
    ctrl_overhead_cycles: float = 0.0
    #: DRAM command scheduler (FR-FCFS + refresh); ``None`` keeps the
    #: strict-FIFO service model of the pre-scheduler pipeline.
    dram_sched: DRAMSchedConfig | None = None
    #: RAS / fault-injection config (``None`` or an inactive config is
    #: the perfectly-reliable device — bit-identical degeneracy).
    faults: "FaultConfig | None" = None
    #: Open-loop serving mode: ``None`` auto-enables when the stream
    #: carries non-zero arrival stamps; ``True`` forces the serving
    #: datapath even for all-zero arrivals (the degeneracy harness);
    #: ``False`` forces the closed-loop pipeline, ignoring stamps.
    open_loop: bool | None = None
    # blackboard (written by stages, read by later stages / the runner):
    requests_per_channel: list[int] | None = None   # AddressMap
    sched_batches: int = 0                          # BatchScheduler
    dram_makespan: float = 0.0                      # DRAMService
    # serving-mode blackboard (PortArbiter defers to DRAMService, which
    # runs the coupled admission+service model and reports back):
    arb_ports: int | None = None                    # PortArbiter
    arb_policy: str = "round_robin"                 # PortArbiter
    arb_weights: Sequence[int] | None = None        # PortArbiter
    serving_completion: np.ndarray | None = None    # DRAMService, by seq
    serving_service: np.ndarray | None = None       # DRAMService, by seq
    serving_arrival: np.ndarray | None = None       # DRAMService, by seq
    serving_pe: np.ndarray | None = None            # DRAMService, by seq
    serving_idle: float = 0.0                       # DRAMService
    serving_port_stats: "channels_mod.ArbiterStats | None" = None
    serving_dropped: np.ndarray | None = None       # DRAMService, by seq
    fault_stats: "object | None" = None             # DRAMService
    #: opt-in per-request lifecycle recorder (the reference's
    #: ``TraceRecorder``), ROADMAP A5.3: :func:`run_pipeline` raises
    #: ``NotImplementedError`` for one that is not ``None``. The stages
    #: keep the reference's recording code for it.
    trace: "object | None" = None

    @classmethod
    def from_config(cls, config: MemoryControllerConfig,
                    timings: DRAMTimings) -> "PipelineContext":
        return cls(channels=config.channels, scheduler=config.scheduler,
                   cache=config.cache, timings=timings,
                   ctrl_overhead_cycles=float(config.ctrl_overhead_cycles),
                   dram_sched=config.dram_sched, faults=config.faults)

    @property
    def num_channels(self) -> int:
        return self.channels.num_channels

    @property
    def fault_active(self) -> bool:
        """True when the RAS layer changes anything at all this run."""
        return self.faults is not None and self.faults.active

    def address_map(self) -> channels_mod.AddressMap:
        return channels_mod.AddressMap(self.channels, self.timings,
                                       self.faults)


@dataclasses.dataclass
class StageStats:
    """One stage's contribution to the pipeline breakdown."""

    name: str
    cycles: float          # exposed cycles this stage charges
    in_requests: int
    out_requests: int
    info: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class ServingStats:
    """Per-request latency view of an open-loop run.

    All times are FPGA cycles in the *pipeline* time base: a request's
    completion includes every exposed pre-DRAM cycle (controller
    overhead, arbiter fill), so ``sojourn = completion - arrival`` is
    the full modeled residence time and ``makespan >= arrival + sojourn``
    holds for every request. ``service`` is the request's own DRAM
    issue cost (activation/CAS/precharge + burst + any turnaround it
    triggered); ``queueing = sojourn - service`` is everything it spent
    waiting — arrival gating, arbitration, reorder, refresh, and the
    shared fixed overheads.
    """

    arrival_fpga_cycles: np.ndarray      # (N,) request arrival stamps
    completion_fpga_cycles: np.ndarray   # (N,) modeled finish times
    service_fpga_cycles: np.ndarray      # (N,) own DRAM issue cost
    pe_id: np.ndarray                    # (N,) originating port
    p50_sojourn: float
    p95_sojourn: float
    p99_sojourn: float
    mean_sojourn: float
    worst_sojourn: float
    sustained_req_per_cycle: float       # N / makespan
    offered_req_per_cycle: float         # N / last arrival (0.0 for the
    #                                      closed-loop degeneracy)
    idle_fpga_cycles: float              # summed channel idle time
    per_port: dict = dataclasses.field(default_factory=dict)

    @property
    def sojourn_fpga_cycles(self) -> np.ndarray:
        return self.completion_fpga_cycles - self.arrival_fpga_cycles

    @property
    def queueing_fpga_cycles(self) -> np.ndarray:
        return self.sojourn_fpga_cycles - self.service_fpga_cycles

    @staticmethod
    def _percentiles(sojourn: np.ndarray) -> dict:
        if sojourn.size == 0:
            return dict(p50_sojourn=0.0, p95_sojourn=0.0, p99_sojourn=0.0,
                        mean_sojourn=0.0, worst_sojourn=0.0)
        return dict(
            p50_sojourn=float(np.percentile(sojourn, 50)),
            p95_sojourn=float(np.percentile(sojourn, 95)),
            p99_sojourn=float(np.percentile(sojourn, 99)),
            mean_sojourn=float(sojourn.mean()),
            worst_sojourn=float(sojourn.max()))

    @classmethod
    def from_arrays(cls, arrival, completion, service, pe_id,
                    makespan: float, idle: float,
                    open_loop: bool = True) -> "ServingStats":
        sojourn = completion - arrival
        per_port = {}
        for p in np.unique(pe_id):
            m = pe_id == p
            per_port[int(p)] = dict(
                n=int(m.sum()), **cls._percentiles(sojourn[m]))
        n = arrival.shape[0]
        last = float(arrival.max()) if n else 0.0
        # The offered-load guard keys on open-loop-ness, not on ``last``:
        # a nonempty closed-loop trace (all arrivals 0, e.g. the forced
        # open_loop=True degeneracy harness) offers no arrival process
        # at all — report 0.0, not n/0 = inf.
        return cls(
            arrival_fpga_cycles=arrival,
            completion_fpga_cycles=completion,
            service_fpga_cycles=service, pe_id=pe_id,
            sustained_req_per_cycle=n / makespan if makespan else 0.0,
            offered_req_per_cycle=(n / last if (open_loop and last)
                                   else 0.0),
            idle_fpga_cycles=idle, per_port=per_port,
            **cls._percentiles(sojourn))


@dataclasses.dataclass
class PipelineResult:
    """End-to-end result of one pipeline run.

    ``makespan_fpga_cycles`` is the full modeled completion time:
    controller overhead + every stage's exposed cycles (the breakdown in
    ``stages`` sums to it exactly). ``as_channel_result()`` /
    ``as_sim_result()`` are the *legacy views* — DRAM service +
    arbitration only, which is precisely what the pre-pipeline
    ``modeled_*`` entry points reported (and still do, bit-identically).
    """

    makespan_fpga_cycles: float
    stages: list[StageStats]
    per_channel: list[SimResult]
    requests_per_channel: list[int]
    dram_makespan_fpga_cycles: float
    arbitration_cycles: float
    n_requests: int
    cache_hit_rate: float | None = None
    port_stats: channels_mod.ArbiterStats | None = None
    #: per-request sojourn statistics — populated only by open-loop runs
    serving: ServingStats | None = None
    #: RAS observability — populated only when a fault config is active
    #: (``repro_torch.core.faults.FaultStats`` aggregated over channels)
    fault: "object | None" = None
    #: per-request dropped flags indexed by ``seq`` — open-loop runs
    #: under an active fault config only (``None`` otherwise)
    dropped: np.ndarray | None = None

    def stage(self, name: str) -> StageStats | None:
        for s in self.stages:
            if s.name == name:
                return s
        return None

    def breakdown(self) -> dict[str, float]:
        """Cycle breakdown keyed by stage name (plus ctrl overhead) —
        sums to ``makespan_fpga_cycles``."""
        out = {"ctrl_overhead": (self.makespan_fpga_cycles
                                 - sum(s.cycles for s in self.stages))}
        for s in self.stages:
            out[s.name] = s.cycles
        return out

    def as_channel_result(self) -> channels_mod.ChannelSimResult:
        return channels_mod._aggregate(
            self.per_channel, self.requests_per_channel,
            self.arbitration_cycles, port_stats=self.port_stats)

    def as_sim_result(self) -> SimResult:
        return self.as_channel_result().as_sim_result()


# ---------------------------------------------------------------------------
# Stages
# ---------------------------------------------------------------------------

def _open_loop_active(stream: RequestStream, ctx: PipelineContext) -> bool:
    """Resolve the serving-mode switch for this run (shared by the
    arbiter and DRAM-service stages so they can never disagree)."""
    if ctx.open_loop is not None:
        return bool(ctx.open_loop)
    return stream.has_arrivals


def _per_channel(stream: RequestStream, num_channels: int):
    """Stable per-channel selections (arrival order preserved within
    each channel — the invariant every stage relies on)."""
    if stream.channel is None:
        raise ValueError("stream has no channel annotation — the "
                         "AddressMap stage must run first")
    for k in range(num_channels):
        yield k, np.flatnonzero(stream.channel == k)


@dataclasses.dataclass
class AddressMapStage:
    """Pure annotation: decompose every address into (channel,
    local_addr) under the configured interleave policy. Reorders and
    drops nothing; records per-channel request counts (the occupancy
    denominator every later stage and the legacy results report)."""

    name: str = dataclasses.field(default="address_map", init=False)

    def run(self, stream: RequestStream, ctx: PipelineContext):
        amap = ctx.address_map()
        ch = amap.channel_of(stream.addr)
        local = amap.local_addr(stream.addr)
        counts = np.bincount(ch, minlength=ctx.num_channels) if len(stream) \
            else np.zeros(ctx.num_channels, np.int64)
        ctx.requests_per_channel = [int(c) for c in counts]
        out = dataclasses.replace(stream, channel=ch, local_addr=local)
        return out, StageStats(
            self.name, 0.0, len(stream), len(stream),
            {"policy": ctx.channels.policy,
             "num_channels": ctx.num_channels,
             "requests_per_channel": ctx.requests_per_channel})


@dataclasses.dataclass
class PortArbiterStage:
    """Per-channel multi-port arbitration: each channel's arbiter merges
    the per-``pe_id`` FIFO substreams destined for it (round_robin /
    priority / weighted). Charges the pipelined grant-tree fill once;
    reports aggregated per-port grants, stalls and Jain fairness."""

    num_ports: int
    policy: str = "round_robin"
    weights: Sequence[int] | None = None
    name: str = dataclasses.field(default="port_arbiter", init=False)

    def run(self, stream: RequestStream, ctx: PipelineContext):
        if _open_loop_active(stream, ctx):
            # Open loop: grant timing is coupled to service timing (a
            # port's head can only be granted once it has *arrived*, and
            # grants proceed at the DRAM's issue pace), so arbitration
            # cannot be a standalone permutation — the stage annotates
            # the context and defers the coupled admission loop to
            # DRAMService. The grant-tree fill is charged here as ever.
            channels_mod._normalize_weights(self.num_ports, self.policy,
                                            self.weights)   # validate now
            pe = stream.pe_id
            if len(stream) and (int(pe.min()) < 0
                                or int(pe.max()) >= self.num_ports):
                raise ValueError("pe_id outside [0, num_ports)")
            ctx.arb_ports = self.num_ports
            ctx.arb_policy = self.policy
            ctx.arb_weights = self.weights
            fill = float(channels_mod.arbiter_fill_cycles(self.num_ports))
            return stream, StageStats(
                self.name, fill, len(stream), len(stream),
                {"port_stats": None, "policy": self.policy,
                 "deferred_to": "dram_service"})
        order_parts = []
        grants = np.zeros(self.num_ports, np.int64)
        stalls = np.zeros(self.num_ports, np.int64)
        for _k, sel in _per_channel(stream, ctx.num_channels):
            perm, stats = channels_mod.arbitrate_ports(
                stream.pe_id[sel], num_ports=self.num_ports,
                policy=self.policy, weights=self.weights)
            order_parts.append(sel[perm])
            grants += stats.grants
            stalls += stats.stall_slots
            if ctx.trace is not None:
                seqs = stream.seq[sel][perm].tolist()
                pes = stream.pe_id[sel][perm].tolist()
                ctx.trace.stage_events.extend(
                    ("grant_slot", _k, slot, s, p)
                    for slot, (s, p) in enumerate(zip(seqs, pes)))
        order = (np.concatenate(order_parts) if order_parts
                 else np.empty(0, np.int64))
        port_stats = channels_mod.ArbiterStats(
            grants=grants, stall_slots=stalls,
            fairness=channels_mod._jain(grants))
        fill = float(channels_mod.arbiter_fill_cycles(self.num_ports))
        return stream.select(order), StageStats(
            self.name, fill, len(stream), len(stream),
            {"port_stats": port_stats, "policy": self.policy})


@dataclasses.dataclass
class CacheFilterStage:
    """Cache engine as a stream filter: hits are served at cache latency
    (one beat each) and *removed* from the downstream DRAM stream; the
    write policy is honored — write-through forwards write hits,
    write-back absorbs them and inserts victim write-backs (as WRITE
    requests, tagged ``"writeback"``) just before the evicting miss.

    The cache is banked per memory channel (each channel owns a bank
    with the full configured geometry, like each channel owns a
    scheduler front end), so filtering commutes with channel
    decomposition — property-tested. ``memo`` optionally caches the
    filtered output keyed by (cache, channels, timings): the autotuner
    shares one dict across its grid so the expensive trace scan runs
    once per cache×channel shape (callers must reuse a memo only with
    an identical input stream).
    """

    engine: str = "auto"
    memo: dict | None = None
    name: str = dataclasses.field(default="cache_filter", init=False)

    def run(self, stream: RequestStream, ctx: PipelineContext):
        if ctx.cache is None:
            raise ValueError("CacheFilterStage requires a cache config")
        key = (ctx.cache, ctx.channels, ctx.timings, ctx.faults)
        # A memo hit would skip the per-request scan the event stream
        # comes from — tracing runs bypass the memo entirely (read and
        # write) so the events are always emitted and never stale.
        memo = None if ctx.trace is not None else self.memo
        if memo is not None and key in memo:
            return memo[key]
        cache = ctx.cache
        amap = ctx.address_map()
        lb = cache.line_bytes
        parts: list[RequestStream] = []
        n_hits = 0
        n_wb = 0
        hits_per_channel: list[int] = []
        for k, sel in _per_channel(stream, ctx.num_channels):
            sub = stream.select(sel)
            res = cache_engine.filter_trace_rw(
                cache, sub.local_addr // lb, sub.rw, engine=self.engine)
            ch_hits = int(res.hits.sum())
            n_hits += ch_hits
            n_wb += res.n_writebacks
            hits_per_channel.append(ch_hits)
            if ctx.trace is not None:
                hits_l = res.hits.tolist()
                seqs = sub.seq.tolist()
                ctx.trace.stage_events.extend(
                    ("cache", k, s, "hit" if h else "miss")
                    for s, h in zip(seqs, hits_l))
            kept = sub.select(np.flatnonzero(res.keep))
            kept.tags["writeback"] = np.zeros(len(kept), bool)
            wb_src = sub.select(res.wb_pos)
            if ctx.trace is not None:
                ctx.trace.stage_events.extend(
                    ("cache_wb", k, int(s)) for s in wb_src.seq)
            wb_local = res.wb_line * lb
            wb = RequestStream(
                addr=amap.global_addr(np.full(res.n_writebacks, k,
                                              np.int64), wb_local),
                rw=np.ones(res.n_writebacks, np.int32),
                pe_id=wb_src.pe_id, seq=wb_src.seq,
                channel=np.full(res.n_writebacks, k, np.int64),
                local_addr=wb_local,
                tags={**{t: v for t, v in wb_src.tags.items()},
                      "writeback": np.ones(res.n_writebacks, bool)})
            # Merge: a write-back enters the stream immediately before
            # its evicting miss (position key ``2*pos`` vs ``2*pos+1``).
            keep_pos = np.flatnonzero(res.keep)
            merged = _concat_streams([kept, wb])
            order = np.argsort(
                np.concatenate([keep_pos * 2 + 1, res.wb_pos * 2]),
                kind="stable")
            parts.append(merged.select(order))
        out = _concat_streams(parts) if parts else stream
        n = len(stream)
        result = (out, StageStats(
            self.name, float(n_hits), n, len(out),
            {"hit_rate": n_hits / max(1, n), "n_hits": n_hits,
             "n_writebacks": n_wb, "write_policy": cache.write_policy,
             "hits_per_channel": hits_per_channel}))
        if memo is not None:
            memo[key] = result
        return result


def _concat_streams(streams: list[RequestStream]) -> RequestStream:
    tags_keys = set().union(*(s.tags.keys() for s in streams)) \
        if streams else set()
    def cat(get, dtype=None):
        arrs = [get(s) for s in streams]
        return np.concatenate(arrs) if arrs else np.empty(0, dtype)
    has_ch = all(s.channel is not None for s in streams)
    has_local = all(s.local_addr is not None for s in streams)
    # arrival is a default, not an annotation: a stream without stamps
    # is "all pending from 0", so mixing promotes the missing ones to 0
    has_arr = any(s.arrival_cycle is not None for s in streams)
    return RequestStream(
        addr=cat(lambda s: s.addr, np.int64),
        rw=cat(lambda s: s.rw, np.int32),
        pe_id=cat(lambda s: s.pe_id, np.int64),
        seq=cat(lambda s: s.seq, np.int64),
        channel=cat(lambda s: s.channel, np.int64) if has_ch else None,
        local_addr=(cat(lambda s: s.local_addr, np.int64)
                    if has_local else None),
        arrival_cycle=(cat(lambda s: (s.arrival_cycle
                                      if s.arrival_cycle is not None
                                      else np.zeros(len(s), np.float64)),
                           np.float64) if has_arr else None),
        tags={k: cat(lambda s: s.tags[k]) for k in tags_keys})


@dataclasses.dataclass
class BatchSchedulerStage:
    """Per-channel batch formation + stable row reorder (the dual-queue
    former and bitonic network of paper §IV). Emits the serviced DRAM
    command stream: FLIT identity is retired here (the reorder buffer
    unsorts responses), so downstream ``pe_id``/``seq`` are -1. Charges
    no cycles itself — the exposed (non-overlapped) scheduling cost is
    computed by :class:`DMAOverlapStage` once DRAM service is known."""

    coalesce_writes: bool = False
    name: str = dataclasses.field(default="batch_scheduler", init=False)

    def run(self, stream: RequestStream, ctx: PipelineContext):
        sch = ctx.scheduler
        if sch is None:
            raise ValueError("BatchSchedulerStage requires a scheduler "
                             "config")
        amap = ctx.address_map()
        parts: list[RequestStream] = []
        n_batches = 0
        for k, sel in _per_channel(stream, ctx.num_channels):
            served, served_rw = scheduler_mod.schedule_trace_rw(
                stream.local_addr[sel], stream.rw[sel], config=sch,
                timings=ctx.timings, coalesce_writes=self.coalesce_writes)
            n_batches += scheduler_mod.count_batches(stream.rw[sel],
                                                     config=sch)
            if ctx.trace is not None:
                seqs = stream.seq[sel].tolist()
                for bi, batch in enumerate(scheduler_mod.form_batches_typed(
                        stream.local_addr[sel], stream.rw[sel],
                        config=sch)):
                    ctx.trace.stage_events.extend(
                        ("batch", k, seqs[pos], bi)
                        for pos in batch.seq.tolist())
            m = served.shape[0]
            kf = np.full(m, k, np.int64)
            parts.append(RequestStream(
                addr=amap.global_addr(kf, served), rw=served_rw,
                pe_id=np.full(m, -1, np.int64),
                seq=np.full(m, -1, np.int64),
                channel=kf, local_addr=served))
        out = _concat_streams(parts) if parts else stream
        ctx.sched_batches = n_batches
        return out, StageStats(
            self.name, 0.0, len(stream), len(out),
            {"n_batches": n_batches, "batch_size": sch.batch_size,
             "coalesce_writes": self.coalesce_writes})


@dataclasses.dataclass
class DRAMServiceStage:
    """Channel-parallel DRAM service: each channel issues its stream
    against its own bank/row state (tWTR/tRTW turnarounds included) and
    the stage charges the *makespan* — the slowest channel — since
    channels drain concurrently.

    ``ctx.dram_sched`` selects the command scheduler each channel's
    interface runs: strict FIFO (``None`` / window 1 — the classic
    arrival-order classification, bit-identical to the pre-scheduler
    stage) or FR-FCFS with a bounded reorder window, starvation cap and
    refresh (:func:`repro_torch.core.timing.simulate_dram_sched`). This is
    the first stage whose charged cycles depend on service *order*, not
    just stream contents — the golden-trace + property harness in
    ``tests/core/test_dram_sched.py`` / ``test_golden_pipeline.py``
    locks it down."""

    name: str = dataclasses.field(default="dram_service", init=False)

    def run(self, stream: RequestStream, ctx: PipelineContext):
        if _open_loop_active(stream, ctx):
            return self._run_serving(stream, ctx)
        if ctx.fault_active:
            return self._run_closed_faults(stream, ctx)
        sched = ctx.dram_sched
        # The default config degenerates to strict FIFO — skip the
        # scheduler wrapper entirely (it would recompute turnarounds
        # and allocate an unread service_order on the hot path; the
        # results are bit-identical either way, property-tested). A
        # tracing run takes the scheduler wrapper even then: the event
        # stream needs service_order, and the wrapper's window-1
        # degeneracy is bit-identical (only the result subtype widens).
        if sched is not None and sched.effective_window == 1 \
                and not sched.t_refi and ctx.trace is None:
            sched = None
        if sched is None and ctx.trace is not None:
            sched = DRAMSchedConfig()
        per_channel: list[SimResult] = []
        n_ref = 0
        for _k, sel in _per_channel(stream, ctx.num_channels):
            if sched is None:
                per_channel.append(simulate_dram_access(
                    stream.local_addr[sel], ctx.timings,
                    rw=stream.rw[sel]))
            else:
                ct = None if ctx.trace is None else \
                    ctx.trace.channel(_k, req_ids=stream.seq[sel])
                res = simulate_dram_sched(
                    stream.local_addr[sel], ctx.timings, sched,
                    rw=stream.rw[sel], trace=ct)
                n_ref += res.n_refreshes
                per_channel.append(res)
        makespan = max((r.total_fpga_cycles for r in per_channel),
                       default=0.0)
        ctx.dram_makespan = makespan
        busy = float(sum(r.total_fpga_cycles for r in per_channel))
        info = {"per_channel": per_channel, "busy_fpga_cycles": busy,
                "occupancy_per_channel": [r.total_fpga_cycles
                                          for r in per_channel]}
        if sched is not None:
            info.update(sched_policy=sched.policy,
                        reorder_window=sched.effective_window,
                        n_refreshes=n_ref)
        return stream, StageStats(
            self.name, makespan, len(stream), len(stream), info)

    def _run_closed_faults(self, stream: RequestStream,
                           ctx: PipelineContext):
        """Closed-loop service under an *active* fault config: each
        channel runs the fault-injected engine with every request
        pending from cycle 0 (the serving model's closed-loop
        degeneracy), so ECC correction stalls, replay bus traffic,
        outage windows and degradation land in the charged makespan.
        The fault-free branch above is untouched — an inactive config
        never reaches here (bit-identical degeneracy)."""
        from repro_torch.core.timing import simulate_faults

        sched = ctx.dram_sched if ctx.dram_sched is not None \
            else DRAMSchedConfig()
        per_channel: list[SimResult] = []
        fault_agg = None
        n_ref = 0
        for k, sel in _per_channel(stream, ctx.num_channels):
            ct = None if ctx.trace is None else \
                ctx.trace.channel(k, req_ids=stream.seq[sel])
            res = simulate_faults(
                stream.local_addr[sel], ctx.timings, sched,
                rw=stream.rw[sel], faults=ctx.faults, channel=k,
                trace=ct)
            n_ref += res.n_refreshes
            fault_agg = res.fault if fault_agg is None \
                else fault_agg.combine(res.fault)
            per_channel.append(res)
        ctx.fault_stats = fault_agg
        makespan = max((r.total_fpga_cycles for r in per_channel),
                       default=0.0)
        ctx.dram_makespan = makespan
        busy = float(sum(r.total_fpga_cycles for r in per_channel))
        info = {"per_channel": per_channel, "busy_fpga_cycles": busy,
                "occupancy_per_channel": [r.total_fpga_cycles
                                          for r in per_channel],
                "sched_policy": sched.policy,
                "reorder_window": sched.effective_window,
                "n_refreshes": n_ref, "fault": fault_agg}
        return stream, StageStats(
            self.name, makespan, len(stream), len(stream), info)

    def _run_serving(self, stream: RequestStream, ctx: PipelineContext):
        """Open-loop service: each channel runs the coupled
        admission+scheduling model (:func:`repro_torch.core.timing.
        simulate_arrivals`) — per-port FIFOs gated on arrival, the
        configured arbiter granting into the reorder window at issue
        pace, idle gaps advanced (with refresh absorption). Per-request
        completion stamps are scattered back by ``seq`` so the runner
        can report sojourn percentiles against the original stream.

        With an active fault config every channel runs the RAS engine
        (:func:`repro_torch.core.timing.simulate_faults`) instead — same
        admission loop plus error injection / ECC / bounded replay /
        degradation — and the per-channel ``FaultStats`` are combined
        onto the context blackboard, dropped flags scattered by seq."""
        from repro_torch.core.timing import simulate_arrivals, simulate_faults

        n = len(stream)
        if n and int(stream.seq.min()) < 0:
            raise ValueError(
                "open-loop serving needs per-request FLIT identity; the "
                "batch scheduler retires it — run the serving pipeline "
                "without BatchSchedulerStage")
        sched = ctx.dram_sched if ctx.dram_sched is not None \
            else DRAMSchedConfig()
        arr = stream.arrival_cycle if stream.arrival_cycle is not None \
            else np.zeros(n, np.float64)
        nports = ctx.arb_ports
        size = int(stream.seq.max()) + 1 if n else 0
        if size != n:
            raise ValueError(
                "open-loop serving requires a drop-free stream (one "
                "completion per ingested request) — disable the cache "
                "filter for serving runs")
        completion = np.zeros(size, np.float64)
        service = np.zeros(size, np.float64)
        arrival = np.zeros(size, np.float64)
        pe_by_seq = np.zeros(size, np.int64)
        per_channel: list[SimResult] = []
        n_ref = 0
        idle = 0.0
        grants = stalls = None
        if nports is not None and nports > 1:
            grants = np.zeros(nports, np.int64)
            stalls = np.zeros(nports, np.int64)
        fault_on = ctx.fault_active
        fault_agg = None
        dropped = np.zeros(size, bool) if fault_on else None
        for k, sel in _per_channel(stream, ctx.num_channels):
            sub = dict(
                rw=stream.rw[sel], arrival_fpga=arr[sel],
                pe_id=(stream.pe_id[sel] if nports is not None
                       and nports > 1 else None),
                num_ports=nports, arb_policy=ctx.arb_policy,
                weights=ctx.arb_weights,
                trace=(None if ctx.trace is None else
                       ctx.trace.channel(k, req_ids=stream.seq[sel])))
            if fault_on:
                res = simulate_faults(
                    stream.local_addr[sel], ctx.timings, sched,
                    faults=ctx.faults, channel=k, **sub)
                fault_agg = res.fault if fault_agg is None \
                    else fault_agg.combine(res.fault)
                dropped[stream.seq[sel]] = res.dropped
            else:
                res = simulate_arrivals(
                    stream.local_addr[sel], ctx.timings, sched, **sub)
            n_ref += res.n_refreshes
            idle += res.idle_dram_cycles * ctx.timings.clock_ratio
            seqs = stream.seq[sel]
            completion[seqs] = res.completion_fpga_cycles
            service[seqs] = (res.service_dram_cycles
                             * ctx.timings.clock_ratio)
            arrival[seqs] = arr[sel]
            pe_by_seq[seqs] = stream.pe_id[sel]
            if grants is not None:
                st = channels_mod.ArbiterStats.from_grant_order(
                    res.granted_port, nports)
                grants += st.grants
                stalls += st.stall_slots
            per_channel.append(res)
        makespan = max((r.total_fpga_cycles for r in per_channel),
                       default=0.0)
        ctx.dram_makespan = makespan
        ctx.serving_completion = completion
        ctx.serving_service = service
        ctx.serving_arrival = arrival
        ctx.serving_pe = pe_by_seq
        ctx.serving_idle = idle
        ctx.serving_dropped = dropped
        ctx.fault_stats = fault_agg
        if grants is not None:
            ctx.serving_port_stats = channels_mod.ArbiterStats(
                grants=grants, stall_slots=stalls,
                fairness=channels_mod._jain(grants))
        busy = float(sum(r.total_fpga_cycles for r in per_channel))
        info = {"per_channel": per_channel, "busy_fpga_cycles": busy,
                "occupancy_per_channel": [r.total_fpga_cycles
                                          for r in per_channel],
                "open_loop": True, "idle_fpga_cycles": idle,
                "sched_policy": sched.policy,
                "reorder_window": sched.effective_window,
                "n_refreshes": n_ref}
        if fault_on:
            info["fault"] = fault_agg
        return stream, StageStats(
            self.name, makespan, len(stream), len(stream), info)


@dataclasses.dataclass
class DMAOverlapStage:
    """Overlap credit: the DMA engine's double-buffered streaming lets
    batch k+1 form and sort while batch k streams from DRAM, so only
    the first batch's scheduling latency — plus any per-batch residual
    the DRAM service is too short to hide — is exposed
    (:func:`repro_torch.core.timing.t_overlapped_schedule`). With the
    scheduler disabled (or an empty trace) it charges nothing."""

    name: str = dataclasses.field(default="dma_overlap", init=False)

    def run(self, stream: RequestStream, ctx: PipelineContext):
        sch = ctx.scheduler
        if sch is None or not sch.enabled or ctx.sched_batches == 0:
            exposed = 0.0
        else:
            exposed = t_overlapped_schedule(
                sch.batch_size, ctx.sched_batches, ctx.dram_makespan,
                sch.data_cond_cycles)
        return stream, StageStats(
            self.name, exposed, len(stream), len(stream),
            {"n_batches": ctx.sched_batches,
             "hidden_behind_dram": ctx.dram_makespan})


# ---------------------------------------------------------------------------
# Composition + runner
# ---------------------------------------------------------------------------

def default_stages(
    ctx: PipelineContext,
    *,
    ports: int | None = None,
    arbiter_policy: str = "round_robin",
    weights: Sequence[int] | None = None,
    cache: bool = True,
    coalesce_writes: bool = False,
    cache_memo: dict | None = None,
) -> list:
    """The full-controller stage list for ``ctx`` (disabled engines are
    omitted; the legacy ``modeled_*`` wrappers pass subsets of the same
    flags, so every modeled number in the repo is produced here)."""
    stages: list = [AddressMapStage()]
    if ports is not None:
        stages.append(PortArbiterStage(num_ports=ports,
                                       policy=arbiter_policy,
                                       weights=weights))
    if cache and ctx.cache is not None and ctx.cache.enabled:
        stages.append(CacheFilterStage(memo=cache_memo))
    if ctx.scheduler is not None and ctx.scheduler.enabled:
        stages.append(BatchSchedulerStage(coalesce_writes=coalesce_writes))
    stages.append(DRAMServiceStage())
    stages.append(DMAOverlapStage())
    return stages


def run_pipeline(stream: RequestStream, ctx: PipelineContext,
                 stages: Sequence) -> PipelineResult:
    """Push ``stream`` through ``stages`` and assemble the result."""
    refuse_trace(ctx.trace)
    n_in = len(stream)
    open_loop_in = stream.has_arrivals
    stats_list: list[StageStats] = []
    for stage in stages:
        stream, stats = stage.run(stream, ctx)
        stats_list.append(stats)
    total = ctx.ctrl_overhead_cycles + sum(s.cycles for s in stats_list)

    def _info(name, key, default=None):
        for s in stats_list:
            if s.name == name:
                return s.info.get(key, default)
        return default

    per_channel = _info("dram_service", "per_channel", [])
    arb = 0.0
    port_stats = None
    for s in stats_list:
        if s.name == "port_arbiter":
            arb = s.cycles
            port_stats = s.info["port_stats"]
    if ctx.serving_port_stats is not None:
        port_stats = ctx.serving_port_stats
    serving = None
    if ctx.serving_completion is not None:
        # Pre-DRAM exposed cycles (ctrl overhead + arbiter fill) shift
        # every completion uniformly; makespan == max completion exactly.
        pre = total - ctx.dram_makespan
        serving = ServingStats.from_arrays(
            ctx.serving_arrival, ctx.serving_completion + pre,
            ctx.serving_service, ctx.serving_pe,
            makespan=total, idle=ctx.serving_idle,
            open_loop=open_loop_in)
    if ctx.trace is not None:
        ctx.trace.finalize(ctx, total)
    return PipelineResult(
        makespan_fpga_cycles=total,
        stages=stats_list,
        per_channel=per_channel,
        requests_per_channel=(ctx.requests_per_channel
                              or [0] * ctx.num_channels),
        dram_makespan_fpga_cycles=ctx.dram_makespan,
        arbitration_cycles=arb,
        n_requests=n_in,
        cache_hit_rate=_info("cache_filter", "hit_rate"),
        port_stats=port_stats,
        serving=serving,
        fault=ctx.fault_stats,
        dropped=ctx.serving_dropped)
