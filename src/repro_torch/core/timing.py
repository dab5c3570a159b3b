"""DRAM/HBM timing model and cycle-level simulator (paper §IV).

Counterpart of the reference's ``repro.core.timing``, copied expression
for expression (the pinned goldens compare its float64 cycle sums with
``==``). Two roles:

1. *Analytic model* — Equations 1-3 of the paper, used by the autotuner to
   predict controller performance for a candidate configuration, and by the
   benchmarks to reproduce Fig. 9.

2. *Cycle-level open-row DRAM simulator* — the measurement substrate for the
   paper-claim reproductions (Fig. 7: 27% GCN / 58% CNN, Fig. 8: 20x, Fig. 9:
   batch 32-64 optimum): modeled access time — the same metric the paper
   plots — is produced by simulating each request stream against DDR4
   bank/row state. It is numpy on the host, like the reference's; it
   touches no device tensor.

Per-request lifecycle tracing (``trace=``, the reference's
``repro.core.telemetry``) is ROADMAP A5.3: until then a ``trace`` that is
not ``None`` raises ``NotImplementedError``.

All times are reported in FPGA/accelerator clock cycles unless noted.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.config import (DRAMSchedConfig, FaultConfig,
                                     MemoryControllerConfig,
                                     scheduler_sort_stages)


@dataclasses.dataclass(frozen=True)
class DRAMTimings:
    """DDR4-2400-class timing parameters (in DRAM clock cycles)."""

    t_cl: int = 17    # CAS latency
    t_rcd: int = 17   # row address to column address delay
    t_rp: int = 17    # row precharge
    # Clock periods (ns): DDR4-2400 command clock 1200 MHz; FPGA fabric
    # 300 MHz (typical U250 memory-controller clock domain).
    t_mem_ns: float = 0.833
    t_fpga_ns: float = 3.333
    num_banks: int = 16
    row_bytes: int = 8192           # row buffer (page) size
    burst_bytes: int = 64           # one BL8 x 64b burst
    t_burst: int = 4                # cycles to stream one burst after CAS
    # Bus-turnaround penalties (DDR4 tWTR/tRTW class): cycles lost when the
    # data bus flips direction between a write and a read burst.
    t_wtr: int = 8                  # write -> read turnaround
    t_rtw: int = 4                  # read -> write turnaround

    # --- paper's derived averages (§IV, 'DRAM Timing Model') -------------
    @property
    def clock_ratio(self) -> float:
        return self.t_mem_ns / self.t_fpga_ns

    def t_mem_seq(self) -> float:
        """Average sequential-access latency in FPGA cycles (row-buffer hit)."""
        return self.t_cl * self.clock_ratio

    def t_mem_rand(self) -> float:
        """Average random-access latency in FPGA cycles (row conflict)."""
        return (self.t_rp + self.t_cl + self.t_rcd) * self.clock_ratio

    def row_of(self, addr):
        return addr // self.row_bytes

    def bank_of(self, addr):
        # Bank interleave on row index (closed-form, matches common DDR4
        # address mappings at this granularity).
        return (addr // self.row_bytes) % self.num_banks


DDR4_2400 = DRAMTimings()

# The reference's TPU v5e HBM preset, carried as data: much wider rows and
# higher relative conflict penalty against a 940 MHz core clock, with the
# smaller HBM bus-turnaround gaps.
HBM_V5E = DRAMTimings(
    t_cl=14, t_rcd=14, t_rp=14,
    t_mem_ns=0.55, t_fpga_ns=1.064,
    num_banks=32, row_bytes=16384, burst_bytes=512, t_burst=1,
    t_wtr=4, t_rtw=2,
)


def t_schedule(batch_size: int, data_cond_cycles: int = 2) -> float:
    """Eq. 1 — scheduling time for a batch of N requests (FPGA cycles).

    N cycles of batch formation (one request accepted per cycle) plus the
    bitonic network's log2(N)(log2(N)+1)/2 compare-exchange stages plus
    serial<->parallel data conditioning.
    """
    if batch_size <= 0:
        return 0.0
    return batch_size + scheduler_sort_stages(batch_size) + data_cond_cycles


def t_overlapped_schedule(
    batch_size: int,
    n_batches: int,
    service_cycles: float,
    data_cond_cycles: int = 2,
) -> float:
    """Eq. 1 extended with the DMA engine's double-buffer overlap.

    Only the first batch's scheduling latency is fully exposed: while a
    batch streams from DRAM the next one forms and sorts in the second
    input buffer, so each subsequent batch exposes only the residual
    ``max(0, t_schedule - service/n_batches)``.
    """
    if n_batches <= 0:
        return 0.0
    t_sch = t_schedule(batch_size, data_cond_cycles)
    resid = max(0.0, t_sch - service_cycles / n_batches) * (n_batches - 1)
    return t_sch + resid


def t_cache_trace(
    cfg: MemoryControllerConfig,
    hits: np.ndarray,
    t_mem_access: float,
    l_cache: int = 4,
    l_mem: int = 3,
) -> float:
    """Eq. 2 — total cache-engine time for a trace with known hit mask.

    ``hits`` is a boolean vector (1 = cache hit). Hits cost one pipeline
    beat; misses pay the memory pipeline + scheduling + DRAM access.
    ``l_cache`` is the 4-stage PE pipeline depth, ``l_mem`` the 3-stage MEM
    pipeline fill latency.
    """
    hits = np.asarray(hits, dtype=bool)
    n_miss = int((~hits).sum())
    n_hit = int(hits.sum())
    t_sch = t_schedule(cfg.scheduler.batch_size,
                       cfg.scheduler.data_cond_cycles) if \
        cfg.scheduler.enabled else 0.0
    return (cfg.ctrl_overhead_cycles + l_cache
            + n_hit * 1.0
            + n_miss * (l_mem + t_sch + t_mem_access))


def t_dma_transfer(
    cfg: MemoryControllerConfig,
    num_elems: int,
    seq_mask: np.ndarray,
    timings: DRAMTimings = DDR4_2400,
    l_data_convert: int = 2,
    channel_ids: np.ndarray | None = None,
) -> float:
    """Eq. 3 — total DMA time for a bulk transfer of N elements.

    ``seq_mask[i]`` is True when element i is a sequential DRAM access
    (row-buffer hit) and False when random (row conflict); the paper requires
    exactly one of the two per element.

    ``channel_ids`` (one memory-channel index per element, from
    ``channels.AddressMap.channel_of``) extends Eq. 3 to a multi-channel
    interface: each channel streams its share of the elements
    concurrently, so the element term is the *slowest channel's* sum
    (makespan) rather than the single-interface total. ``None`` keeps
    the paper's single-channel equation exactly.
    """
    seq_mask = np.asarray(seq_mask, dtype=bool)
    if seq_mask.shape != (num_elems,):
        raise ValueError("seq_mask must have one entry per element")
    t_sch = t_schedule(cfg.scheduler.batch_size,
                       cfg.scheduler.data_cond_cycles) if \
        cfg.scheduler.enabled else 0.0
    if channel_ids is None:
        t_elems = (seq_mask.sum() * timings.t_mem_seq()
                   + (~seq_mask).sum() * timings.t_mem_rand())
    else:
        ch = np.asarray(channel_ids, dtype=np.int64)
        if ch.shape != (num_elems,):
            raise ValueError("channel_ids must have one entry per element")
        per_elem = np.where(seq_mask, timings.t_mem_seq(),
                            timings.t_mem_rand())
        sums = np.bincount(ch, weights=per_elem)
        t_elems = float(sums.max()) if sums.size else 0.0
    # Parallel DMA buffers overlap element streaming within a channel
    # (paper Fig. 5 discussion); memory channels overlap across channels.
    t_elems /= max(1, cfg.dma.num_parallel_dma)
    return cfg.ctrl_overhead_cycles + t_sch + l_data_convert + t_elems


def refuse_trace(trace) -> None:
    """Raise for a lifecycle ``trace`` recorder: the reference's
    ``repro.core.telemetry`` is not ported yet (ROADMAP A5.3). Every entry
    point that takes ``trace=`` calls this first."""
    if trace is not None:
        raise NotImplementedError(
            "trace= (per-request lifecycle tracing) is not ported yet "
            "(ROADMAP A5.3); pass trace=None")


# ---------------------------------------------------------------------------
# Cycle-level open-row simulator
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SimResult:
    total_fpga_cycles: float
    row_hits: int
    row_conflicts: int
    first_accesses: int

    @property
    def hit_rate(self) -> float:
        n = self.row_hits + self.row_conflicts + self.first_accesses
        return self.row_hits / max(1, n)


def simulate_dram_access(
    addrs: np.ndarray,
    timings: DRAMTimings = DDR4_2400,
    burst_bytes: int | None = None,
    rw: np.ndarray | None = None,
) -> SimResult:
    """Simulate an address trace against per-bank open-row state.

    Open-row policy (paper §IV): the first access to a bank costs
    ``t_rcd + t_cl``; subsequent accesses to the *same open row* cost
    ``t_cl`` (plus burst streaming); a different row costs
    ``t_rp + t_rcd + t_cl``. Returns totals in FPGA cycles.

    When ``rw`` (0=read / 1=write per request) is given, every data-bus
    direction change additionally pays the ``t_wtr`` / ``t_rtw``
    turnaround — the cost the scheduler's single-type batches amortize.

    Vectorized: classify each access by comparing with the previous access
    to the same bank (np-based; traces run to millions of requests).
    """
    addrs = np.asarray(addrs, dtype=np.int64).ravel()
    if addrs.size == 0:
        return SimResult(0.0, 0, 0, 0)
    rows = timings.row_of(addrs)
    banks = timings.bank_of(addrs)

    # prev_row_same_bank[i] = row of the previous access that hit bank[i]
    order = np.arange(addrs.size)
    # Stable sort by bank, then position, groups each bank's accesses while
    # preserving trace order within the bank.
    perm = np.lexsort((order, banks))
    sorted_rows = rows[perm]
    sorted_banks = banks[perm]
    prev_rows = np.empty_like(sorted_rows)
    prev_rows[0] = -1
    prev_rows[1:] = sorted_rows[:-1]
    same_bank = np.empty_like(sorted_banks, dtype=bool)
    same_bank[0] = False
    same_bank[1:] = sorted_banks[1:] == sorted_banks[:-1]

    first = ~same_bank
    hit = same_bank & (prev_rows == sorted_rows)
    conflict = same_bank & ~hit

    n_first = int(first.sum())
    n_hit = int(hit.sum())
    n_conflict = int(conflict.sum())

    dram_cycles = (
        n_first * (timings.t_rcd + timings.t_cl)
        + n_hit * timings.t_cl
        + n_conflict * (timings.t_rp + timings.t_rcd + timings.t_cl)
        + addrs.size * timings.t_burst
    )
    if rw is not None:
        dram_cycles += turnaround_cycles(rw, timings)
    return SimResult(
        total_fpga_cycles=dram_cycles * timings.clock_ratio,
        row_hits=n_hit,
        row_conflicts=n_conflict,
        first_accesses=n_first,
    )


def turnaround_cycles(rw: np.ndarray, timings: DRAMTimings = DDR4_2400) -> int:
    """DRAM cycles lost to bus direction changes in a serviced rw stream:
    each WRITE→READ edge costs ``t_wtr``, each READ→WRITE edge ``t_rtw``."""
    rw = np.asarray(rw, dtype=np.int32).ravel()
    if rw.size < 2:
        return 0
    prev, cur = rw[:-1], rw[1:]
    wtr = int(((prev == 1) & (cur == 0)).sum())
    rtw = int(((prev == 0) & (cur == 1)).sum())
    return wtr * timings.t_wtr + rtw * timings.t_rtw


def simulate_dram_access_windowed_seq(
    addrs: np.ndarray,
    timings: DRAMTimings = DDR4_2400,
    window: int = 4,
) -> SimResult:
    """Reference implementation of :func:`simulate_dram_access_windowed`
    — one python iteration (with an O(window) scan) per serviced request.
    Kept as the oracle the vectorized version is property-tested
    against."""
    addrs = np.asarray(addrs, dtype=np.int64).ravel()
    n = addrs.size
    if n == 0:
        return SimResult(0.0, 0, 0, 0)
    rows = timings.row_of(addrs)
    banks = timings.bank_of(addrs)
    open_row = {}
    pending: list[int] = []
    nxt = 0
    n_hit = n_conflict = n_first = 0
    while nxt < n or pending:
        while nxt < n and len(pending) < window:
            pending.append(nxt)
            nxt += 1
        pick = None
        for i, idx in enumerate(pending):        # oldest-first greedy
            b = banks[idx]
            if b in open_row and open_row[b] == rows[idx]:
                pick = i
                break
        if pick is None:
            pick = 0
        idx = pending.pop(pick)
        b, r = banks[idx], rows[idx]
        if b not in open_row:
            n_first += 1
        elif open_row[b] == r:
            n_hit += 1
        else:
            n_conflict += 1
        open_row[b] = r
    dram_cycles = (
        n_first * (timings.t_rcd + timings.t_cl)
        + n_hit * timings.t_cl
        + n_conflict * (timings.t_rp + timings.t_rcd + timings.t_cl)
        + n * timings.t_burst)
    return SimResult(total_fpga_cycles=dram_cycles * timings.clock_ratio,
                     row_hits=n_hit, row_conflicts=n_conflict,
                     first_accesses=n_first)


def simulate_dram_access_windowed(
    addrs: np.ndarray,
    timings: DRAMTimings = DDR4_2400,
    window: int = 4,
) -> SimResult:
    """Commercial-IP baseline: FIFO with a small greedy reorder window.

    Real memory-interface IPs (e.g. Xilinx MIG) service mostly in order
    but can promote a request within a shallow lookahead window when it
    hits an already-open row. ``window=1`` degenerates to pure FIFO. The
    paper's controller differs by reordering over a *whole batch* (up to
    512) with the bitonic network — this function is what it is compared
    against in the Fig. 7/8 reproductions.

    Vectorized, with counts identical to the sequential walk
    (:func:`simulate_dram_access_windowed_seq`):

    * ``window == 1`` is pure FIFO, which is exactly the per-bank
      previous-row classification :func:`simulate_dram_access` computes
      in one vectorized pass.
    * ``window > 1`` exploits that open-row state only changes when a
      *miss* is serviced: every request that hits a currently open row is
      drained from the window first (in any order — the counts are the
      same), so the walk alternates between a numpy chunk-scan that
      serves hit-runs at array speed while collecting up to ``window``
      deferred misses, and a single miss service (the oldest deferred
      request) that re-opens one bank's row and re-checks the deferred
      set against it.
    """
    addrs = np.asarray(addrs, dtype=np.int64).ravel()
    n = addrs.size
    if n == 0:
        return SimResult(0.0, 0, 0, 0)
    if window <= 1:
        return simulate_dram_access(addrs, timings)
    rows = timings.row_of(addrs)
    banks = timings.bank_of(addrs)
    open_arr = np.zeros(timings.num_banks, np.int64)
    opened = np.zeros(timings.num_banks, bool)   # no sentinel: negative
    deferred: list[int] = []                     # rows are legal values
    f = 0
    n_hit = n_conflict = n_first = 0
    while True:
        # Scan forward, serving hits and deferring misses, until the
        # window is full of misses (or the trace is exhausted).
        while f < n and len(deferred) < window:
            room = window - len(deferred)
            chunk = min(max(64, 4 * window), n - f)
            sl = slice(f, f + chunk)
            hit_mask = opened[banks[sl]] & (open_arr[banks[sl]] == rows[sl])
            miss_pos = np.flatnonzero(~hit_mask)
            if miss_pos.size >= room:
                take = miss_pos[room - 1] + 1   # through the room-th miss
                n_hit += int(take - room)
                deferred.extend((f + miss_pos[:room]).tolist())
                f += int(take)
            else:
                n_hit += int(hit_mask.sum())
                deferred.extend((f + miss_pos).tolist())
                f += chunk
        if not deferred:
            break
        # Service the oldest deferred miss; its bank's new open row may
        # turn other deferred requests into hits — drain them.
        d = deferred.pop(0)
        b, r = banks[d], rows[d]
        if not opened[b]:
            n_first += 1
        elif open_arr[b] == r:                  # unreachable: d missed
            n_hit += 1
        else:
            n_conflict += 1
        open_arr[b] = r
        opened[b] = True
        now_hit = [i for i in deferred if banks[i] == b and rows[i] == r]
        if now_hit:
            n_hit += len(now_hit)
            deferred = [i for i in deferred if not (banks[i] == b
                                                    and rows[i] == r)]
    dram_cycles = (
        n_first * (timings.t_rcd + timings.t_cl)
        + n_hit * timings.t_cl
        + n_conflict * (timings.t_rp + timings.t_rcd + timings.t_cl)
        + n * timings.t_burst)
    return SimResult(total_fpga_cycles=dram_cycles * timings.clock_ratio,
                     row_hits=n_hit, row_conflicts=n_conflict,
                     first_accesses=n_first)


# ---------------------------------------------------------------------------
# Out-of-order DRAM command scheduling (FR-FCFS + refresh)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SchedSimResult(SimResult):
    """:class:`SimResult` extended with command-scheduler observability.

    ``service_order`` is the permutation actually issued (request index
    per service slot) — the first modeled quantity in this repo where
    the makespan depends on *order*, not just stream contents; the
    property tests compute per-request slip from it. Turnaround and
    refresh cycles are broken out (DRAM command clocks) so tests can
    check the open-row class costs independently of the bus-direction
    and refresh terms.
    """

    n_refreshes: int = 0
    refresh_dram_cycles: int = 0
    turnaround_dram_cycles: int = 0
    service_order: np.ndarray = dataclasses.field(
        default_factory=lambda: np.empty(0, np.int64))


def _sched_result(n_first, n_hit, n_conflict, n, turn, n_ref, t_rfc,
                  timings, order) -> SchedSimResult:
    dram_cycles = (
        n_first * (timings.t_rcd + timings.t_cl)
        + n_hit * timings.t_cl
        + n_conflict * (timings.t_rp + timings.t_rcd + timings.t_cl)
        + n * timings.t_burst + turn + n_ref * t_rfc)
    return SchedSimResult(
        total_fpga_cycles=dram_cycles * timings.clock_ratio,
        row_hits=n_hit, row_conflicts=n_conflict, first_accesses=n_first,
        n_refreshes=n_ref, refresh_dram_cycles=n_ref * t_rfc,
        turnaround_dram_cycles=turn,
        service_order=np.asarray(order, dtype=np.int64))


def simulate_dram_sched_seq(
    addrs: np.ndarray,
    timings: DRAMTimings = DDR4_2400,
    sched: DRAMSchedConfig = DRAMSchedConfig(),
    rw: np.ndarray | None = None,
    trace=None,
) -> SchedSimResult:
    """Request-at-a-time oracle for the out-of-order DRAM command
    scheduler — THE specification the vectorized path
    (:func:`simulate_dram_sched`) is property-tested bit-identical
    against.

    One service slot per iteration over a ``reorder_window``-deep
    pending queue:

    * fill the queue from the trace (arrival order);
    * refresh: whenever the accumulated service time crosses the next
      ``t_refi`` boundary the channel stalls ``t_rfc`` cycles and every
      bank precharges (open rows close — the re-activation after a
      refresh is charged like a first access: ``t_rcd + t_cl``, no
      precharge needed);
    * pick: ``fifo`` (or window 1) always issues the oldest;
      ``frfcfs`` issues the oldest pending request whose row is already
      open, else the oldest overall; ``frfcfs_cap`` first checks for a
      starved request (``bypass >= starvation_cap`` where ``bypass``
      counts younger requests issued past it while it waited) and
      forces the oldest such one;
    * service: classify against per-bank open-row state, charge the
      class cost + burst (+ tWTR/tRTW against the *issued* direction
      sequence, which the reorder can change).

    With ``window=1`` and refresh disabled this degenerates exactly to
    the per-bank FIFO classification of :func:`simulate_dram_access`
    (bit-identical, including turnarounds).

    ``trace`` (the reference's ``ChannelTrace``) makes the reference's
    oracle emit the per-request lifecycle event stream natively; the
    emitting code is kept for ROADMAP A5.3, and until then a ``trace``
    that is not ``None`` raises ``NotImplementedError``.
    """
    refuse_trace(trace)
    addrs = np.asarray(addrs, dtype=np.int64).ravel()
    n = addrs.size
    if n == 0:
        return _sched_result(0, 0, 0, 0, 0, 0, sched.t_rfc, timings, [])
    rows = timings.row_of(addrs)
    banks = timings.bank_of(addrs)
    rw_arr = None if rw is None else np.asarray(rw, np.int32).ravel()
    w = sched.effective_window
    use_cap = sched.policy == "frfcfs_cap"
    t_refi = sched.t_refi

    open_row: dict[int, int] = {}
    pending: list[int] = []
    bypass: dict[int, int] = {}
    nxt = 0
    cycle = 0                       # DRAM clocks serviced so far
    next_ref = t_refi
    n_hit = n_conflict = n_first = n_ref = turn = 0
    last_dir = -1
    order: list[int] = []
    ev = None if trace is None else trace.events
    while nxt < n or pending:
        while nxt < n and len(pending) < w:
            if ev is not None:
                ev.append(("window", cycle, nxt))
            pending.append(nxt)
            bypass[nxt] = 0
            nxt += 1
        if t_refi:
            while cycle >= next_ref:
                if ev is not None:
                    ev.append(("refresh", cycle, cycle + sched.t_rfc))
                cycle += sched.t_rfc
                n_ref += 1
                open_row.clear()
                next_ref += t_refi
        pick = 0
        if w > 1:
            forced = None
            if use_cap:
                for i, j in enumerate(pending):
                    if bypass[j] >= sched.starvation_cap:
                        forced = i
                        break
            if forced is not None:
                pick = forced
            else:
                for i, j in enumerate(pending):
                    b = int(banks[j])
                    if b in open_row and open_row[b] == rows[j]:
                        pick = i
                        break
        idx = pending.pop(pick)
        del bypass[idx]
        b, r = int(banks[idx]), int(rows[idx])
        if b not in open_row:
            n_first += 1
            cls = "first"
            cost = timings.t_rcd + timings.t_cl
        elif open_row[b] == r:
            n_hit += 1
            cls = "hit"
            cost = timings.t_cl
        else:
            n_conflict += 1
            cls = "conflict"
            cost = timings.t_rp + timings.t_rcd + timings.t_cl
        open_row[b] = r
        cost += timings.t_burst
        if rw_arr is not None:
            d = int(rw_arr[idx])
            if last_dir == 1 and d == 0:
                turn += timings.t_wtr
                cost += timings.t_wtr
                if ev is not None:
                    ev.append(("turn", cycle, "wtr", timings.t_wtr))
            elif last_dir == 0 and d == 1:
                turn += timings.t_rtw
                cost += timings.t_rtw
                if ev is not None:
                    ev.append(("turn", cycle, "rtw", timings.t_rtw))
            last_dir = d
        if ev is not None:
            ev.append(("issue", cycle, idx, b, r, cls, cost, 1, "ok"))
        cycle += cost
        for j in pending:
            if j < idx:
                bypass[j] += 1
        order.append(idx)
        if ev is not None:
            ev.append(("complete", cycle, idx))
    return _sched_result(n_first, n_hit, n_conflict, n, turn, n_ref,
                         sched.t_rfc, timings, order)


def simulate_dram_sched(
    addrs: np.ndarray,
    timings: DRAMTimings = DDR4_2400,
    sched: DRAMSchedConfig = DRAMSchedConfig(),
    rw: np.ndarray | None = None,
    engine: str = "auto",
    trace=None,
) -> SchedSimResult:
    """Out-of-order DRAM command scheduling — vectorized, bit-identical
    to :func:`simulate_dram_sched_seq`.

    Dispatch: ``fifo``/window-1 configs without refresh are exactly the
    one-pass per-bank classification of :func:`simulate_dram_access`
    (today's FIFO model — the degeneracy the golden tests pin down);
    everything else runs the chunked event walk in
    ``repro_torch.core.trace_engine`` (hit runs at array speed, one python
    event per serviced miss / refresh / forced starvation pick).

    ``trace`` (the lifecycle event stream) is ROADMAP A5.3: one that is
    not ``None`` raises ``NotImplementedError``.
    """
    if engine not in ("auto", "fast", "sequential"):
        raise ValueError(f"engine={engine!r} must be auto|fast|sequential")
    refuse_trace(trace)
    if engine == "sequential":
        return simulate_dram_sched_seq(addrs, timings, sched, rw, trace)
    addrs = np.asarray(addrs, dtype=np.int64).ravel()
    n = addrs.size
    if n == 0:
        return _sched_result(0, 0, 0, 0, 0, 0, sched.t_rfc, timings, [])
    if sched.effective_window == 1 and not sched.t_refi:
        base = simulate_dram_access(addrs, timings, rw=rw)
        turn = 0 if rw is None else turnaround_cycles(rw, timings)
        res = SchedSimResult(
            total_fpga_cycles=base.total_fpga_cycles,
            row_hits=base.row_hits, row_conflicts=base.row_conflicts,
            first_accesses=base.first_accesses,
            turnaround_dram_cycles=turn,
            service_order=np.arange(n, dtype=np.int64))
        return res
    from repro_torch.core import trace_engine
    return trace_engine.simulate_dram_sched_fast(addrs, timings, sched, rw,
                                                 trace=trace)


# ---------------------------------------------------------------------------
# Open-loop (arrival-aware) serving simulator
# ---------------------------------------------------------------------------

#: Arbitration policies the serving loop understands — semantically the
#: same set as ``repro_torch.core.channels.ARBITER_POLICIES`` (this module
#: cannot import channels, which imports it).
SERVING_ARB_POLICIES = ("round_robin", "priority", "weighted")


def _serving_weights(num_ports: int, policy: str, weights) -> list[int]:
    """Validate (policy, weights) exactly like the channels-layer
    arbiter does and return one integer credit per port."""
    if policy not in SERVING_ARB_POLICIES:
        raise ValueError(f"arbiter policy {policy!r} must be one of "
                         f"{SERVING_ARB_POLICIES}")
    if policy != "weighted":
        return [1] * num_ports
    if weights is None:
        raise ValueError("policy='weighted' requires per-port weights")
    w = np.asarray(weights, dtype=np.int64)
    if w.shape != (num_ports,) or (w < 1).any():
        raise ValueError("weights must be one positive integer per port")
    return [int(x) for x in w]


@dataclasses.dataclass
class ServingSimResult(SchedSimResult):
    """:class:`SchedSimResult` extended with open-loop observability.

    ``total_fpga_cycles`` becomes the channel *span* — the completion
    time of the last request including any idle gaps spent waiting for
    arrivals (with all arrivals at 0 there are no gaps and the closed-
    loop count identity holds exactly). ``completion_fpga_cycles[i]``
    is request ``i``'s service-completion time on the channel clock
    (sojourn = completion − arrival); ``service_dram_cycles[i]`` the
    DRAM-command clocks its issue occupied the interface (class cost +
    burst + any turnaround it triggered; refresh stalls excluded).
    ``grant_order`` is the admission permutation (request index per
    grant slot), ``granted_port`` the port that won each slot, and
    ``idle_dram_cycles`` the clocks the interface sat with an empty
    pending window (including the tail of a refresh it had to wait out
    after an idle gap).
    """

    completion_fpga_cycles: np.ndarray = dataclasses.field(
        default_factory=lambda: np.empty(0, np.float64))
    service_dram_cycles: np.ndarray = dataclasses.field(
        default_factory=lambda: np.empty(0, np.int64))
    grant_order: np.ndarray = dataclasses.field(
        default_factory=lambda: np.empty(0, np.int64))
    granted_port: np.ndarray = dataclasses.field(
        default_factory=lambda: np.empty(0, np.int64))
    idle_dram_cycles: float = 0.0


def _serving_trace(addrs, timings, rw, arrival_fpga, pe_id, num_ports):
    """Shared input validation/decode for both serving implementations —
    the FPGA-cycle → DRAM-clock conversion in particular must be the
    *same float expression* on both paths (bit-identity)."""
    addrs = np.asarray(addrs, dtype=np.int64).ravel()
    n = addrs.size
    rw_arr = None if rw is None else np.asarray(rw, np.int32).ravel()
    if arrival_fpga is None:
        arr = np.zeros(n, np.float64)
    else:
        arr = np.asarray(arrival_fpga, np.float64).ravel()
        if arr.shape[0] != n:
            raise ValueError("arrival_fpga must have one entry per request")
        if n and (not np.isfinite(arr).all() or arr.min() < 0):
            raise ValueError("arrival_fpga must be finite and non-negative")
    arr = arr / timings.clock_ratio          # FPGA cycles -> DRAM clocks
    if pe_id is None or num_ports is None or num_ports <= 1:
        ports, nports = np.zeros(n, np.int64), 1
    else:
        ports = np.asarray(pe_id, np.int64).ravel()
        nports = int(num_ports)
        if ports.shape[0] != n:
            raise ValueError("pe_id must have one entry per request")
        if n and (ports.min() < 0 or ports.max() >= nports):
            raise ValueError("pe_id outside [0, num_ports)")
    return addrs, n, rw_arr, arr, ports, nports


def simulate_arrivals_seq(
    addrs: np.ndarray,
    timings: DRAMTimings = DDR4_2400,
    sched: DRAMSchedConfig = DRAMSchedConfig(),
    rw: np.ndarray | None = None,
    *,
    arrival_fpga: np.ndarray | None = None,
    pe_id: np.ndarray | None = None,
    num_ports: int | None = None,
    arb_policy: str = "round_robin",
    weights=None,
    trace=None,
) -> ServingSimResult:
    """Request-at-a-time oracle for the *open-loop* channel — THE
    specification for arrival gating, idle-gap advance and service-paced
    arbitration that the fast path
    (:func:`repro_torch.core.trace_engine.simulate_arrivals_fast`) is
    property-tested bit-identical against.

    Requests live in per-port FIFO queues (``pe_id``); a head is
    *eligible* once its ``arrival_fpga`` stamp (converted once to DRAM
    clocks) is ≤ the channel clock. One coupled loop:

    * **admission**: eligible heads are granted into the
      ``reorder_window``-deep pending window at service pace. The grant
      order is the arbiter's: fixed ``priority`` takes the lowest
      eligible port; (weighted) round robin keeps a rotating pointer
      with per-rotation credits — a port whose head has not arrived (or
      whose queue is empty) forfeits the rest of its credit for that
      rotation. This coupling is what makes arbitration a tenant-
      isolation mechanism: a backlogged hog cannot pre-enqueue its whole
      burst ahead of a later-arriving victim, because grants happen one
      service slot at a time against a bounded window.
    * **idle-gap advance**: with nothing pending and every queued head
      in the future, the clock jumps to the earliest head arrival.
      Refreshes that complete inside the gap overlap with idleness
      (banks still close, nothing stalls); one still in progress at the
      jump target delays the next issue to its end.
    * **refresh / pick / service**: identical to
      :func:`simulate_dram_sched_seq` — the accumulated-service refresh
      rule, the fifo / frfcfs / frfcfs_cap pick over the pending window
      (oldest = earliest *grant*), per-bank open-row classification,
      bus-turnaround against the issued direction sequence, and the
      positional bypass counters behind the starvation cap.

    The channel clock is tracked as ``anchor + offset`` — a float
    anchor assigned only at idle jumps plus an exact integer offset of
    service/refresh clocks — so every timestamp is produced by a single
    float rounding and the fast path can batch integer cost sums while
    remaining bit-identical. With every arrival at 0 the anchor stays
    integer zero and the loop degenerates *exactly*: single-port to
    :func:`simulate_dram_sched_seq`, multi-port to
    ``arbitrate_ports_seq`` composed with it (same permutation, counts
    and makespan — the closed-loop degeneracy property tests).

    ``trace`` (the reference's ``ChannelTrace``) makes the reference's
    oracle emit the lifecycle event stream natively — grants, idle gaps,
    refresh windows, turnarounds, issues, completions; the emitting code
    is kept for ROADMAP A5.3, and until then a ``trace`` that is not
    ``None`` raises ``NotImplementedError``.
    """
    refuse_trace(trace)
    addrs, n, rw_arr, arr, ports, nports = _serving_trace(
        addrs, timings, rw, arrival_fpga, pe_id, num_ports)
    if n == 0:
        return ServingSimResult(total_fpga_cycles=0.0, row_hits=0,
                                row_conflicts=0, first_accesses=0)
    rows = timings.row_of(addrs)
    banks = timings.bank_of(addrs)
    w = sched.effective_window
    use_cap = sched.policy == "frfcfs_cap"
    t_refi, t_rfc = sched.t_refi, sched.t_rfc
    credits = _serving_weights(nports, arb_policy, weights)
    priority = arb_policy == "priority"

    queues = [list(np.flatnonzero(ports == p)) for p in range(nports)]
    heads = [0] * nports
    open_row: dict[int, int] = {}
    pending: list[int] = []
    bypass: list[int] = []          # positional, parallel to ``pending``
    ptr, credit = 0, credits[0]     # (weighted) round-robin rotation state
    anchor: float | int = 0         # set only by idle jumps
    off = 0                         # integer service/refresh clocks since
    next_ref = t_refi
    n_hit = n_conflict = n_first = n_ref = turn = 0
    last_dir = -1
    idle = 0.0
    served = 0
    completion = np.zeros(n, np.float64)
    service = np.zeros(n, np.int64)
    grant_order: list[int] = []
    granted_port: list[int] = []
    order: list[int] = []
    ev = None if trace is None else trace.events

    def eligible(p: int) -> bool:
        h = heads[p]
        return h < len(queues[p]) and arr[queues[p][h]] <= anchor + off

    while served < n:
        while len(pending) < w:              # -- admission
            g = -1
            if priority:
                for p in range(nports):
                    if eligible(p):
                        g = p
                        break
            else:
                for _ in range(nports + 1):
                    if credit > 0 and eligible(ptr):
                        g = ptr
                        credit -= 1
                        break
                    ptr = (ptr + 1) % nports
                    credit = credits[ptr]
            if g < 0:
                break
            idx = queues[g][heads[g]]
            heads[g] += 1
            pending.append(idx)
            bypass.append(0)
            grant_order.append(idx)
            granted_port.append(g)
            if ev is not None:
                ev.append(("grant", anchor + off, idx, g))
        if not pending:                      # -- idle-gap advance
            target = min(arr[queues[p][heads[p]]] for p in range(nports)
                         if heads[p] < len(queues[p]))
            now0 = anchor + off
            if t_refi:
                while next_ref <= target:
                    n_ref += 1
                    open_row.clear()
                    end = next_ref + t_rfc
                    if ev is not None:
                        ev.append(("refresh", next_ref, end))
                    next_ref += t_refi
                    if end > target:
                        target = end         # arrived mid-refresh
            if ev is not None:
                ev.append(("idle", now0, target))
            idle += target - (anchor + off)
            anchor, off = target, 0
            continue
        if t_refi:
            while anchor + off >= next_ref:  # refresh precedes the issue
                if ev is not None:
                    ev.append(("refresh", anchor + off,
                               anchor + off + t_rfc))
                off += t_rfc
                n_ref += 1
                open_row.clear()
                next_ref += t_refi
        pick = 0
        if w > 1:
            forced = None
            if use_cap:
                for i in range(len(pending)):
                    if bypass[i] >= sched.starvation_cap:
                        forced = i
                        break
            if forced is not None:
                pick = forced
            else:
                for i, j in enumerate(pending):
                    b = int(banks[j])
                    if b in open_row and open_row[b] == rows[j]:
                        pick = i
                        break
        idx = pending.pop(pick)
        bypass.pop(pick)
        now_t = anchor + off
        b, r = int(banks[idx]), int(rows[idx])
        if b not in open_row:
            n_first += 1
            cls = "first"
            cost = timings.t_rcd + timings.t_cl
        elif open_row[b] == r:
            n_hit += 1
            cls = "hit"
            cost = timings.t_cl
        else:
            n_conflict += 1
            cls = "conflict"
            cost = timings.t_rp + timings.t_rcd + timings.t_cl
        open_row[b] = r
        cost += timings.t_burst
        if rw_arr is not None:
            d = int(rw_arr[idx])
            if last_dir == 1 and d == 0:
                turn += timings.t_wtr
                cost += timings.t_wtr
                if ev is not None:
                    ev.append(("turn", now_t, "wtr", timings.t_wtr))
            elif last_dir == 0 and d == 1:
                turn += timings.t_rtw
                cost += timings.t_rtw
                if ev is not None:
                    ev.append(("turn", now_t, "rtw", timings.t_rtw))
            last_dir = d
        if ev is not None:
            ev.append(("issue", now_t, idx, b, r, cls, cost, 1, "ok"))
        off += cost
        for i in range(pick):        # entries granted earlier were bypassed
            bypass[i] += 1
        completion[idx] = anchor + off
        service[idx] = cost
        order.append(idx)
        served += 1
        if ev is not None:
            ev.append(("complete", anchor + off, idx))

    return ServingSimResult(
        total_fpga_cycles=(anchor + off) * timings.clock_ratio,
        row_hits=n_hit, row_conflicts=n_conflict, first_accesses=n_first,
        n_refreshes=n_ref, refresh_dram_cycles=n_ref * t_rfc,
        turnaround_dram_cycles=turn,
        service_order=np.asarray(order, dtype=np.int64),
        completion_fpga_cycles=completion * timings.clock_ratio,
        service_dram_cycles=service,
        grant_order=np.asarray(grant_order, dtype=np.int64),
        granted_port=np.asarray(granted_port, dtype=np.int64),
        idle_dram_cycles=idle)


def simulate_arrivals(
    addrs: np.ndarray,
    timings: DRAMTimings = DDR4_2400,
    sched: DRAMSchedConfig = DRAMSchedConfig(),
    rw: np.ndarray | None = None,
    *,
    arrival_fpga: np.ndarray | None = None,
    pe_id: np.ndarray | None = None,
    num_ports: int | None = None,
    arb_policy: str = "round_robin",
    weights=None,
    engine: str = "auto",
    trace=None,
) -> ServingSimResult:
    """Open-loop channel service — the fast engine, bit-identical to
    :func:`simulate_arrivals_seq` (property-tested over arrival process
    × ports × arbiter policy × DRAM policy × window × cap × refresh ×
    rw). Single-port streams run the chunked frontier scan in
    ``repro_torch.core.trace_engine`` (row-hit runs at array speed, truncated
    by arrival/refresh/window boundaries); multi-port streams run its
    optimized admission-coupled event loop. ``trace`` (the lifecycle
    event stream) is ROADMAP A5.3: one that is not ``None`` raises
    ``NotImplementedError``."""
    if engine not in ("auto", "fast", "sequential"):
        raise ValueError(f"engine={engine!r} must be auto|fast|sequential")
    refuse_trace(trace)
    if engine == "sequential":
        return simulate_arrivals_seq(
            addrs, timings, sched, rw, arrival_fpga=arrival_fpga,
            pe_id=pe_id, num_ports=num_ports, arb_policy=arb_policy,
            weights=weights, trace=trace)
    from repro_torch.core import trace_engine
    return trace_engine.simulate_arrivals_fast(
        addrs, timings, sched, rw, arrival_fpga=arrival_fpga,
        pe_id=pe_id, num_ports=num_ports, arb_policy=arb_policy,
        weights=weights, trace=trace)


# ---------------------------------------------------------------------------
# Fault-injected (RAS) serving simulator
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FaultSimResult(ServingSimResult):
    """:class:`ServingSimResult` extended with RAS observability.

    ``fault`` is the :class:`repro_torch.core.faults.FaultStats` block for the
    run. ``attempts[i]`` counts the issues request ``i`` consumed
    (1 = clean or corrected first try; at most ``max_replays + 1``);
    ``dropped[i]`` flags requests whose last allowed attempt still
    failed — their completion stamp is the give-up time and they are
    counted in ``fault.n_dropped`` / ``fault.dropped_by_port``, never
    silently lost. With faults, ``service_dram_cycles[i]`` accumulates
    the bus clocks of *all* of request ``i``'s issues and
    ``service_order`` carries one entry per issue (replays repeat the
    index); ``grant_order`` remains the first-admission permutation.
    """

    fault: "object" = None
    attempts: np.ndarray = dataclasses.field(
        default_factory=lambda: np.empty(0, np.int64))
    dropped: np.ndarray = dataclasses.field(
        default_factory=lambda: np.empty(0, bool))

    def __post_init__(self):
        if self.fault is None:
            from repro_torch.core.faults import FaultStats
            self.fault = FaultStats()


def simulate_faults_seq(
    addrs: np.ndarray,
    timings: DRAMTimings = DDR4_2400,
    sched: DRAMSchedConfig = DRAMSchedConfig(),
    rw: np.ndarray | None = None,
    *,
    faults: FaultConfig | None = None,
    channel: int = 0,
    arrival_fpga: np.ndarray | None = None,
    pe_id: np.ndarray | None = None,
    num_ports: int | None = None,
    arb_policy: str = "round_robin",
    weights=None,
    trace=None,
) -> FaultSimResult:
    """Request-at-a-time oracle for the *fault-injected* open-loop
    channel — THE specification for error injection, ECC handling,
    bounded replay with backoff, outage stalls and graceful
    degradation that the fast path
    (:func:`repro_torch.core.trace_engine.simulate_faults_fast`) is
    property-tested bit-identical against.

    The loop is :func:`simulate_arrivals_seq` (admission / idle-gap
    advance / refresh / pick / service — unchanged) with a RAS layer
    around the service step:

    * **injection**: each *issue* of request ``i`` (attempt ``a``,
      1-based) draws ``u = error_uniform(seed, channel, i, a)`` and
      errors when ``u < transient_ber (+ weak_row_ber on a weak
      row)``. Weak rows are a seeded hash of the row id; ``channel``
      keys this channel's streams so multi-channel runs draw
      independently.
    * **outage windows**: before issuing, a channel inside a declared
      ``(start, end)`` outage jumps its clock to the window end
      (refreshes absorbed like an idle gap); pending work stalls —
      counted in ``fault.outage_dram_cycles`` — but nothing drops.
    * **classification**: an errored read under SECDED is *corrected*
      (``ecc_correction_clocks`` added to the issue's bus time) unless
      ``u < p * due_fraction`` makes it detected-uncorrectable; an
      errored write fails the link CRC when ``write_crc``; with
      ``ecc="none"`` / ``write_crc=False`` errors are silent (counted,
      no timing effect). The failed issue still occupied the bus
      (class cost + burst + turnaround it triggered) — that time is
      ``fault.replay_dram_cycles``.
    * **bounded replay**: a failed issue re-enters a replay queue
      ready at ``now + backoff_clocks << (attempt-1)``; ready replays
      are re-admitted into the reorder window *before* new arbiter
      grants (oldest-ready first). A request whose attempt
      ``max_replays + 1`` still fails is dropped at that stamp.
    * **degradation**: every injected error charges the effective row;
      at ``row_retire_threshold`` the natural row is retired — later
      accesses serve from spare row ``SPARE_ROW_BASE + row`` (same
      bank, never weak, capacity capped by ``max_retired_rows``).
      Every ``refresh_escalate_threshold`` injected errors shrink the
      effective refresh interval to ``t_refi >> level`` (floor
      ``t_rfc + 1``, at most ``refresh_escalate_max`` levels).

    With ``faults=None`` or an inactive config no draw, queue, or
    clock expression differs from :func:`simulate_arrivals_seq` — the
    zero-rate degeneracy is bit-identical (property-tested).

    ``trace`` (the reference's ``ChannelTrace``) makes the reference's
    oracle emit the lifecycle event stream natively — the serving events
    plus replay re-admissions, outage windows, per-attempt issue outcomes
    (ok/corrected/silent/failed), replay enqueues and drops; the emitting
    code is kept for ROADMAP A5.3, and until then a ``trace`` that is not
    ``None`` raises ``NotImplementedError``.
    """
    import heapq

    from repro_torch.core import faults as F

    refuse_trace(trace)
    fc = faults if faults is not None else FaultConfig()
    addrs, n, rw_arr, arr, ports, nports = _serving_trace(
        addrs, timings, rw, arrival_fpga, pe_id, num_ports)
    if n == 0:
        return FaultSimResult(total_fpga_cycles=0.0, row_hits=0,
                              row_conflicts=0, first_accesses=0)
    rows = timings.row_of(addrs)
    banks = timings.bank_of(addrs)
    w = sched.effective_window
    use_cap = sched.policy == "frfcfs_cap"
    t_refi, t_rfc = sched.t_refi, sched.t_rfc
    credits = _serving_weights(nports, arb_policy, weights)
    priority = arb_policy == "priority"
    weak_flags = F.weak_rows(fc, channel, rows)
    wins = fc.outage_windows_for(channel)
    secded = fc.ecc == "secded"

    queues = [list(np.flatnonzero(ports == p)) for p in range(nports)]
    heads = [0] * nports
    open_row: dict[int, int] = {}
    pending: list[int] = []
    bypass: list[int] = []
    ptr, credit = 0, credits[0]
    anchor: float | int = 0
    off = 0
    next_ref = t_refi
    t_refi_eff = t_refi             # shrinks under refresh escalation
    esc_level = 0
    n_hit = n_conflict = n_first = n_ref = turn = 0
    last_dir = -1
    idle = 0.0
    served = 0
    completion = np.zeros(n, np.float64)
    service = np.zeros(n, np.int64)
    attempts = np.zeros(n, np.int64)
    dropped = np.zeros(n, bool)
    grant_order: list[int] = []
    granted_port: list[int] = []
    order: list[int] = []
    replay_q: list[tuple[float, int, int]] = []   # (ready, seq, idx)
    rseq = 0
    retired: dict[int, int] = {}    # natural row -> spare row
    err_count: dict[int, int] = {}  # effective row -> charged errors
    st = F.FaultStats()
    retired_seq: list[tuple[int, int]] = []
    dropped_by_port: dict[int, int] = {}
    ev = None if trace is None else trace.events

    def eligible(p: int) -> bool:
        h = heads[p]
        return h < len(queues[p]) and arr[queues[p][h]] <= anchor + off

    while served < n:
        while len(pending) < w:              # -- admission
            if replay_q and replay_q[0][0] <= anchor + off:
                _, _, ridx = heapq.heappop(replay_q)
                pending.append(ridx)         # replays re-enter first
                bypass.append(0)
                if ev is not None:
                    ev.append(("readmit", anchor + off, ridx))
                continue
            g = -1
            if priority:
                for p in range(nports):
                    if eligible(p):
                        g = p
                        break
            else:
                for _ in range(nports + 1):
                    if credit > 0 and eligible(ptr):
                        g = ptr
                        credit -= 1
                        break
                    ptr = (ptr + 1) % nports
                    credit = credits[ptr]
            if g < 0:
                break
            idx = queues[g][heads[g]]
            heads[g] += 1
            pending.append(idx)
            bypass.append(0)
            grant_order.append(idx)
            granted_port.append(g)
            if ev is not None:
                ev.append(("grant", anchor + off, idx, g))
        if not pending:                      # -- idle-gap advance
            targets = [arr[queues[p][heads[p]]] for p in range(nports)
                       if heads[p] < len(queues[p])]
            if replay_q:
                targets.append(replay_q[0][0])
            target = min(targets)
            now0 = anchor + off
            if t_refi:
                while next_ref <= target:
                    n_ref += 1
                    open_row.clear()
                    end = next_ref + t_rfc
                    if ev is not None:
                        ev.append(("refresh", next_ref, end))
                    next_ref += t_refi_eff
                    if end > target:
                        target = end         # arrived mid-refresh
            if ev is not None:
                ev.append(("idle", now0, target))
            idle += target - (anchor + off)
            anchor, off = target, 0
            continue
        now = anchor + off
        jumped = False
        for s, e in wins:                    # -- outage window stall
            if s <= now < e:
                target = float(e)
                if t_refi:
                    while next_ref <= target:
                        n_ref += 1
                        open_row.clear()
                        end = next_ref + t_rfc
                        if ev is not None:
                            ev.append(("refresh", next_ref, end))
                        next_ref += t_refi_eff
                        if end > target:
                            target = end
                if ev is not None:
                    ev.append(("outage", now, target))
                st.outage_dram_cycles += target - now
                anchor, off = target, 0
                jumped = True
                break
        if jumped:
            continue
        if t_refi:
            while anchor + off >= next_ref:  # refresh precedes the issue
                if ev is not None:
                    ev.append(("refresh", anchor + off,
                               anchor + off + t_rfc))
                off += t_rfc
                n_ref += 1
                open_row.clear()
                next_ref += t_refi_eff
        pick = 0
        if w > 1:
            forced = None
            if use_cap:
                for i in range(len(pending)):
                    if bypass[i] >= sched.starvation_cap:
                        forced = i
                        break
            if forced is not None:
                pick = forced
            else:
                for i, j in enumerate(pending):
                    b = int(banks[j])
                    eff = retired.get(int(rows[j]), int(rows[j]))
                    if b in open_row and open_row[b] == eff:
                        pick = i
                        break
        idx = pending.pop(pick)
        bypass.pop(pick)
        now_t = anchor + off
        b, r_nat = int(banks[idx]), int(rows[idx])
        r = retired.get(r_nat, r_nat)
        if r != r_nat:
            st.spare_issues += 1
        if b not in open_row:
            n_first += 1
            cls = "first"
            cost = timings.t_rcd + timings.t_cl
        elif open_row[b] == r:
            n_hit += 1
            cls = "hit"
            cost = timings.t_cl
        else:
            n_conflict += 1
            cls = "conflict"
            cost = timings.t_rp + timings.t_rcd + timings.t_cl
        open_row[b] = r
        cost += timings.t_burst
        tpen = None
        if rw_arr is not None:
            d = int(rw_arr[idx])
            if last_dir == 1 and d == 0:
                turn += timings.t_wtr
                cost += timings.t_wtr
                tpen = ("wtr", timings.t_wtr)
            elif last_dir == 0 and d == 1:
                turn += timings.t_rtw
                cost += timings.t_rtw
                tpen = ("rtw", timings.t_rtw)
            last_dir = d
        attempts[idx] += 1
        att = int(attempts[idx])
        if att > 1:
            st.n_replays += 1
        weak = bool(weak_flags[idx]) and r == r_nat
        p_err = F.error_prob(fc, weak)
        errored = False
        u = 0.0
        if p_err > 0.0:
            u = F.error_uniform(fc, channel, idx, att)
            errored = u < p_err
        failed = False
        outcome = "ok"
        if errored:
            st.n_injected += 1
            if fc.row_retire_threshold and r < F.SPARE_ROW_BASE:
                c = err_count.get(r, 0) + 1
                err_count[r] = c
                if (c >= fc.row_retire_threshold
                        and r_nat not in retired
                        and len(retired) < fc.max_retired_rows):
                    retired[r_nat] = F.SPARE_ROW_BASE + r_nat
                    retired_seq.append((channel, r_nat))
            if fc.refresh_escalate_threshold and t_refi:
                while (esc_level < fc.refresh_escalate_max
                       and st.n_injected >= fc.refresh_escalate_threshold
                       * (esc_level + 1)):
                    esc_level += 1
                    st.refresh_escalations += 1
                    shrunk = t_refi >> esc_level
                    t_refi_eff = shrunk if shrunk > t_rfc else t_rfc + 1
            is_read = rw_arr is None or int(rw_arr[idx]) == 0
            if is_read:
                if secded:
                    if u < p_err * fc.due_fraction:
                        failed = True            # detected-uncorrectable
                        outcome = "failed"
                    else:
                        st.n_corrected += 1
                        st.correction_dram_cycles += fc.ecc_correction_clocks
                        cost += fc.ecc_correction_clocks
                        outcome = "corrected"
                else:
                    st.n_silent += 1
                    outcome = "silent"
            else:
                if fc.write_crc:
                    failed = True                # link CRC retry
                    outcome = "failed"
                else:
                    st.n_silent += 1
                    outcome = "silent"
        if ev is not None:
            if tpen is not None:
                ev.append(("turn", now_t, tpen[0], tpen[1]))
            ev.append(("issue", now_t, idx, b, r, cls, cost, att, outcome))
        off += cost
        for i in range(pick):
            bypass[i] += 1
        service[idx] += cost
        order.append(idx)
        if failed:
            st.n_uncorrectable += 1
            st.replay_dram_cycles += cost
            if att > fc.max_replays:             # out of attempts: drop
                dropped[idx] = True
                st.n_dropped += 1
                port = int(ports[idx])
                dropped_by_port[port] = dropped_by_port.get(port, 0) + 1
                completion[idx] = anchor + off
                served += 1
                if ev is not None:
                    ev.append(("drop", anchor + off, idx, att))
            else:
                rseq += 1
                ready = anchor + off + fc.backoff_for(att)
                heapq.heappush(replay_q, (ready, rseq, idx))
                if ev is not None:
                    ev.append(("replay", anchor + off, idx, att, ready))
        else:
            completion[idx] = anchor + off
            served += 1
            if ev is not None:
                ev.append(("complete", anchor + off, idx))

    st.rows_retired = tuple(retired_seq)
    st.dropped_by_port = dropped_by_port
    return FaultSimResult(
        total_fpga_cycles=(anchor + off) * timings.clock_ratio,
        row_hits=n_hit, row_conflicts=n_conflict, first_accesses=n_first,
        n_refreshes=n_ref, refresh_dram_cycles=n_ref * t_rfc,
        turnaround_dram_cycles=turn,
        service_order=np.asarray(order, dtype=np.int64),
        completion_fpga_cycles=completion * timings.clock_ratio,
        service_dram_cycles=service,
        grant_order=np.asarray(grant_order, dtype=np.int64),
        granted_port=np.asarray(granted_port, dtype=np.int64),
        idle_dram_cycles=idle,
        fault=st, attempts=attempts, dropped=dropped)


def simulate_faults(
    addrs: np.ndarray,
    timings: DRAMTimings = DDR4_2400,
    sched: DRAMSchedConfig = DRAMSchedConfig(),
    rw: np.ndarray | None = None,
    *,
    faults: FaultConfig | None = None,
    channel: int = 0,
    arrival_fpga: np.ndarray | None = None,
    pe_id: np.ndarray | None = None,
    num_ports: int | None = None,
    arb_policy: str = "round_robin",
    weights=None,
    engine: str = "auto",
    trace=None,
) -> FaultSimResult:
    """Fault-injected channel service — the fast engine, bit-identical
    to :func:`simulate_faults_seq`. An inactive fault config (``None``
    or nothing to inject on any channel) delegates to the fault-free
    fast path and wraps its result — the zero-rate degeneracy costs
    nothing (and emits the fault-free event stream, which is what the
    oracle emits too when nothing injects). ``trace`` (the lifecycle
    event stream) is ROADMAP A5.3: one that is not ``None`` raises
    ``NotImplementedError``."""
    if engine not in ("auto", "fast", "sequential"):
        raise ValueError(f"engine={engine!r} must be auto|fast|sequential")
    refuse_trace(trace)
    if engine == "sequential":
        return simulate_faults_seq(
            addrs, timings, sched, rw, faults=faults, channel=channel,
            arrival_fpga=arrival_fpga, pe_id=pe_id, num_ports=num_ports,
            arb_policy=arb_policy, weights=weights, trace=trace)
    if faults is None or not faults.injects:
        base = simulate_arrivals(
            addrs, timings, sched, rw, arrival_fpga=arrival_fpga,
            pe_id=pe_id, num_ports=num_ports, arb_policy=arb_policy,
            weights=weights, trace=trace)
        n = base.completion_fpga_cycles.size
        return FaultSimResult(
            total_fpga_cycles=base.total_fpga_cycles,
            row_hits=base.row_hits, row_conflicts=base.row_conflicts,
            first_accesses=base.first_accesses,
            n_refreshes=base.n_refreshes,
            refresh_dram_cycles=base.refresh_dram_cycles,
            turnaround_dram_cycles=base.turnaround_dram_cycles,
            service_order=base.service_order,
            completion_fpga_cycles=base.completion_fpga_cycles,
            service_dram_cycles=base.service_dram_cycles,
            grant_order=base.grant_order,
            granted_port=base.granted_port,
            idle_dram_cycles=base.idle_dram_cycles,
            attempts=np.ones(n, np.int64),
            dropped=np.zeros(n, bool))
    from repro_torch.core import trace_engine
    return trace_engine.simulate_faults_fast(
        addrs, timings, sched, rw, faults=faults, channel=channel,
        arrival_fpga=arrival_fpga, pe_id=pe_id, num_ports=num_ports,
        arb_policy=arb_policy, weights=weights, trace=trace)


def modeled_bandwidth_gbps(
    result: SimResult, total_bytes: int, timings: DRAMTimings = DDR4_2400
) -> float:
    """Sustained bandwidth implied by a simulation result."""
    seconds = result.total_fpga_cycles * timings.t_fpga_ns * 1e-9
    return total_bytes / max(seconds, 1e-12) / 1e9


def roofline_time_s(
    flops: float,
    hbm_bytes: float,
    collective_bytes: float,
    *,
    chips: int,
    peak_flops: float = 197e12,
    hbm_bw: float = 819e9,
    ici_bw: float = 50e9 * 4,  # ~50 GB/s/link x 4 links per v5e chip (2D torus)
) -> dict:
    """Three-term roofline for §Roofline of EXPERIMENTS.md.

    Inputs are *global* HLO quantities; each term divides by the chip count
    (SPMD: every chip executes 1/chips of the work in parallel). The
    defaults are the reference's TPU v5e constants, kept for parity; they
    describe no measurement of this port.
    """
    compute_s = flops / (chips * peak_flops)
    memory_s = hbm_bytes / (chips * hbm_bw)
    collective_s = collective_bytes / (chips * ici_bw)
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": collective_s}
    terms["bottleneck"] = max(terms, key=lambda k: terms[k]).removesuffix("_s")
    terms["bound_s"] = max(compute_s, memory_s, collective_s)
    return terms
