"""Timing-model-driven parameter autotuner (the paper's TUNE column).

The paper tunes batch size, scheduler timeout, associativity and DMA
parallelism by hand against a target workload. We close the loop: given a
representative request trace and a resource (VMEM) budget, enumerate the
TUNE-class parameter grid, score each candidate with the analytic/simulated
timing model, and return the best feasible configuration. This is what
"programmable" buys over a fixed commercial IP: the controller is
re-specialized per application in seconds.

Counterpart of the reference's ``repro.core.autotune``, copied expression
for expression: numpy on the host, no device tensor. Each engine gives
its reference counterpart's scores, tables and argmin with ``==``; the
two engines of one package may differ in the last digit of a score on
some draws (ROADMAP C6), so neither package's batched engine is held to
the other's oracle.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Sequence

import numpy as np

from repro_torch.core.config import (CacheConfig, ChannelConfig, DMAConfig,
                                     DRAMSchedConfig, FaultConfig,
                                     MemoryControllerConfig, SchedulerConfig)
from repro_torch.core.pipeline import (AddressMapStage, CacheFilterStage,
                                       PipelineContext, RequestStream,
                                       default_stages, run_pipeline)
from repro_torch.core.scheduler import READ, WRITE
from repro_torch.core.timing import (DRAMTimings, DDR4_2400,
                                     simulate_dram_sched,
                                     t_overlapped_schedule)


@dataclasses.dataclass
class TuneResult:
    config: MemoryControllerConfig
    modeled_cycles: float
    candidates_evaluated: int
    table: list  # (config summary, cycles) per candidate, for reporting


def _score(
    cfg: MemoryControllerConfig,
    row_ids: np.ndarray,
    row_bytes: int,
    timings: DRAMTimings,
    memo: dict | None = None,
) -> float:
    """Modeled total access cycles for an irregular trace under ``cfg`` —
    the full staged pipeline's ``makespan_fpga_cycles``.

    Cache hits are served on-chip and *removed* from the DRAM stream
    (CacheFilter); misses flow through the per-channel schedulers to the
    channel-parallel DRAM service, so the DRAM term is the multi-channel
    makespan; only the non-overlapped scheduling residual is exposed
    (DMAOverlap). Scoring the composed pipeline is what lets ``tune``
    search cache geometry × num_channels × mapping policy *jointly*
    instead of by independent oracles. ``memo`` is the CacheFilter's
    shared cache, keyed by cache×channel shape (one expensive trace scan
    per shape across the whole grid).
    """
    stream = RequestStream.from_rows(row_ids, row_bytes=row_bytes)
    ctx = PipelineContext.from_config(cfg, timings)
    stages = default_stages(ctx, cache=True, cache_memo=memo)
    return run_pipeline(stream, ctx, stages).makespan_fpga_cycles


# ---------------------------------------------------------------------------
# Batched grid scorer (the vmap axis over stacked configs)
# ---------------------------------------------------------------------------
#
# ``tune``'s one-at-a-time path rebuilds the stream, re-plans the batch
# former (twice: once to schedule, once to count) and re-classifies the
# served stream for every grid point — all python-per-batch work on axes
# that are algebraically redundant:
#
#   * the score never reads ``cfg.dma`` (``PipelineContext.from_config``
#     drops it; DMA only constrains VMEM feasibility), so the dma axis is
#     a pure replication of scores;
#   * with all-zero arrivals (every closed-loop tune trace) the dual-queue
#     batch plan degenerates to strided chunking of each type's index
#     list — vectorizable, no python-per-batch walk;
#   * the strict-FIFO service classification of the *scheduled* stream
#     (sorted by (batch, row), then classified per bank in service order)
#     is one fused stable key sort by (bank, batch_rank, row): within a
#     bank, service order IS (batch_rank, row) order, so hit/first/
#     conflict counts fall out of adjacent-key comparisons. All counts
#     are integers and the cost polynomial is evaluated in the same
#     order, so the scores are bit-identical to the staged pipeline's.
#
# Non-degenerate command schedulers (window > 1 or refresh) drop to the
# real ``simulate_dram_sched`` per grid point — but on the vectorized
# served stream, and still with the dma axis hoisted.

def _const_batch_plan(rw_arr: np.ndarray, batch: int):
    """Vectorized dual-queue batch plan for a constant-arrival trace.

    Returns ``(n_events, rank_elem, types_by_rank)`` where ``rank_elem``
    maps each request to the service rank of its batch and
    ``types_by_rank`` is the per-batch request type in service order —
    identical ordering to ``scheduler._typed_batch_plan`` (timeouts
    cannot fire when every arrival stamp is equal, so batch boundaries
    are strided chunks of each type's positions; full batches key on
    their closing request's global index, partial flushes drain last,
    oldest head first).
    """
    m = rw_arr.shape[0]
    lims, phases, ties, types = [], [], [], []
    per_type_idx = []
    for t_order, t in enumerate((READ, WRITE)):
        idxs = np.flatnonzero(rw_arr == t)
        per_type_idx.append(idxs)
        mt = idxs.shape[0]
        n_full = mt // batch
        part = 1 if mt % batch else 0
        lim = np.empty(n_full + part, np.int64)
        ph = np.empty(n_full + part, np.int64)
        tie = np.empty(n_full + part, np.int64)
        lim[:n_full] = idxs[batch - 1::batch][:n_full]
        ph[:n_full] = 1
        tie[:n_full] = t_order
        if part:
            lim[n_full] = m
            ph[n_full] = 2
            tie[n_full] = idxs[n_full * batch]
        lims.append(lim)
        phases.append(ph)
        ties.append(tie)
        types.append(np.full(n_full + part, t, np.int32))
    lim_all = np.concatenate(lims)
    n_events = lim_all.shape[0]
    order = np.lexsort((np.concatenate(ties), np.concatenate(phases),
                        lim_all))
    ranks = np.empty(n_events, np.int64)
    ranks[order] = np.arange(n_events, dtype=np.int64)
    rank_elem = np.empty(m, np.int64)
    off = 0
    for idxs in per_type_idx:
        if idxs.size:
            rank_elem[idxs] = ranks[off + np.arange(idxs.size) // batch]
        off += idxs.size // batch + (1 if idxs.size % batch else 0)
    return n_events, rank_elem, np.concatenate(types)[order]


def _fifo_service_fpga_cycles(rows, banks, rank_elem, n_events,
                              types_by_rank, timings: DRAMTimings) -> float:
    """Strict-FIFO DRAM service cycles of the batch-scheduled stream —
    bit-identical to ``schedule_trace_rw`` + ``simulate_dram_access``
    without materializing the served permutation.

    One key sort by (bank, batch_rank, row) yields each bank's service
    sequence; row transitions within a bank classify hit/conflict,
    bank boundaries are first accesses, and bus turnarounds reduce to
    type flips between consecutive batches (single-type batches change
    direction only at batch seams). All counts are exact integers.
    """
    m = rows.shape[0]
    if m == 0:
        return 0.0
    row_span = int(rows.max()) + 1
    nb = int(timings.num_banks)
    if row_span * n_events * nb < (1 << 62):
        key = (banks * n_events + rank_elem) * row_span + rows
        key.sort()
        span = n_events * row_span
        b_s = key // span
        r_s = key % row_span
    else:
        perm = np.lexsort((rows, rank_elem, banks))
        b_s = banks[perm]
        r_s = rows[perm]
    same_b = b_s[1:] == b_s[:-1]
    n_hit = int((same_b & (r_s[1:] == r_s[:-1])).sum())
    n_first = m - int(same_b.sum())
    n_conflict = m - n_first - n_hit
    prev, cur = types_by_rank[:-1], types_by_rank[1:]
    turn = (int(((prev == WRITE) & (cur == READ)).sum()) * timings.t_wtr
            + int(((prev == READ) & (cur == WRITE)).sum()) * timings.t_rtw)
    dram_cycles = (
        n_first * (timings.t_rcd + timings.t_cl)
        + n_hit * timings.t_cl
        + n_conflict * (timings.t_rp + timings.t_rcd + timings.t_cl)
        + m * timings.t_burst
    ) + turn
    return dram_cycles * timings.clock_ratio


def _scheduled_stream(local, rw_arr, rows, rank_elem):
    """The batch-scheduled (served) stream — bit-identical to
    ``schedule_trace_rw`` via one stable sort on the fused
    (batch_rank, row) key (ties keep arrival order, the weak-consistency
    rule)."""
    m = local.shape[0]
    row_span = int(rows.max()) + 1 if m else 1
    if m and row_span < (1 << 62) // (rank_elem.max() + 2):
        perm = np.argsort(rank_elem * row_span + rows, kind="stable")
    else:
        perm = np.lexsort((np.arange(m), rows, rank_elem))
    return local[perm], rw_arr[perm]


def _batched_scores(
    row_ids: np.ndarray,
    row_bytes: int,
    timings: DRAMTimings,
    *,
    batch_sizes,
    cache_grid,
    chan_grid,
    sched_grid,
    starvation_cap: int,
    enable_cache: bool,
    filter_memo: dict,
) -> dict:
    """Stage-cycle sums for the whole (batch × cache × channels × sched)
    grid, keyed ``(batch, ways, lines, nc, policy, spol, win)`` — each
    entry bit-identical to the corresponding ``_score`` minus the
    (config-constant) control overhead. The dma axis never appears: the
    score is invariant in it."""
    stream0 = RequestStream.from_rows(row_ids, row_bytes=row_bytes)
    scores: dict = {}
    for ways, lines in cache_grid:
        if ways > lines:
            continue
        for nc, policy in chan_grid:
            ctx = PipelineContext(
                channels=ChannelConfig(num_channels=nc, policy=policy),
                scheduler=None,
                cache=CacheConfig(enabled=enable_cache, num_lines=lines,
                                  associativity=ways),
                timings=timings)
            mapped, _ = AddressMapStage().run(stream0, ctx)
            hits_cycles = 0.0
            if enable_cache:
                filtered, fstats = CacheFilterStage(
                    memo=filter_memo).run(mapped, ctx)
                hits_cycles = fstats.cycles
            else:
                filtered = mapped
            chans = []
            for _k in range(nc):
                sel = np.flatnonzero(filtered.channel == _k)
                local = filtered.local_addr[sel]
                chans.append((local, filtered.rw[sel],
                              timings.row_of(local),
                              timings.bank_of(local)))
            for batch in batch_sizes:
                plans = [_const_batch_plan(rw_c, batch) if local.size else
                         (0, None, None)
                         for local, rw_c, _r, _b in chans]
                for spol, win in sched_grid:
                    dsched = DRAMSchedConfig(policy=spol, reorder_window=win,
                                             starvation_cap=starvation_cap)
                    degenerate = (dsched.effective_window == 1
                                  and not dsched.t_refi)
                    totals = []
                    n_batches = 0
                    for (local, rw_c, rows, banks), \
                            (n_ev, rank_elem, types_r) in zip(chans, plans):
                        n_batches += n_ev
                        if local.size == 0:
                            totals.append(0.0)
                        elif degenerate:
                            totals.append(_fifo_service_fpga_cycles(
                                rows, banks, rank_elem, n_ev, types_r,
                                timings))
                        else:
                            served, served_rw = _scheduled_stream(
                                local, rw_c, rows, rank_elem)
                            totals.append(simulate_dram_sched(
                                served, timings, dsched,
                                rw=served_rw).total_fpga_cycles)
                    mk = max(totals, default=0.0)
                    ex = 0.0 if n_batches == 0 else t_overlapped_schedule(
                        batch, n_batches, mk,
                        SchedulerConfig(batch_size=batch).data_cond_cycles)
                    # replicate run_pipeline's left-to-right stage sum:
                    # addr_map, (cache), scheduler, dram, dma_overlap
                    s = 0 + 0.0
                    if enable_cache:
                        s = s + hits_cycles
                    s = s + 0.0
                    s = s + mk
                    s = s + ex
                    scores[(batch, ways, lines, nc, policy, spol, win)] = s
    return scores


def tune(
    row_ids: np.ndarray,
    row_bytes: int,
    *,
    vmem_budget_bytes: int = 8 << 20,
    batch_sizes: Sequence[int] = (4, 8, 16, 32, 64, 128, 256, 512),
    associativities: Sequence[int] = (1, 2, 4, 8),
    num_lines: Sequence[int] = (1024, 4096, 16384),
    dma_channels: Sequence[int] = (1, 2, 4, 8),
    num_channels: Sequence[int] = (1,),
    mapping_policies: Sequence[str] = ("row_interleave",),
    dram_sched_policies: Sequence[str] = ("fifo",),
    reorder_windows: Sequence[int] = (1,),
    starvation_cap: int = 16,
    enable_cache: bool = True,
    timings: DRAMTimings = DDR4_2400,
    engine: str = "batched",
) -> TuneResult:
    """Grid-search TUNE parameters for a trace under a VMEM budget.

    ``num_channels`` × ``mapping_policies`` extend the grid with the
    multi-channel front end's axes (``ChannelConfig``); the defaults keep
    the paper's single-interface search space. With one channel every
    mapping policy is the identity, so only the first policy is scored.

    ``dram_sched_policies`` × ``reorder_windows`` add the DRAM command
    scheduler's axes (``DRAMSchedConfig``): FIFO never reorders, so it
    is scored at one window only, and window 1 collapses every policy
    to FIFO — redundant grid points are deduplicated before scoring.

    ``engine`` selects the scorer: ``"batched"`` (default) evaluates the
    whole grid as one stacked computation (see ``_batched_scores`` — the
    dma axis is hoisted, the batch plan vectorized, and the strict-FIFO
    service term classified by one fused key sort per variant);
    ``"oracle"`` scores candidates one at a time through the staged
    pipeline. Both return the same argmin and tables whose scores agree
    but for the last digit on some draws (ROADMAP C6); each engine equals
    the reference's same engine with ``==``.
    """
    row_ids = np.asarray(row_ids)
    if engine not in ("batched", "oracle"):
        raise ValueError(f"unknown tune engine {engine!r} "
                         "(expected 'batched' or 'oracle')")
    best_cfg, best_cycles, table = None, float("inf"), []
    n_eval = 0
    cache_grid = (
        list(itertools.product(associativities, num_lines))
        if enable_cache else [(1, 256)])
    chan_grid = [(nc, pol) for nc in num_channels
                 for pol in (mapping_policies if nc > 1
                             else mapping_policies[:1])]
    sched_grid = sorted({
        ("fifo", 1) if (pol == "fifo" or win == 1) else (pol, win)
        for pol in dram_sched_policies for win in reorder_windows})
    # The cache-filtered stream — the expensive full-trace scan — depends
    # only on the cache shape and the channel mapping, not on batch/dma
    # axes: the CacheFilter stage memoizes it per (cache, channels) shape
    # across the whole grid via this shared dict.
    filter_memo: dict = {}
    scores = None
    if engine == "batched":
        scores = _batched_scores(
            row_ids, row_bytes, timings, batch_sizes=batch_sizes,
            cache_grid=cache_grid, chan_grid=chan_grid,
            sched_grid=sched_grid, starvation_cap=starvation_cap,
            enable_cache=enable_cache, filter_memo=filter_memo)

    for batch in batch_sizes:
        for ways, lines in cache_grid:
            if ways > lines:
                continue
            for ch in dma_channels:
                for nc, policy in chan_grid:
                    for spol, win in sched_grid:
                        cfg = MemoryControllerConfig(
                            scheduler=SchedulerConfig(batch_size=batch),
                            cache=CacheConfig(enabled=enable_cache,
                                              num_lines=lines,
                                              associativity=ways),
                            dma=DMAConfig(num_parallel_dma=ch),
                            channels=ChannelConfig(num_channels=nc,
                                                   policy=policy),
                            dram_sched=DRAMSchedConfig(
                                policy=spol, reorder_window=win,
                                starvation_cap=starvation_cap),
                        )
                        if cfg.vmem_footprint_bytes() > vmem_budget_bytes:
                            continue
                        n_eval += 1
                        if scores is not None:
                            cycles = float(cfg.ctrl_overhead_cycles) \
                                + scores[(batch, ways, lines, nc, policy,
                                          spol, win)]
                        else:
                            cycles = _score(cfg, row_ids, row_bytes,
                                            timings, memo=filter_memo)
                        table.append((
                            f"batch={batch} ways={ways} lines={lines} "
                            f"dma={ch} mem_ch={nc} map={policy} "
                            f"dsched={spol}:{win}",
                            cycles))
                        if cycles < best_cycles:
                            best_cfg, best_cycles = cfg, cycles
    if best_cfg is None:
        raise ValueError("no feasible configuration under the VMEM budget")
    return TuneResult(config=best_cfg, modeled_cycles=best_cycles,
                      candidates_evaluated=n_eval, table=table)


def sweep_serving_loads(
    config: MemoryControllerConfig,
    row_ids: np.ndarray,
    rw: np.ndarray | None,
    pe_id: np.ndarray | None,
    arrival_sweep: Sequence[np.ndarray],
    row_bytes: int,
    *,
    arbiter_policy: str = "round_robin",
    weights: Sequence[int] | None = None,
    faults: FaultConfig | None = None,
    timings: DRAMTimings = DDR4_2400,
) -> list:
    """Batched open-loop load sweep: one trace, many arrival processes.

    The ``perf_serving`` offered-load sweep re-ingests and re-validates
    the same trace once per load point when driven through
    ``MemoryController.simulate``; this evaluates the whole stacked
    sweep in one call — the request stream is built and validated once,
    and each load point swaps in its arrival stamps and runs the
    open-loop serving pipeline. Per-point :class:`PipelineResult`\\ s are
    bit-identical to the one-at-a-time path
    (``MemoryController.simulate`` per point).
    """
    base = RequestStream.from_rows(row_ids, rw, row_bytes=row_bytes,
                                   pe_id=pe_id)
    if len(base) == 0:
        raise ValueError("sweep_serving_loads got an empty trace")
    ports = config.num_pes if pe_id is not None else None
    results = []
    for arr in arrival_sweep:
        arr = np.asarray(arr, dtype=np.float64).ravel()
        if arr.shape[0] != len(base):
            raise ValueError("each arrival vector must have one entry "
                             "per request")
        if not np.isfinite(arr).all() or arr.min() < 0:
            raise ValueError(
                "arrival_cycle entries must be finite and >= 0")
        stream = dataclasses.replace(base, arrival_cycle=arr)
        ctx = PipelineContext.from_config(config, timings)
        ctx.scheduler = None
        ctx.open_loop = True
        if faults is not None:
            ctx.faults = faults
        stages = default_stages(ctx, ports=ports,
                                arbiter_policy=arbiter_policy,
                                weights=weights, cache=False)
        results.append(run_pipeline(stream, ctx, stages))
    return results


# ---------------------------------------------------------------------------
# SLO-constrained serving objective (open-loop, ARCHITECTURE §9)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ServingTuneResult:
    config: MemoryControllerConfig
    arb_policy: str
    weights: tuple | None
    slo_p99_cycles: float        # achieved p99 of the SLO port
    makespan_cycles: float
    feasible: bool               # met the SLO target (if one was given)
    candidates_evaluated: int
    table: list                  # (summary, slo_p99, makespan) per candidate
    n_dropped: int = 0           # replay-exhausted drops of the winner


def _score_serving(cfg, row_ids, rw, pe_id, arrival, row_bytes, *,
                   num_ports, policy, weights, timings):
    """One serving candidate: open-loop pipeline, per-port sojourns."""
    stream = RequestStream.from_rows(row_ids, rw, row_bytes=row_bytes,
                                     pe_id=pe_id, arrival_cycle=arrival)
    ctx = PipelineContext.from_config(cfg, timings)
    ctx.scheduler = None
    ctx.open_loop = True
    stages = default_stages(ctx, ports=num_ports, arbiter_policy=policy,
                            weights=weights, cache=False)
    return run_pipeline(stream, ctx, stages)


def tune_serving(
    row_ids: np.ndarray,
    rw: np.ndarray | None,
    pe_id: np.ndarray,
    arrival_cycle: np.ndarray,
    row_bytes: int,
    *,
    num_ports: int,
    slo_port: int = 0,
    slo_p99_cycles: float | None = None,
    arb_policies: Sequence[str] = ("round_robin", "priority", "weighted"),
    weight_ratios: Sequence[int] = (2, 4, 8),
    dram_sched_policies: Sequence[str] = ("frfcfs", "frfcfs_cap"),
    reorder_windows: Sequence[int] = (16, 32),
    starvation_caps: Sequence[int] = (8, 16),
    faults: FaultConfig | None = None,
    max_replays_grid: Sequence[int] = (2, 4, 8),
    backoff_grid: Sequence[int] = (8, 32, 128),
    timings: DRAMTimings = DDR4_2400,
) -> ServingTuneResult:
    """Tune the QoS knobs for an open-loop multi-tenant trace.

    The objective is *constrained*: among candidates whose SLO port
    (``slo_port``) meets ``slo_p99_cycles`` p99 sojourn, pick the one
    with the best overall makespan (throughput); if none meets it — or
    no target is given — fall back to minimizing the SLO port's p99
    outright. ``weighted`` candidates favor the SLO port by each ratio
    in ``weight_ratios`` (other ports weight 1); ``frfcfs_cap``
    candidates sweep the starvation cap, the knob that bounds how long
    a reorder window may defer the SLO tenant's misses.

    Passing ``faults`` (an *active* :class:`FaultConfig`, i.e. an error
    storm to survive) adds the **retry-policy axis**: every arbitration
    × scheduler candidate is additionally swept over
    ``max_replays_grid`` × ``backoff_grid`` (replacing the seed
    config's ``max_replays`` / ``backoff_clocks``). Feasibility then
    also requires **zero replay-exhausted drops** — a dropped request
    has no real completion, so a config that meets the p99 target by
    giving up on requests is not meeting the SLO. Within that, the
    usual order applies: too few replays drops requests (infeasible),
    too many replays of a hard-failing cell burns bus time that the
    victim tenant's p99 pays for — the sweep finds the bounded middle.
    """
    row_ids = np.asarray(row_ids)
    arb_grid: list[tuple[str, tuple | None]] = []
    for pol in arb_policies:
        if pol == "weighted":
            for ratio in weight_ratios:
                w = [1] * num_ports
                w[slo_port] = int(ratio)
                arb_grid.append((pol, tuple(w)))
        else:
            arb_grid.append((pol, None))
    sched_grid = sorted({
        (pol, win, cap if pol == "frfcfs_cap" else 0)
        for pol in dram_sched_policies for win in reorder_windows
        for cap in (starvation_caps if pol == "frfcfs_cap" else (0,))})
    fault_grid: list[FaultConfig | None] = [None]
    if faults is not None and faults.active:
        fault_grid = [dataclasses.replace(faults, max_replays=mr,
                                          backoff_clocks=bo)
                      for mr in sorted(set(max_replays_grid))
                      for bo in sorted(set(backoff_grid))]

    best = None          # (feasible, key, result row)
    table = []
    n_eval = 0
    for (apol, w) in arb_grid:
        for (spol, win, cap) in sched_grid:
            for fc in fault_grid:
                cfg = MemoryControllerConfig(
                    dram_sched=DRAMSchedConfig(
                        policy=spol, reorder_window=win,
                        starvation_cap=cap or 16),
                    faults=fc)
                res = _score_serving(cfg, row_ids, rw, pe_id,
                                     arrival_cycle, row_bytes,
                                     num_ports=num_ports, policy=apol,
                                     weights=w, timings=timings)
                port = res.serving.per_port.get(slo_port)
                p99 = float(port["p99_sojourn"]) if port else 0.0
                mk = res.makespan_fpga_cycles
                drops = res.fault.n_dropped if res.fault is not None else 0
                n_eval += 1
                feasible = (slo_p99_cycles is None
                            or p99 <= slo_p99_cycles) and drops == 0
                table.append((f"arb={apol}{list(w) if w else ''} "
                              f"dsched={spol}:{win}"
                              + (f":cap{cap}" if cap else "")
                              + (f" retry={fc.max_replays}"
                                 f"/bo{fc.backoff_clocks}" if fc else ""),
                              p99, mk))
                # constrained order: feasible beats infeasible; within
                # feasible minimize makespan, within infeasible drops
                # dominate (a drop is an unserved request), then p99
                key = (0, mk, p99) if feasible else (1, drops, p99, mk)
                if best is None or key < best[0]:
                    best = (key, cfg, apol, w, p99, mk, feasible, drops)
    assert best is not None
    _, cfg, apol, w, p99, mk, feasible, drops = best
    return ServingTuneResult(
        config=cfg, arb_policy=apol, weights=w,
        slo_p99_cycles=p99, makespan_cycles=mk,
        feasible=feasible and slo_p99_cycles is not None,
        candidates_evaluated=n_eval, table=table, n_dropped=drops)
