"""Memory scheduler — batch formation and the stable request sort (paper Fig. 2).

Counterpart of the reference's ``repro.core.scheduler``, in two planes:

* **Control plane** (``form_batches``, ``form_batches_typed``,
  ``schedule_trace(_rw)``) — host-side trace segmentation with the
  timeout/full/type-change rules and the per-batch row sort, in numpy,
  copied expression for expression; the serving driver's admission
  (``repro_torch.launch.serve``) and the modeled-timing pipeline run it.
  Boundaries are planned vectorized (one python iteration per emitted
  batch); the request-at-a-time walks ``form_batches_seq``,
  ``form_batches_typed_seq`` and ``schedule_trace_rw_seq`` are kept as
  the oracles.
* **Data plane** (``sort_requests``) — the stable key sort on the device,
  through the bitonic network kernel (B1).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Sequence

import numpy as np
import torch

from repro_torch.core.config import SchedulerConfig
from repro_torch.core.timing import DRAMTimings, DDR4_2400
from repro_torch.kernels.bitonic_sort import ops as bitonic_ops


READ = 0
WRITE = 1


@dataclasses.dataclass
class RequestBatch:
    """Struct-of-arrays FLIT batch (paper's PE->controller interface).

    Fields mirror the FLIT header: originating PE, access type, address,
    payload size; ``seq`` is the arrival stamp (the input-buffer read-pointer
    value in Fig. 2) used to keep the sort stable and to unsort responses.
    """

    pe_id: np.ndarray
    rw: int                      # READ or WRITE — one type per batch
    addr: np.ndarray
    size: np.ndarray
    seq: np.ndarray

    def __len__(self) -> int:
        return int(self.addr.shape[0])


def _normalize_trace(addrs, rw, arrival_cycle, pe_id, sizes):
    """Shared input conditioning for both batch formers.

    ``arrival_cycle=None`` means the saturated-traffic regime — many PEs
    issue in parallel, the input queue never starves, so the timeout
    never fires (the Fig. 9 benchmarking condition). Pass explicit
    arrival cycles to model low-traffic behaviour.
    """
    addrs = np.asarray(addrs, dtype=np.int64)
    rw_arr = np.asarray(rw, dtype=np.int32)
    n = addrs.shape[0]
    if arrival_cycle is None:
        arrival_cycle = np.zeros(n, dtype=np.int64)
    else:
        arrival_cycle = np.asarray(arrival_cycle, dtype=np.int64)
    if pe_id is None:
        pe_id = np.zeros(n, dtype=np.int32)
    else:
        pe_id = np.asarray(pe_id, dtype=np.int32)
    if sizes is None:
        sizes = np.full(n, 1, dtype=np.int32)
    else:
        sizes = np.asarray(sizes, dtype=np.int32)
    return addrs, rw_arr, arrival_cycle, pe_id, sizes


def form_batches_seq(
    addrs: Sequence[int],
    rw: Sequence[int],
    arrival_cycle: Sequence[int] | None = None,
    pe_id: Sequence[int] | None = None,
    sizes: Sequence[int] | None = None,
    *,
    config: SchedulerConfig,
) -> Iterator[RequestBatch]:
    """Reference implementation of :func:`form_batches` — one python
    iteration per request. Kept as the oracle the vectorized boundary
    planner is property-tested against."""
    addrs, rw_arr, arrival_cycle, pe_id, sizes = _normalize_trace(
        addrs, rw, arrival_cycle, pe_id, sizes)
    n = addrs.shape[0]

    start = 0
    for i in range(1, n + 1):
        close = False
        if i == n:
            close = True
        else:
            full = (i - start) >= config.batch_size
            timed_out = (arrival_cycle[i] - arrival_cycle[start]
                         ) > config.timeout_cycles
            type_flip = rw_arr[i] != rw_arr[start]
            close = full or timed_out or type_flip
        if close:
            yield RequestBatch(
                pe_id=pe_id[start:i],
                rw=int(rw_arr[start]),
                addr=addrs[start:i],
                size=sizes[start:i],
                seq=np.arange(start, i, dtype=np.int64),
            )
            start = i
            if start == n:
                break


def _first_timeout(arrival: np.ndarray, lo: int, hi: int,
                   head_cycle: int, timeout: int) -> int | None:
    """First global step ``i`` in ``(lo, hi]`` whose arrival exceeds
    ``head_cycle + timeout``, or None. Uses a restart running-max so the
    probe is a single searchsorted even on non-monotone arrival streams
    (``arrival[i] > thr`` first holds exactly where ``cummax > thr``)."""
    win = arrival[lo + 1:hi + 1]
    if not win.size:
        return None
    cm = np.maximum.accumulate(win)
    pos = int(np.searchsorted(cm, head_cycle + timeout, side="right"))
    return lo + 1 + pos if pos < win.size else None


def _single_queue_bounds(rw_arr: np.ndarray, arrival: np.ndarray,
                         config: SchedulerConfig) -> list[tuple[int, int]]:
    """Batch boundary plan for the single-queue former.

    Type flips are fixed closing points (every request in a batch shares
    ``rw[start]``, so a flip vs the start is a flip vs the predecessor):
    segment the trace at ``diff(rw) != 0``, then walk each segment one
    *batch* at a time — the close point is the earlier of the size rule
    (``start + batch_size``) and the first timeout inside that span.
    """
    n = rw_arr.shape[0]
    seg_edges = np.concatenate(
        [[0], np.flatnonzero(np.diff(rw_arr) != 0) + 1, [n]])
    # Saturated-traffic regime (constant arrival cycles — the default):
    # gaps are all zero, the timeout can never fire, and boundaries are
    # pure arithmetic.
    timeouts_possible = n > 0 and bool((arrival != arrival[0]).any())
    bounds: list[tuple[int, int]] = []
    for a, b in zip(seg_edges[:-1], seg_edges[1:]):
        s = int(a)
        while s < b:
            e = min(s + config.batch_size, int(b))
            if timeouts_possible:
                t = _first_timeout(arrival, s, e - 1, int(arrival[s]),
                                   config.timeout_cycles)
                if t is not None:
                    e = t
            bounds.append((s, e))
            s = e
    return bounds


def form_batches(
    addrs: Sequence[int],
    rw: Sequence[int],
    arrival_cycle: Sequence[int] | None = None,
    pe_id: Sequence[int] | None = None,
    sizes: Sequence[int] | None = None,
    *,
    config: SchedulerConfig,
) -> Iterator[RequestBatch]:
    """Segment a request trace into scheduler batches.

    A batch closes when (a) it reaches ``config.batch_size`` requests,
    (b) the gap since the batch's first request exceeds
    ``config.timeout_cycles`` (deadlock avoidance under low traffic), or
    (c) the request type flips read<->write (single-type batches).

    Boundaries are planned vectorized (one python iteration per *batch*);
    identical output to :func:`form_batches_seq`.
    """
    addrs, rw_arr, arrival_cycle, pe_id, sizes = _normalize_trace(
        addrs, rw, arrival_cycle, pe_id, sizes)
    for s, e in _single_queue_bounds(rw_arr, arrival_cycle, config):
        yield RequestBatch(
            pe_id=pe_id[s:e],
            rw=int(rw_arr[s]),
            addr=addrs[s:e],
            size=sizes[s:e],
            seq=np.arange(s, e, dtype=np.int64),
        )


def form_batches_typed_seq(
    addrs: Sequence[int],
    rw: Sequence[int],
    arrival_cycle: Sequence[int] | None = None,
    pe_id: Sequence[int] | None = None,
    sizes: Sequence[int] | None = None,
    *,
    config: SchedulerConfig,
) -> Iterator[RequestBatch]:
    """Reference implementation of :func:`form_batches_typed` — one python
    iteration (and queue append) per request. Kept as the oracle the
    vectorized planner is property-tested against.

    The FPGA's double-buffered input queues let reads and writes
    accumulate *concurrently*; a read↔write flip in the arrival stream
    parks the request in the other queue instead of closing the current
    batch. On mixed streams this yields full-size single-type batches —
    the property that amortizes both the sort (Eq. 1) and the bus
    turnaround (tWTR/tRTW) — where the single-queue ``form_batches``
    degenerates to tiny batches.

    Consistency: same-address same-type order is preserved (stable queues);
    a read is *not* ordered against a concurrent write to the same address
    — exactly the paper's weak consistency model. Request streams that
    need read-after-write ordering must fence (close batches) between the
    write and the read.
    """
    addrs, rw_arr, arrival_cycle, pe_id, sizes = _normalize_trace(
        addrs, rw, arrival_cycle, pe_id, sizes)
    n = addrs.shape[0]

    queues: dict[int, list[int]] = {READ: [], WRITE: []}

    def emit(t: int) -> RequestBatch:
        q = queues[t]
        batch = RequestBatch(
            pe_id=pe_id[q], rw=t, addr=addrs[q], size=sizes[q],
            seq=np.asarray(q, dtype=np.int64))
        queues[t] = []
        return batch

    for i in range(n):
        t = int(rw_arr[i])
        for qt in (READ, WRITE):
            q = queues[qt]
            if q and (arrival_cycle[i] - arrival_cycle[q[0]]
                      ) > config.timeout_cycles:
                yield emit(qt)
        queues[t].append(i)
        if len(queues[t]) >= config.batch_size:
            yield emit(t)
    # Flush partials, oldest queue first (FIFO drain at end of trace).
    rest = [t for t in (READ, WRITE) if queues[t]]
    for t in sorted(rest, key=lambda t: queues[t][0]):
        yield emit(t)


def _typed_batch_plan(rw_arr: np.ndarray, arrival: np.ndarray,
                      config: SchedulerConfig):
    """Emission plan for the dual-queue former, one python iteration per
    *batch*.

    The two queues never interact (each emits based only on its own head
    and the global arrival stream), so each type's batch boundaries are
    walked independently over that type's request positions; emissions
    are then merged by event key ``(global_step, phase, tiebreak)`` —
    a timeout fires *before* the arriving request is appended (phase 0,
    READ queue checked first), a size-full batch emits right after the
    append (phase 1), and end-of-trace flushes drain oldest head first
    (phase 2).
    """
    n = rw_arr.shape[0]
    B, T = config.batch_size, config.timeout_cycles
    timeouts_possible = n > 0 and bool((arrival != arrival[0]).any())
    events: list[tuple[tuple[int, int, int], int, np.ndarray]] = []
    for t_order, t in enumerate((READ, WRITE)):
        idxs = np.flatnonzero(rw_arr == t)
        m = idxs.shape[0]
        p = 0
        while p < m:
            h = int(idxs[p])
            size_p = p + B - 1
            limit = int(idxs[size_p]) if size_p < m else n - 1
            t_out = _first_timeout(arrival, h, limit, int(arrival[h]), T) \
                if timeouts_possible else None
            if t_out is not None:
                q = int(np.searchsorted(idxs, t_out, side="left"))
                events.append(((t_out, 0, t_order), t, idxs[p:q]))
                p = q
            elif size_p < m:
                events.append(((limit, 1, t_order), t, idxs[p:p + B]))
                p = p + B
            else:
                events.append(((n, 2, h), t, idxs[p:]))
                p = m
    events.sort(key=lambda e: e[0])
    return events


def form_batches_typed(
    addrs: Sequence[int],
    rw: Sequence[int],
    arrival_cycle: Sequence[int] | None = None,
    pe_id: Sequence[int] | None = None,
    sizes: Sequence[int] | None = None,
    *,
    config: SchedulerConfig,
) -> Iterator[RequestBatch]:
    """Dual-queue batch formation: one pending batch per request type.

    The FPGA's double-buffered input queues let reads and writes
    accumulate *concurrently*; a read↔write flip in the arrival stream
    parks the request in the other queue instead of closing the current
    batch. On mixed streams this yields full-size single-type batches —
    the property that amortizes both the sort (Eq. 1) and the bus
    turnaround (tWTR/tRTW) — where the single-queue ``form_batches``
    degenerates to tiny batches.

    Consistency: same-address same-type order is preserved (stable queues);
    a read is *not* ordered against a concurrent write to the same address
    — exactly the paper's weak consistency model. Request streams that
    need read-after-write ordering must fence (close batches) between the
    write and the read.

    Batch membership is planned vectorized (one python iteration per
    batch, see :func:`_typed_batch_plan`); identical output to
    :func:`form_batches_typed_seq`.
    """
    addrs, rw_arr, arrival_cycle, pe_id, sizes = _normalize_trace(
        addrs, rw, arrival_cycle, pe_id, sizes)
    for _key, t, q in _typed_batch_plan(rw_arr, arrival_cycle, config):
        yield RequestBatch(pe_id=pe_id[q], rw=t, addr=addrs[q],
                           size=sizes[q], seq=q.astype(np.int64))


def count_batches(
    rw: Sequence[int],
    arrival_cycle: Sequence[int] | None = None,
    *,
    config: SchedulerConfig,
) -> int:
    """Number of batches the dual-queue former emits for a trace — the
    per-batch Eq. 1 charge count of the pipeline's overlap model. Uses
    the same boundary plan as :func:`form_batches_typed`, so on a
    saturated all-read trace it reduces to ``ceil(n / batch_size)``."""
    if not config.enabled:
        return 0
    rw_arr = np.asarray(rw, dtype=np.int32).ravel()
    n = rw_arr.shape[0]
    if arrival_cycle is None:
        arrival = np.zeros(n, dtype=np.int64)
    else:
        arrival = np.asarray(arrival_cycle, dtype=np.int64)
    return len(_typed_batch_plan(rw_arr, arrival, config))


def reorder_batch(
    batch: RequestBatch, timings: DRAMTimings = DDR4_2400
) -> RequestBatch:
    """Stable-sort one batch by DRAM row index (the Bitonic network's job).

    Stable ⇒ equal rows (and in particular equal addresses) keep arrival
    order, satisfying the scheduler consistency rule.
    """
    rows = timings.row_of(batch.addr)
    perm = np.argsort(rows, kind="stable")
    return RequestBatch(
        pe_id=batch.pe_id[perm],
        rw=batch.rw,
        addr=batch.addr[perm],
        size=batch.size[perm],
        seq=batch.seq[perm],
    )


def schedule_trace(
    addrs: Sequence[int],
    rw: Sequence[int],
    *,
    config: SchedulerConfig,
    timings: DRAMTimings = DDR4_2400,
    arrival_cycle: Sequence[int] | None = None,
) -> np.ndarray:
    """Run the full control plane over a trace; return the reordered
    address stream as seen by the DRAM (used by the Fig. 7/9 benchmarks)."""
    return schedule_trace_rw(addrs, rw, config=config, timings=timings,
                             arrival_cycle=arrival_cycle)[0]


def schedule_trace_rw_seq(
    addrs: Sequence[int],
    rw: Sequence[int],
    *,
    config: SchedulerConfig,
    timings: DRAMTimings = DDR4_2400,
    arrival_cycle: Sequence[int] | None = None,
    coalesce_writes: bool = False,
) -> tuple[np.ndarray, np.ndarray]:
    """Reference implementation of :func:`schedule_trace_rw` — a python
    loop over batches, one ``argsort`` each. Kept as the seed path for
    old-vs-new benchmarking and as the property-test oracle."""
    if not config.enabled:
        return (np.asarray(addrs, dtype=np.int64),
                np.asarray(rw, dtype=np.int32))
    out, out_rw = [], []
    for batch in form_batches_typed_seq(addrs, rw, arrival_cycle,
                                        config=config):
        if config.bypass_sequential and _is_sequential(batch.addr, timings):
            srv = batch.addr                # bypass path (paper §V-C)
        else:
            srv = reorder_batch(batch, timings).addr
        if coalesce_writes and batch.rw == WRITE and srv.shape[0] > 1:
            keep = np.ones(srv.shape[0], dtype=bool)
            keep[1:] = srv[1:] != srv[:-1]
            srv = srv[keep]
        out.append(srv)
        out_rw.append(np.full(srv.shape[0], batch.rw, dtype=np.int32))
    if not out:
        return np.empty(0, dtype=np.int64), np.empty(0, dtype=np.int32)
    return np.concatenate(out), np.concatenate(out_rw)


def schedule_trace_rw(
    addrs: Sequence[int],
    rw: Sequence[int],
    *,
    config: SchedulerConfig,
    timings: DRAMTimings = DDR4_2400,
    arrival_cycle: Sequence[int] | None = None,
    coalesce_writes: bool = False,
) -> tuple[np.ndarray, np.ndarray]:
    """Like :func:`schedule_trace` but also returns the serviced rw stream.

    Uses the dual-queue (typed) batch former, so an interleaved
    read/write stream still yields full-size single-type batches; the
    scheduled stream then changes bus direction at most once per batch
    boundary — feed the pair into
    ``timing.simulate_dram_access(addrs, rw=rw)`` to charge the tWTR/tRTW
    turnarounds the batching amortizes (mixed read/write workloads,
    Fig. 7-write methodology).

    ``coalesce_writes`` additionally models the sorted_scatter kernel's
    VMEM coalescing: within each WRITE batch, adjacent duplicate rows
    collapse to one HBM burst (last-writer-wins / accumulated add).
    Coalescing never crosses a batch boundary — each batch is a separate
    kernel invocation with its own flush.

    The whole data plane is one vectorized pass: a single stable
    ``lexsort`` on ``(batch, row, arrival)`` row-sorts every batch at
    once (a batch that is already row-sorted — the §V-C bypass case — is
    left untouched by a stable sort, so the bypass needs no separate
    branch), and coalescing is one shifted comparison. Output is
    identical to :func:`schedule_trace_rw_seq`.
    """
    if not config.enabled:
        return (np.asarray(addrs, dtype=np.int64),
                np.asarray(rw, dtype=np.int32))
    addrs64, rw_arr, arr_cyc, _, _ = _normalize_trace(
        addrs, rw, arrival_cycle, None, None)
    events = _typed_batch_plan(rw_arr, arr_cyc, config)
    if not events:
        return np.empty(0, dtype=np.int64), np.empty(0, dtype=np.int32)
    lens = np.fromiter((e[2].shape[0] for e in events), np.int64,
                       len(events))
    idx_cat = np.concatenate([e[2] for e in events])
    batch_id = np.repeat(np.arange(lens.shape[0]), lens)
    a = addrs64[idx_cat]
    rows = timings.row_of(a)
    # One stable sort on a fused (batch, row) key when the row range is
    # non-negative and fits in int64 (~2x faster than a 2-key lexsort);
    # stability keeps arrival order within equal rows — the
    # weak-consistency rule. Negative rows (negative addresses) fall back
    # to lexsort so batch keys can never overlap.
    row_span = int(rows.max()) + 1 if rows.size else 1
    if rows.size and int(rows.min()) >= 0 \
            and row_span < (1 << 62) // (lens.shape[0] + 1):
        perm = np.argsort(batch_id * row_span + rows, kind="stable")
    else:
        perm = np.lexsort((np.arange(a.shape[0]), rows, batch_id))
    srv = a[perm]
    srv_rw = np.repeat(
        np.fromiter((e[1] for e in events), np.int32, len(events)), lens)
    if coalesce_writes:
        keep = np.ones(srv.shape[0], bool)
        keep[1:] = ((srv[1:] != srv[:-1])
                    | (batch_id[1:] != batch_id[:-1])
                    | (srv_rw[1:] != WRITE))
        srv, srv_rw = srv[keep], srv_rw[keep]
    return srv, srv_rw


def _is_sequential(addr: np.ndarray, timings: DRAMTimings) -> bool:
    if addr.shape[0] < 2:
        return True
    rows = timings.row_of(addr)
    return bool(np.all(np.diff(rows) >= 0))



# ---------------------------------------------------------------------------
# Data plane — the stable sort on the device
# ---------------------------------------------------------------------------

def sort_requests(keys: torch.Tensor, *, use_kernels: bool = True):
    """Return (sorted_keys, perm, inv_perm) with a *stable* sort along the
    last axis (1-D, or one scheduler batch per row of a 2-D tensor).

    ``perm`` gathers request payloads into service order; ``inv_perm``
    unsorts responses back to arrival order (the read-pointer writeback in
    Fig. 2); both are int32. With ``use_kernels`` the bitonic network
    kernel runs the sort (its plain version on a CPU tensor); otherwise
    ``torch.sort(stable=True)`` does — identical semantics.
    """
    if use_kernels:
        sorted_keys, perm = bitonic_ops.sort_with_indices(keys)
    else:
        sorted_keys, perm = torch.sort(keys, stable=True)
        perm = perm.to(torch.int32)
    return sorted_keys, perm, bitonic_ops.inverse_permutation(perm)
