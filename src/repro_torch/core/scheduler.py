"""Memory scheduler — batch formation and the stable request sort (paper Fig. 2).

Counterpart of ``repro.core.scheduler`` for two of its parts:

* **Control plane** (``form_batches``) — host-side trace segmentation with
  the timeout/full/type-change rules, in numpy; the serving driver's
  admission (``repro_torch.launch.serve``) runs it. Boundaries are planned
  vectorized (one python iteration per emitted batch); the
  request-at-a-time walk ``form_batches_seq`` is kept as the oracle. The
  typed (per-type queue) former and ``schedule_trace*`` come with the
  simulator slice.
* **Data plane** (``sort_requests``) — the stable key sort on the device,
  through the bitonic network kernel (B1).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Sequence

import numpy as np
import torch

from repro_torch.core.config import SchedulerConfig
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
