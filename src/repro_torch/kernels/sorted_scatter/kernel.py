"""Sorted-scatter — the scheduler's write-side locality payoff.

``scatter_rows(table, sorted_idx, values, mode=...)`` writes a stably
sorted WRITE batch into a copy of ``table``: each run of equal indices
lands once, as its last value (``"set"``, the last writer wins) or as
``table[row] + Σrun`` accumulated in at least float32 and rounded once
(``"add"``; the values may have another dtype than the table). On a CUDA
tensor it launches the kernels of ``csrc/sorted_scatter.cu``: a plan of
the batch's runs (``SpanPlan``; its range, order and counts read in one
host sync), then the writes — for ``"add"``, a run of at most ``SPAN``
slots in one pass, a longer one as spans of ``SPAN`` slots summed apart
and folded in span order. On a CPU tensor it runs ``scatter_rows_plain``
(last-of-run mask + ``masked_row_set``, with ``coalesce_add_runs`` for
``"add"``). Counterpart of ``repro.kernels.sorted_scatter.kernel`` plus
``coalesce``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.scatter_util import masked_row_set
from repro_torch.kernels._build import I32, I64, P, CudaLibrary
from repro_torch.kernels.sorted_gather.kernel import (check_index_kind,
                                                      check_row_indices)
from repro_torch.kernels.sorted_scatter.coalesce import coalesce_add_runs

LIB = CudaLibrary("sorted_scatter", {
    "scatter_plan": (P, I32, P, I64, I32) + (P,) * 9 + (I64, I64, P, P),
    "scatter_set_rows": (P, P, P, I64, I64, P),
    "scatter_add_runs": (P, P, I64, I32, I32, I32, P, P, P, I64, P, P, P, P,
                         I64, P, P, I64, P, P),
})
# Type codes of the add kernel, for the table and for the values: the
# (table, values) pairs the reference takes.
ADD_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
              torch.float64: 3, torch.int32: 4}
_ADD_BLOCK_COLS = 1024   # columns per block of the add kernels
# Slots of a span: an ``add`` run longer than this is summed as spans of
# this many slots, aligned to its first slot, each by its own blocks.
SPAN = 64


class SpanPlan(NamedTuple):
    """The runs of a sorted batch for ``add``, as int32 slot positions and
    table rows.

    Short run ``j`` (at most ``SPAN`` slots) is ``short_first[j] ..
    short_last[j]`` and writes row ``short_row[j]``. Long run ``m`` is
    ``long_first[m] .. long_last[m]`` and writes row ``long_row[m]``; its
    spans are ``long_span0[m]`` and the ``ceil(length / SPAN) - 1`` after
    it. Span ``k`` is ``span_first[k] .. span_last[k]``: ``SPAN`` slots
    from its run's first slot on, the run's last span fewer. Each list is
    in slot order."""
    short_first: torch.Tensor
    short_last: torch.Tensor
    short_row: torch.Tensor
    long_first: torch.Tensor
    long_last: torch.Tensor
    long_span0: torch.Tensor
    long_row: torch.Tensor
    span_first: torch.Tensor
    span_last: torch.Tensor


def plan_capacity(n: int) -> tuple[int, int]:
    """(long runs, spans) that a batch of ``n`` slots can hold at most:
    each long run has more than ``SPAN`` slots, and ``ceil(L / SPAN) <=
    floor(L / SPAN) + 1``, so spans number at most ``n // SPAN`` plus the
    long runs — under ``2n / SPAN``."""
    long_cap = n // (SPAN + 1)
    return long_cap, n // SPAN + long_cap


def span_plan_plain(sidx: torch.Tensor) -> SpanPlan:
    """The plan that ``scatter_plan_kernel`` writes, in plain torch."""
    span, n = SPAN, sidx.numel()
    s = sidx.long()
    pos = torch.arange(n, device=sidx.device)
    start = torch.ones(n, dtype=torch.bool, device=sidx.device)
    start[1:] = s[1:] != s[:-1]
    end = torch.ones_like(start)
    end[:-1] = start[1:]
    first = torch.cummax(torch.where(start, pos, 0), 0).values
    off = pos - first
    ahead = torch.zeros_like(start)       # slot i + span holds i's row
    ahead[:max(n - span, 0)] = s[span:] == s[:max(n - span, 0)]
    long_start = start & ahead
    span_start = (off % span == 0) & ((off > 0) | long_start)
    short_end = end & (off < span)
    long_run = torch.cumsum(long_start, 0) - 1
    spans_before = torch.cumsum(span_start, 0) - span_start.long()
    long_last = pos[end & (off >= span)]
    span_first = pos[span_start]
    lists = (first[short_end], pos[short_end], s[short_end],
             pos[long_start], long_last, spans_before[long_start],
             s[long_start], span_first,
             torch.minimum(span_first + span - 1,
                           long_last[long_run[span_start]]))
    return SpanPlan(*(t.to(torch.int32) for t in lists))


def last_of_run(sidx: torch.Tensor) -> torch.Tensor:
    """True at the last slot of each run of equal sorted indices."""
    keep = torch.ones_like(sidx, dtype=torch.bool)
    keep[:-1] = sidx[1:] != sidx[:-1]
    return keep


def scatter_rows_plain(table: torch.Tensor, sidx: torch.Tensor,
                       svals: torch.Tensor, *, mode: str = "set"):
    if mode == "add":
        svals = coalesce_add_runs(table, sidx, svals)
    return masked_row_set(table, sidx, svals, last_of_run(sidx))


def plan_on_card(sorted_idx: torch.Tensor, n_rows: int, *, runs: bool):
    """Launch the plan kernel on a CUDA index tensor and read its result in
    one host sync: the indices' range and order, their int32 copy and,
    with ``runs``, the ``SpanPlan`` of an ``add`` (else None). Raises
    ``ValueError`` for an index outside ``[0, n_rows)`` (as
    ``check_row_indices``) or unsorted indices."""
    idx = sorted_idx.contiguous()
    n, dev = idx.numel(), idx.device
    wide = idx.dtype == torch.int64
    idx32 = torch.empty(n, dtype=torch.int32, device=dev) if wide else idx
    stats = torch.empty(6, dtype=torch.int64, device=dev)
    long_cap, span_cap = plan_capacity(n)
    ptrs = [None] * len(SpanPlan._fields)
    if runs:
        caps = (n,) * 3 + (long_cap,) * 4 + (span_cap,) * 2
        lists = torch.empty(sum(caps), dtype=torch.int32,
                            device=dev).split(caps)
        ptrs = [t.data_ptr() for t in lists]
    LIB.launch("scatter_plan", idx.data_ptr(), int(wide),
               idx32.data_ptr() if wide else None, n, SPAN, *ptrs, long_cap,
               span_cap, stats.data_ptr(),
               torch.cuda.current_stream(dev).cuda_stream, count=False)
    lo, hi, unsorted, n_short, n_long, n_span = stats.tolist()
    if lo < 0 or hi >= n_rows:
        raise ValueError(f"row index range [{lo}, {hi}] outside "
                         f"[0, {n_rows})")
    if unsorted:
        raise ValueError("indices must be sorted")
    if not runs:
        return idx32, None
    counts = (n_short,) * 3 + (n_long,) * 4 + (n_span,) * 2
    return idx32, SpanPlan(*(t[:c] for t, c in zip(lists, counts)))


def scatter_rows(table: torch.Tensor, sorted_idx: torch.Tensor,
                 values: torch.Tensor, *, mode: str = "set") -> torch.Tensor:
    """Return ``table`` with the sorted write batch applied; ``table`` is
    not changed. On CUDA the table is cloned and the kernel writes into
    the clone in place.

    ``sorted_idx`` must be sorted (stably, so each run is in arrival
    order), 1-D and in ``[0, R)``; ``values`` is ``(n, d)``, of the
    table's dtype for ``"set"``. ``"add"`` takes float32, bf16, f16,
    float64 and int32 tables and values, in any pair: each value is cast
    to ``promote_types(float32, table.dtype)``, summed there and rounded
    once to the table's dtype. Anything else raises ``ValueError``.
    ``meta`` tensors (the dry run's) give the result's shape only.
    """
    if mode not in ("set", "add"):
        raise ValueError(f"mode must be 'set' or 'add', got {mode!r}")
    if table.ndim != 2 or not table.is_contiguous():
        raise ValueError("table must be a contiguous 2-D tensor")
    n, d = sorted_idx.shape[0], table.shape[1]
    if values.shape != (n, d) or not values.is_contiguous():
        raise ValueError(f"values must be contiguous ({n}, {d}), got "
                         f"{tuple(values.shape)}")
    if mode == "set" and values.dtype != table.dtype:
        raise ValueError(f"'set' values must be {table.dtype}, got "
                         f"{values.dtype}")
    if mode == "add" and not {table.dtype, values.dtype} <= ADD_DTYPES.keys():
        raise ValueError(f"'add' takes {sorted(map(str, ADD_DTYPES))} "
                         f"tables and values, got {table.dtype} and "
                         f"{values.dtype}")
    if not sorted_idx.device == values.device == table.device:
        raise ValueError("table, indices and values must share a device")
    if table.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"no kernel for device {table.device}")
    if table.device.type == "meta":
        # no ids to fold runs by: an index_add of the batch, whose shape
        # and traffic the dry run counts
        return table.index_add(0, sorted_idx, values.to(table.dtype))
    if table.device.type == "cpu":
        check_row_indices(sorted_idx, table.shape[0])
        if n > 1 and bool((sorted_idx[1:] < sorted_idx[:-1]).any()):
            raise ValueError("indices must be sorted")
        return scatter_rows_plain(table, sorted_idx, values, mode=mode)
    check_index_kind(sorted_idx)
    if n >= 1 << 31 or -(-d // _ADD_BLOCK_COLS) >= 1 << 16:
        raise ValueError(f"({n}, {d}) writes exceed the kernel's grid")
    if n == 0:
        return table.clone()
    idx32, plan = plan_on_card(sorted_idx, table.shape[0],
                               runs=mode == "add")
    out = table.clone()
    scatter_in_place(out, idx32, values, plan)
    return out


def scatter_in_place(out: torch.Tensor, idx32: torch.Tensor,
                     values: torch.Tensor, plan: SpanPlan | None) -> None:
    """The write kernels on the card, into ``out`` in place, for
    ``plan_on_card``'s int32 indices and plan (None: ``"set"``)."""
    n, d = values.shape
    stream = torch.cuda.current_stream(out.device).cuda_stream
    if plan is None:
        LIB.launch("scatter_set_rows", out.data_ptr(), idx32.data_ptr(),
                   values.data_ptr(), n, d * out.element_size(), stream)
        return
    acc = torch.promote_types(torch.float32, out.dtype)
    n_span = plan.span_first.numel()
    ws = torch.empty((n_span, d), dtype=acc, device=out.device)
    ptr = [t.data_ptr() for t in plan]
    LIB.launch("scatter_add_runs", out.data_ptr(), values.data_ptr(), d,
               ADD_DTYPES[out.dtype], ADD_DTYPES[values.dtype], SPAN,
               *ptr[:3], plan.short_first.numel(), *ptr[3:7],
               plan.long_first.numel(), *ptr[7:], n_span, ws.data_ptr(),
               stream)
