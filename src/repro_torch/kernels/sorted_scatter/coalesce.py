"""Run-coalescing for sorted write batches, plain torch (the ``add`` half of
the sorted-scatter kernel's plain version; the CUDA kernel fuses the same
fold). Counterpart of ``repro.kernels.sorted_scatter.coalesce``.
"""

from __future__ import annotations

import torch


def coalesce_add_runs(table: torch.Tensor, sidx: torch.Tensor,
                      svals: torch.Tensor) -> torch.Tensor:
    """Fold each equal-index run of a *sorted* write batch for ``add``.

    Returns per-slot values ``table[row] + Σ(run values)``, so flushing
    any one slot of a run — in particular the last one — accumulates
    exactly like the in-order stream. Sums are taken *per run* (a segment
    sum over the runs' lengths) in at least float32 — float64 tables
    accumulate in float64 — with no global prefix accumulation, so a short
    run's sum stays accurate in million-row batches. Each run is summed in
    slot order, without atomics, so a call gives the same bits every time,
    on the CPU and on CUDA (``index_add_`` on CUDA adds duplicates with
    atomics, in an order that changes from call to call).
    """
    acc = torch.promote_types(torch.float32, table.dtype)
    if sidx.numel() == 0:
        return svals.to(table.dtype)
    _, run_of, lengths = torch.unique_consecutive(
        sidx, return_inverse=True, return_counts=True)
    totals = torch.segment_reduce(svals.to(acc), "sum", lengths=lengths)
    run_sum = totals.index_select(0, run_of)
    # The base-row add also happens in the accumulator dtype — rounding
    # to the table dtype exactly once, same as the unscheduled reference.
    return (table.index_select(0, sidx).to(acc) + run_sum).to(table.dtype)
