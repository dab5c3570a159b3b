"""Sorted-scatter — the scheduler's write-side locality payoff.

``scatter_rows(table, sorted_idx, values, mode=...)`` writes a stably
sorted WRITE batch into a copy of ``table``: each run of equal indices
lands once, as its last value (``"set"``, the last writer wins) or as
``table[row] + Σrun`` accumulated in at least float32 and rounded once
(``"add"``; the values may have another dtype than the table). On a CUDA
tensor it launches the kernel of ``csrc/sorted_scatter.cu``; on a CPU
tensor it runs
``scatter_rows_plain`` (last-of-run mask + ``masked_row_set``, with
``coalesce_add_runs`` for ``"add"``). Counterpart of
``repro.kernels.sorted_scatter.kernel`` plus ``coalesce``.
"""

from __future__ import annotations

import torch

from repro_torch.core.scatter_util import masked_row_set
from repro_torch.kernels._build import I32, I64, P, CudaLibrary
from repro_torch.kernels.sorted_gather.kernel import check_row_indices
from repro_torch.kernels.sorted_scatter.coalesce import coalesce_add_runs

LIB = CudaLibrary("sorted_scatter", {
    "scatter_set_rows": (P, P, P, I64, I64, P),
    "scatter_add_runs": (P, P, P, I64, I64, I32, I32, P),
})
# Type codes of the add kernel, for the table and for the values: the
# (table, values) pairs the reference takes.
ADD_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
              torch.float64: 3, torch.int32: 4}
_ADD_BLOCK_COLS = 1024   # columns per block of the add kernel


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
    if table.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {table.device}")
    check_row_indices(sorted_idx, table.shape[0])
    if n > 1 and bool((sorted_idx[1:] < sorted_idx[:-1]).any()):
        raise ValueError("indices must be sorted")
    if table.device.type == "cpu":
        return scatter_rows_plain(table, sorted_idx, values, mode=mode)
    if n >= 1 << 31 or -(-d // _ADD_BLOCK_COLS) >= 1 << 16:
        raise ValueError(f"({n}, {d}) writes exceed the kernel's grid")
    out = table.clone()
    if n == 0:
        return out
    idx32 = sorted_idx.to(torch.int32).contiguous()
    stream = torch.cuda.current_stream(table.device).cuda_stream
    if mode == "set":
        LIB.launch("scatter_set_rows", out.data_ptr(), idx32.data_ptr(),
                   values.data_ptr(), n, d * table.element_size(), stream)
    else:
        LIB.launch("scatter_add_runs", out.data_ptr(), idx32.data_ptr(),
                   values.data_ptr(), n, d, ADD_DTYPES[table.dtype],
                   ADD_DTYPES[values.dtype], stream)
    return out
