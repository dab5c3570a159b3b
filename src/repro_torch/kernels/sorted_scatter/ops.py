"""Public sorted-scatter op: schedule (sort) → coalesce → scatter.

``sorted_scatter(table, idx, vals)`` is value-identical to the sequential
write stream ``for i: table[idx[i]] = vals[i]`` (``mode="set"``, last
writer wins) or ``table[idx[i]] += vals[i]`` (``mode="add"``, gradient
accumulation in promoted precision). The request stream is stable-sorted
by row id (the scheduler's WRITE batch reorder) and each run of equal rows
is written once. No unsort step is needed on the write path: writes
return no payload, so arrival order only matters *per address*, which the
stable sort preserves. Counterpart of ``repro.kernels.sorted_scatter.ops``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.bitonic_sort import ops as bitonic_ops
# A module reference, not its names: kernel.py imports repro_torch.core,
# whose controller imports this module while kernel.py is still loading.
from repro_torch.kernels.sorted_scatter import kernel as ss_kernel


def sorted_scatter(table: torch.Tensor, indices: torch.Tensor,
                   values: torch.Tensor, *, mode: str = "set",
                   use_bitonic: bool = False,
                   backend: str = "kernel") -> torch.Tensor:
    """One sort-and-coalesce pipeline for both data planes: the kernel
    (``backend="kernel"``; its plain version on a CPU tensor) and the
    plain-torch path (``backend="torch"``, last-of-run rows via
    ``masked_row_set``) the controller takes with kernels off. Returns a
    new table; ``table`` is not changed. ``set`` values are cast to the
    table's dtype; ``add`` values keep theirs and are cast to the
    accumulator ``promote_types(float32, table.dtype)`` inside the fold,
    as the reference's ``astype`` does, so a float32 gradient is not
    rounded to a bf16 table's dtype before it is summed."""
    if mode not in ("set", "add"):
        raise ValueError(f"mode must be 'set' or 'add', got {mode!r}")
    if backend not in ("kernel", "torch"):
        raise ValueError(f"backend must be 'kernel' or 'torch', got "
                         f"{backend!r}")
    idx = indices.reshape(-1)
    vals = values.reshape(idx.shape[0], table.shape[-1])
    if use_bitonic:
        sidx, perm = bitonic_ops.sort_with_indices(idx)
    else:
        sidx, perm = torch.sort(idx, stable=True)
    svals = vals.index_select(0, perm)
    if mode == "set":
        svals = svals.to(table.dtype)
    if backend == "kernel":
        return ss_kernel.scatter_rows(table, sidx, svals, mode=mode)
    return ss_kernel.scatter_rows_plain(table, sidx, svals, mode=mode)
