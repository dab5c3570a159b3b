"""Public sorted-gather op: schedule (sort) → gather → unsort.

``sorted_gather(table, idx)`` is value-identical to ``table[idx]``. The
request stream is stable-sorted by row id (the scheduler), the row gather
streams rows in sorted order, and the inverse permutation restores
arrival order (the Fig. 2 read-pointer writeback). Counterpart of
``repro.kernels.sorted_gather.ops``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.bitonic_sort import ops as bitonic_ops
from repro_torch.kernels.sorted_gather.kernel import gather_rows


def sorted_gather(table: torch.Tensor, indices: torch.Tensor,
                  *, use_bitonic: bool = False) -> torch.Tensor:
    idx = indices.reshape(-1)
    if use_bitonic:
        sorted_idx, perm = bitonic_ops.sort_with_indices(idx)
    else:
        sorted_idx, perm = torch.sort(idx, stable=True)
    gathered = gather_rows(table, sorted_idx)
    out = gathered.index_select(0, bitonic_ops.inverse_permutation(perm))
    return out.reshape(*indices.shape, table.shape[-1])
