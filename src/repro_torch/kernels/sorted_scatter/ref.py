"""Oracles for sorted_scatter: sequential write-stream semantics."""

import torch


def scatter_ref(table: torch.Tensor, indices: torch.Tensor,
                values: torch.Tensor, mode: str = "set") -> torch.Tensor:
    """In-order write stream (the naive un-scheduled controller): writes
    land one at a time, so duplicates resolve to the last arrival for
    ``set`` and accumulate for ``add`` — in promoted (≥f32) precision
    with a single final round."""
    idx = indices.reshape(-1).tolist()
    vals = values.reshape(len(idx), table.shape[-1])
    if mode == "add":
        acc = torch.promote_types(torch.float32, table.dtype)
        out = table.to(acc, copy=True)
        for i, row in enumerate(idx):
            out[row] += vals[i].to(acc)
        return out.to(table.dtype)
    out = table.clone()
    for i, row in enumerate(idx):
        out[row] = vals[i]
    return out
