"""Plain-torch oracle for the bitonic sort kernel: a stable key sort."""

import torch


def sort_with_indices_ref(keys: torch.Tensor, vals: torch.Tensor):
    """Row-wise stable sort; returns (sorted_keys, perm, sorted_vals)."""
    sorted_keys, perm = torch.sort(keys, dim=-1, stable=True)
    sorted_vals = torch.take_along_dim(vals, perm, dim=-1)
    return sorted_keys, perm.to(torch.int32), sorted_vals
