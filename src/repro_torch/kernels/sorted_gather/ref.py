"""Plain-torch oracle for sorted_gather: plain row gather."""

import torch


def gather_ref(table: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    return table[indices.long()]
