"""Masked row-scatter via a sacrificial padding row.

Masked-out slots are routed to a padding row appended to the table, the
scatter runs, and the pad is sliced off. ``index_put_`` with duplicate
targets leaves the winner undefined, so the result is deterministic only
because the *kept* rows are unique — every caller guarantees that
(last-of-run or winner-stamp dedup) — and duplicates land on the pad row
alone.
"""

from __future__ import annotations

import torch


def masked_row_set(table: torch.Tensor, rows: torch.Tensor,
                   vals: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """Return a copy of ``table`` with ``vals[i]`` written to
    ``table[rows[i]]`` where ``keep[i]``; slots with ``keep[i] == False``
    land on the padding row and are discarded. ``rows`` entries where
    ``keep`` holds must be unique and in range."""
    n_rows = table.shape[0]
    safe = torch.where(keep, rows.long(), n_rows)
    padded = torch.cat([table, table.new_zeros((1, table.shape[-1]))])
    padded.index_put_((safe,), vals.to(table.dtype))
    return padded[:n_rows]
