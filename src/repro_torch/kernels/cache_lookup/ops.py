"""Public cached-gather op composing the tag/LRU kernel with the data path.

``cache_service(table, line_ids, state)``: probe all requests through the
cache pipeline, serve hits from the Data RAM, fill misses from ``table``
(the device-memory side), and return data in arrival order + updated state
— value semantics identical to ``table[line_ids]``. Counterpart of
``repro.kernels.cache_lookup.ops``.

Read-only service: like ``cache_engine.lookup`` it has no write-back
port, so states carrying dirty lines must be flushed before entering
(mixed read/write traces belong to ``cache_engine.simulate_trace_rw``).
"""

from __future__ import annotations

import torch

from repro_torch.core.cache_engine import CacheState
from repro_torch.kernels.cache_lookup.kernel import cache_probe
from repro_torch.kernels.sorted_scatter import ops as ss_ops


def cache_service(table: torch.Tensor, line_ids: torch.Tensor,
                  state: CacheState):
    """Returns (lines (N, d), hits (N,) bool, new_state); ``state`` is not
    changed. A line id outside ``table`` raises ``ValueError``."""
    hits, ways, tags, valid, age, clock = cache_probe(
        line_ids, state.tags, state.valid.to(torch.int32), state.age,
        state.clock, limit=min(table.shape[0], 1 << 31))
    sets, n_ways = state.tags.shape

    # Data path. The kernel fixed the (set, way) placement of every beat; a
    # hit's Data RAM copy is the same line (tags matched), so serving
    # ``table[line]`` is value-identical, and the Data RAM update is a
    # scatter of table rows. Several beats of one batch can land on one
    # (set, way); the last must win, deterministically: the scheduler's
    # ``set`` scatter keeps arrival order within a run of equal slots.
    lines = table.index_select(0, line_ids)
    slot = (line_ids % sets) * n_ways + ways
    data = ss_ops.sorted_scatter(
        state.data.reshape(sets * n_ways, -1), slot, lines).reshape(
            state.data.shape)
    # A fill installs a clean line; a hit keeps the way's dirty bit.
    dirty_flat = state.dirty.reshape(-1, 1)
    dirty = ss_ops.sorted_scatter(
        dirty_flat, slot,
        dirty_flat.index_select(0, slot) & (hits != 0)[:, None]).reshape(
            state.dirty.shape)
    new_state = CacheState(tags=tags, valid=valid != 0, age=age, data=data,
                           clock=clock.reshape(()), dirty=dirty)
    return lines, hits != 0, new_state
