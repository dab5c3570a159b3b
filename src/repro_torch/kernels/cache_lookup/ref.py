"""Oracle for the cache-probe kernel: the functional cache engine.

``repro_torch.core.cache_engine.lookup`` is replayed beat for beat; the
touched way is recovered as the way whose age equals the new clock stamp.
Counterpart of ``repro.kernels.cache_lookup.ref``.
"""

from __future__ import annotations

import torch

from repro_torch.core.cache_engine import CacheState, lookup


def cache_probe_ref(line_ids, tags, valid, age, clock):
    """Replay the kernel's contract through the core cache engine.

    Returns (hits, ways, tags', valid', age', clock') matching
    ``kernel.cache_probe``.
    """
    dev = tags.device
    state = CacheState(tags=tags, valid=valid != 0, age=age,
                       data=torch.zeros((*tags.shape, 1), device=dev),
                       clock=clock.reshape(()).clone(),
                       dirty=torch.zeros(tags.shape, dtype=torch.bool,
                                         device=dev))
    hits, ways = [], []
    fill = torch.zeros(1, device=dev)
    for lid in line_ids.tolist():
        state, hit, _ = lookup(state, lid, fill)
        set_idx = lid % tags.shape[0]
        hits.append(int(hit))
        ways.append(int((state.age[set_idx] == state.clock).to(
            torch.uint8).argmax()))
    as_i32 = dict(dtype=torch.int32, device=dev)
    return (torch.tensor(hits, **as_i32), torch.tensor(ways, **as_i32),
            state.tags, state.valid.to(torch.int32), state.age,
            state.clock.reshape(1))
