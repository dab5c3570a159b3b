"""Cache probe — the cache engine's tag/LRU pipeline (paper §IV-A, Fig. 3/4).

``cache_probe(line_ids, tags, valid, age, clock)`` runs a request batch
through the tag store in arrival order and returns (hits (N,), way (N,),
tags', valid', age', clock'), all int32, like the reference kernel. Beat
``i`` stamps age ``clock + i + 1`` and touches only its own set, so sets
are independent. On a CUDA tensor it launches the kernel of
``csrc/cache_lookup.cu`` (one warp per set, the ways on lanes, after the
beats are grouped by set on the device; the id-range check is the one host
sync); on a CPU tensor it runs ``cache_probe_plain``,
the same walk as a lockstep over the sets: at depth ``j`` every set
serves its ``j``-th beat. Counterpart of
``repro.kernels.cache_lookup.kernel``.

``cache_probe_rw(line_ids, is_write, tags, valid, age, dirty, clock,
write_back=...)`` is the same walk over a mixed read/write trace, with each
way's dirty bit and each beat's write flag, as the reference's set-parallel
cache engine steps it (``_tag_round`` in ``repro.core.trace_engine``, an
XLA ``lax.scan`` with no Pallas kernel); it also returns each beat's victim
write-back flag and the tag of the way it replaced. It runs the second
kernel of ``csrc/cache_lookup.cu`` on a CUDA tensor and
``cache_probe_rw_plain`` on a CPU tensor.

The kernels own metadata only; the data path is composed around them in
``ops.py`` and ``repro_torch.core.trace_engine``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels._build import I32, P, CudaLibrary

LIB = CudaLibrary("cache_lookup", {"cache_probe": (P,) * 13 + (I32,) * 3
                                   + (P,)})
# The read/write walk is a second entry of the same source, with launches
# counted apart.
RW_LIB = CudaLibrary("cache_lookup", {"cache_probe_rw": (P,) * 18
                                      + (I32,) * 4 + (P,)})
MAX_WAYS = 32          # one warp per set, one lane per way


def group_by_set(set_idx: torch.Tensor, sets: int):
    """(order, start): the beats stably sorted by set, and each set's first
    position in that order (``start[s]:start[s + 1]`` are set ``s``'s
    beats, in arrival order)."""
    order = torch.sort(set_idx, stable=True).indices
    start = torch.zeros(sets + 1, dtype=torch.int64, device=set_idx.device)
    torch.cumsum(torch.bincount(set_idx, minlength=sets), 0, out=start[1:])
    return order, start


def group_by_set_on_card(set_idx: torch.Tensor, sets: int):
    """``group_by_set`` without a host sync, as the CUDA branch groups the
    beats: ``start`` from a search of the sorted set ids, where
    ``torch.bincount`` waits for the device to size its output. Set ids
    are sorted as int16 where they fit (half the radix passes of int32).
    ``order`` is int64 and ``start`` int32 (what the kernel takes)."""
    keys = set_idx.to(torch.int16) if sets < 1 << 15 else set_idx
    sorted_sets, order = torch.sort(keys, stable=True)
    start = torch.searchsorted(
        sorted_sets, torch.arange(sets + 1, dtype=keys.dtype,
                                  device=set_idx.device), out_int32=True)
    return order, start


def cache_probe_plain(line_ids, tags, valid, age, clock):
    sets, ways = tags.shape
    lids = line_ids.long()
    n = lids.shape[0]
    set_idx, tag = lids % sets, lids // sets
    order, start = group_by_set(set_idx, sets)
    depth = torch.empty_like(order)
    depth[order] = torch.arange(n, device=lids.device) - start[set_idx[order]]
    by_depth = torch.sort(depth, stable=True).indices
    tags, valid, age = tags.clone(), valid.clone(), age.clone()
    hits = torch.zeros(n, dtype=torch.int32, device=lids.device)
    out_ways = torch.zeros(n, dtype=torch.int32, device=lids.device)
    clock0 = clock.reshape(()).long()
    lo = 0
    for count in torch.bincount(depth).tolist() if n else []:
        beats = by_depth[lo:lo + count]     # one beat of each live set
        lo += count
        s, t = set_idx[beats], tag[beats].int()
        match = (valid[s] != 0) & (tags[s] == t[:, None])
        hit = match.any(1)
        way = torch.where(hit, match.to(torch.uint8).argmax(1),
                          age[s].argmin(1))
        tags[s, way] = t
        valid[s, way] = 1
        age[s, way] = (clock0 + beats + 1).int()
        hits[beats] = hit.int()
        out_ways[beats] = way.int()
    return (hits, out_ways, tags, valid, age,
            (clock.reshape(1) + n).to(torch.int32))


def cache_probe_rw_plain(line_ids, is_write, tags, valid, age, dirty, clock,
                         *, write_back: bool):
    """``cache_probe_plain`` with the dirty bits and the write flags: at
    depth ``j`` every set serves its ``j``-th beat, as ``_tag_round``'s
    step does (a victim is evicted when the miss replaces a valid dirty
    way; a hit keeps the way's dirty bit unless it writes; a write sets it
    under ``write_back``)."""
    sets, ways = tags.shape
    lids = line_ids.long()
    n = lids.shape[0]
    set_idx, tag = lids % sets, lids // sets
    writes = is_write != 0
    order, start = group_by_set(set_idx, sets)
    depth = torch.empty_like(order)
    depth[order] = torch.arange(n, device=lids.device) - start[set_idx[order]]
    by_depth = torch.sort(depth, stable=True).indices
    tags, valid, age, dirty = (t.clone() for t in (tags, valid, age, dirty))
    hits, out_ways, evict, vic_tag = (
        torch.zeros(n, dtype=torch.int32, device=lids.device)
        for _ in range(4))
    clock0 = clock.reshape(()).long()
    lo = 0
    for count in torch.bincount(depth).tolist() if n else []:
        beats = by_depth[lo:lo + count]     # one beat of each live set
        lo += count
        s, t, w = set_idx[beats], tag[beats].int(), writes[beats]
        match = (valid[s] != 0) & (tags[s] == t[:, None])
        hit = match.any(1)
        way = torch.where(hit, match.to(torch.uint8).argmax(1),
                          age[s].argmin(1))
        way_dirty = (valid[s, way] != 0) & (dirty[s, way] != 0)
        keep = hit & way_dirty & ~w
        vic_tag[beats] = tags[s, way]
        evict[beats] = (~hit & way_dirty).int()
        tags[s, way] = t
        valid[s, way] = 1
        age[s, way] = (clock0 + beats + 1).int()
        dirty[s, way] = ((w | keep) if write_back else keep).int()
        hits[beats] = hit.int()
        out_ways[beats] = way.int()
    return (hits, out_ways, evict, vic_tag, tags, valid, age, dirty,
            (clock.reshape(1) + n).to(torch.int32))


def cache_probe(line_ids: torch.Tensor, tags: torch.Tensor,
                valid: torch.Tensor, age: torch.Tensor, clock: torch.Tensor,
                *, limit: int = 1 << 31):
    """Run a request batch through the tag/LRU pipeline.

    ``line_ids`` is 1-D int32 or int64 with every id in ``[0, limit)``,
    ``limit <= 2^31`` (a caller that serves a table passes its row count) —
    C's ``%`` is not Python's for a negative id, so one raises;
    ``tags``/``valid``/``age`` are contiguous ``(sets, ways)`` int32 with
    ``ways <= 32``; ``clock`` holds one int32. Anything else raises
    ``ValueError``. Returns (hits, ways, tags', valid', age', clock'), all
    int32; the inputs are not changed.
    """
    _check_inputs(line_ids, clock, limit, tags=tags, valid=valid, age=age)
    dev = tags.device
    n = line_ids.shape[0]
    if dev.type == "cpu":
        _check_ids(line_ids, limit)
        return cache_probe_plain(line_ids, tags, valid, age, clock)
    sets, ways = tags.shape
    hits = torch.empty(n, dtype=torch.int32, device=dev)
    out_ways = torch.empty(n, dtype=torch.int32, device=dev)
    new = [torch.empty_like(t) for t in (tags, valid, age)]
    clock = clock.reshape(1).contiguous()
    if n == 0:
        for dst, src in zip(new, (tags, valid, age)):
            dst.copy_(src)
        return (hits, out_ways, *new, clock.clone())
    # Launched before the id-range check, which then waits for them in the
    # one host sync: torch's % is a floor mod, so every beat's set is in
    # range whatever its id, and the kernel touches memory only by set and
    # beat. An id out of range raises and the outputs are dropped.
    lids = line_ids.to(torch.int32).contiguous()
    order, start = group_by_set_on_card(lids % sets, sets)
    new_clock = torch.empty_like(clock)
    LIB.launch("cache_probe", lids.data_ptr(), order.data_ptr(),
               start.data_ptr(), tags.data_ptr(), valid.data_ptr(),
               age.data_ptr(), clock.data_ptr(), hits.data_ptr(),
               out_ways.data_ptr(), *(t.data_ptr() for t in new),
               new_clock.data_ptr(), sets, ways, n,
               torch.cuda.current_stream(dev).cuda_stream)
    _check_ids(line_ids, limit)
    return (hits, out_ways, *new, new_clock)


def cache_probe_rw(line_ids: torch.Tensor, is_write: torch.Tensor,
                   tags: torch.Tensor, valid: torch.Tensor,
                   age: torch.Tensor, dirty: torch.Tensor,
                   clock: torch.Tensor, *, write_back: bool,
                   limit: int = 1 << 31):
    """Run a mixed read/write batch through the tag/LRU pipeline.

    As :func:`cache_probe`, plus ``is_write`` (``(N,)``, nonzero for a
    write) and ``dirty`` (contiguous ``(sets, ways)`` int32). Returns
    (hits, ways, evict, vic_tag, tags', valid', age', dirty', clock'), all
    int32: ``evict`` marks a miss that replaces a valid dirty way (a
    victim write-back), ``vic_tag`` is the tag the beat's way held before
    it. The inputs are not changed.
    """
    _check_inputs(line_ids, clock, limit, tags=tags, valid=valid, age=age,
                  dirty=dirty)
    if is_write.shape != line_ids.shape or is_write.device != tags.device:
        raise ValueError(f"is_write must be {tuple(line_ids.shape)} on "
                         f"{tags.device}, got {tuple(is_write.shape)} on "
                         f"{is_write.device}")
    dev = tags.device
    n = line_ids.shape[0]
    if dev.type == "cpu":
        _check_ids(line_ids, limit)
        return cache_probe_rw_plain(line_ids, is_write, tags, valid, age,
                                    dirty, clock, write_back=write_back)
    sets, ways = tags.shape
    per_beat = [torch.empty(n, dtype=torch.int32, device=dev)
                for _ in range(4)]
    new = [torch.empty_like(t) for t in (tags, valid, age, dirty)]
    clock = clock.reshape(1).contiguous()
    if n == 0:
        for dst, src in zip(new, (tags, valid, age, dirty)):
            dst.copy_(src)
        return (*per_beat, *new, clock.clone())
    # Launched before the id-range check, as in cache_probe.
    lids = line_ids.to(torch.int32).contiguous()
    writes = (is_write != 0).to(torch.uint8).contiguous()
    order, start = group_by_set_on_card(lids % sets, sets)
    new_clock = torch.empty_like(clock)
    RW_LIB.launch("cache_probe_rw", lids.data_ptr(), writes.data_ptr(),
                  order.data_ptr(), start.data_ptr(), tags.data_ptr(),
                  valid.data_ptr(), age.data_ptr(), dirty.data_ptr(),
                  clock.data_ptr(), *(t.data_ptr() for t in per_beat),
                  *(t.data_ptr() for t in new), new_clock.data_ptr(), sets,
                  ways, n, int(write_back),
                  torch.cuda.current_stream(dev).cuda_stream)
    _check_ids(line_ids, limit)
    return (*per_beat, *new, new_clock)


def _check_inputs(line_ids, clock, limit, **state) -> None:
    """Raise ``ValueError`` unless the inputs are what the kernels take:
    one device, CPU or CUDA; 1-D int32 or int64 ids; the state tensors
    contiguous ``(sets, ways <= 32)`` int32; one int32 clock."""
    tags = state["tags"]
    devices = {t.device for t in (line_ids, clock, *state.values())}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {sorted(map(str, devices))}")
    dev = tags.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {dev}")
    if line_ids.ndim != 1 or line_ids.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"line_ids must be 1-D int32 or int64, got "
                         f"{line_ids.dtype} of shape {tuple(line_ids.shape)}")
    if tags.ndim != 2 or not 1 <= tags.shape[1] <= MAX_WAYS:
        raise ValueError(f"tags must be (sets, ways <= {MAX_WAYS}), got "
                         f"{tuple(tags.shape)}")
    for name, t in state.items():
        if t.shape != tags.shape or t.dtype != torch.int32 \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous int32 "
                             f"{tuple(tags.shape)}")
    if clock.numel() != 1 or clock.dtype != torch.int32:
        raise ValueError("clock must hold one int32")
    if not 0 < limit <= 1 << 31:
        raise ValueError(f"limit={limit}: need 0 < limit <= 2^31")


def _check_ids(line_ids: torch.Tensor, limit: int) -> None:
    """Raise ``ValueError`` unless every id is in ``[0, limit)`` — one host
    sync."""
    if line_ids.numel():
        lo, hi = torch.stack(torch.aminmax(line_ids)).tolist()
        if lo < 0 or hi >= limit:
            raise ValueError(f"line id range [{lo}, {hi}] outside "
                             f"[0, {limit})")
