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
write_back=..., rows=...)`` is the same walk over a mixed read/write trace,
with each way's dirty bit and each beat's write flag, as the reference's
set-parallel cache engine steps it (``_tag_round`` in
``repro.core.trace_engine``, an XLA ``lax.scan`` with no Pallas kernel);
it also returns each beat's victim write-back flag and the tag of the way
it replaced, and, over a backing table of ``rows`` rows, where each value
comes from: the source of every served line, of every victim write-back,
of each way's final content and of each table row's final content. It
runs the
second kernel of ``csrc/cache_lookup.cu`` on a CUDA tensor and
``cache_probe_rw_plain`` on a CPU tensor.

``row_resolve(src, payload, extra, fallback, fallback_rows=None)`` copies
the rows those sources name (the third kernel of ``csrc/cache_lookup.cu``;
``row_resolve_plain`` on a CPU tensor): the set-parallel engine's served
lines, final Data RAM and new table, winner rows only.

The probes own metadata only; the data path is composed around them in
``ops.py`` and ``repro_torch.core.trace_engine``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels._build import I32, I64, P, CudaLibrary

LIB = CudaLibrary("cache_lookup", {"cache_probe": (P,) * 13 + (I32,) * 3
                                   + (P,)})
# The read/write walk and the row resolve are further entries of the same
# source, each with its launches counted apart.
RW_LIB = CudaLibrary("cache_lookup", {"cache_probe_rw": (P,) * 23
                                      + (I32,) * 5 + (P,)})
RESOLVE_LIB = CudaLibrary("cache_lookup", {"row_resolve": (P,) * 4 + (I64,)
                                           + (P,) * 2 + (I64,) * 2 + (P,)})
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
                         *, write_back: bool, rows: int):
    """``cache_probe_plain`` with the dirty bits and the write flags: at
    depth ``j`` every set serves its ``j``-th beat, as ``_tag_round``'s
    step does (a victim is evicted when the miss replaces a valid dirty
    way; a hit keeps the way's dirty bit unless it writes; a write sets it
    under ``write_back``); then :func:`_value_sources` of the walk."""
    state0 = (tags, valid, dirty)
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
            (clock.reshape(1) + n).to(torch.int32),
            *_value_sources(lids, writes, out_ways, evict, vic_tag, *state0,
                            write_back=write_back, rows=rows))


def _value_sources(lids, writes, way, evict, vic_tag, tags0, valid0, dirty0,
                   *, write_back: bool, rows: int):
    """The value sources of a walk, as the plain engine has resolved them:
    (src, flush_src, last, row_src), int64 (see :func:`cache_probe_rw`).

    By the set partition the value any beat observes is the last write to
    its line before it: a trace write, else the pre-trace content of a
    dirty way holding the line (a "virtual write"), else the table's
    original row. One entry list, already in position order -- the virtual
    writes (by flat way), then each beat (a write a record of its own
    payload, a read a query) with each eviction's flush query right after
    its beat -- goes through the per-line fill of
    :func:`_resolve_last_writes`. Each row's winner is the max of
    ``2 * beat + kind`` over its events, clipped into the table."""
    sets, ways = tags0.shape
    n, dev = lids.shape[0], lids.device
    if n == 0:
        return (lids.new_empty(0), lids.new_empty(0),
                torch.full((sets * ways,), -1, dtype=torch.int64, device=dev),
                torch.full((rows,), -1, dtype=torch.int64, device=dev))
    set_idx = lids % sets
    virt_flat = torch.nonzero(((valid0 != 0) & (dirty0 != 0))
                              .reshape(-1)).squeeze(1)
    virt_lines = tags0.reshape(-1).long()[virt_flat] * sets \
        + virt_flat // ways
    e_pos = torch.nonzero(evict).squeeze(1)
    vic_line = vic_tag.index_select(0, e_pos).long() * sets \
        + set_idx.index_select(0, e_pos)
    nv = virt_lines.shape[0]
    pos = torch.arange(n, device=dev)
    slot = pos + nv
    slot[1:] += evict[:-1].long().cumsum(0)
    ev_slot = slot.index_select(0, e_pos) + 1
    m = nv + n + e_pos.shape[0]
    line_arr = torch.empty(m, dtype=torch.int64, device=dev)
    val_arr = torch.full((m,), -1, dtype=torch.int64, device=dev)
    line_arr[:nv] = virt_lines
    val_arr[:nv] = n + virt_flat
    line_arr[slot] = lids
    val_arr[slot] = torch.where(writes, pos, -1)
    line_arr[ev_slot] = vic_line
    lw_all = _resolve_last_writes(line_arr, val_arr)
    src = lw_all.index_select(0, slot)
    flush_src = torch.full((n,), -1, dtype=torch.int64, device=dev)
    flush_src[e_pos] = lw_all.index_select(0, ev_slot)
    last = torch.full((sets * ways,), -1, dtype=torch.int64,
                      device=dev).scatter_reduce_(
        0, set_idx * ways + way.long(), pos, "amax")
    ev_line, ev_key = vic_line, 2 * e_pos
    if not write_back:
        w_pos = torch.nonzero(writes).squeeze(1)
        ev_line = torch.cat([ev_line, lids.index_select(0, w_pos)])
        ev_key = torch.cat([ev_key, 2 * w_pos + 1])
    key = torch.full((rows,), -1, dtype=torch.int64,
                     device=dev).scatter_reduce_(
        0, ev_line.clamp(0, rows - 1), ev_key, "amax")
    at = key.clamp(min=0) // 2
    row_src = torch.where(key < 0, -1, torch.where(
        key % 2 == 1, at, flush_src.index_select(0, at.clamp(max=n - 1))))
    return src, flush_src, last, row_src


def _resolve_last_writes(line_arr: torch.Tensor,
                         val_arr: torch.Tensor) -> torch.Tensor:
    """Per-line forward fill over *position-ordered* entries.

    ``line_arr[k]`` is entry k's line; ``val_arr[k]`` is its value when it
    is a write record and -1 when it is a query. Returns, per entry, the
    value of the latest record on the same line at or before it (-1 if
    none).

    A stable sort on the line key alone groups lines while preserving
    position order; the per-line fill is then one global running max
    (``cummax``) of record row-indices after lifting each line's rows by a
    disjoint offset.
    """
    m = line_arr.shape[0]
    if m == 0:
        return line_arr.new_empty(0)
    order = torch.sort(line_arr, stable=True).indices
    line_o, val_o = line_arr[order], val_arr[order]
    gid = torch.zeros(m, dtype=torch.int64, device=line_arr.device)
    gid[1:] = (line_o[1:] != line_o[:-1]).long().cumsum(0)
    ridx = torch.where(val_o >= 0, torch.arange(m, device=line_arr.device),
                       -1)
    lift = gid * (m + 1)
    ffill = torch.cummax(ridx + lift, 0).values - lift
    res = torch.where(ffill >= 0, val_o[ffill.clamp(min=0)], -1)
    out = torch.empty_like(res)
    out[order] = res
    return out


def row_resolve_plain(src, payload, extra, fallback, fallback_rows=None):
    """``row_resolve`` as masked row copies."""
    n = payload.shape[0]
    out = fallback.clone() if fallback_rows is None \
        else fallback.index_select(0, fallback_rows)
    new = torch.nonzero((src >= 0) & (src < n)).squeeze(1)
    out[new] = payload.index_select(0, src.index_select(0, new))
    old = torch.nonzero(src >= n).squeeze(1)
    out[old] = extra.index_select(0, src.index_select(0, old) - n)
    return out


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
                   clock: torch.Tensor, *, write_back: bool, rows: int):
    """Run a mixed read/write batch through the tag/LRU pipeline.

    As :func:`cache_probe`, plus ``is_write`` (``(N,)``, nonzero for a
    write), ``dirty`` (contiguous ``(sets, ways)`` int32) and ``rows``, the
    backing table's row count (``1 <= rows < 2^31``), which takes the
    place of ``limit``: every id must lie in ``[0, rows)``. Returns (hits,
    ways, evict, vic_tag, tags', valid', age', dirty', clock'), all int32:
    ``evict`` marks a miss that replaces a valid dirty way (a victim
    write-back), ``vic_tag`` is the tag the beat's way held before it;
    then the value sources (src, flush_src, last, row_src), int64. The
    inputs are not changed.

    A source is a beat's payload (``0 <= s < N``), the pre-trace content
    of flat way ``s - N`` (``s >= N``) or the table's original row (-1):
    ``src[b]`` is the value beat ``b`` observes (a write's own payload),
    ``flush_src[b]`` the value its victim writes back (-1 if none),
    ``last[flat]`` the last beat that touched each way (-1 if none) and
    ``row_src[r]`` the value the latest event writing table row ``r``
    carries (a victim flush or, without ``write_back``, a write; the flush
    first at one beat; -1 if none). A victim line outside the table is
    clipped into it.
    """
    if not 0 < rows < 1 << 31:
        raise ValueError(f"rows={rows}: need 0 < rows < 2^31")
    _check_inputs(line_ids, clock, rows, tags=tags, valid=valid, age=age,
                  dirty=dirty)
    if is_write.shape != line_ids.shape or is_write.device != tags.device:
        raise ValueError(f"is_write must be {tuple(line_ids.shape)} on "
                         f"{tags.device}, got {tuple(is_write.shape)} on "
                         f"{is_write.device}")
    dev = tags.device
    n = line_ids.shape[0]
    sets, ways = tags.shape
    if n + sets * ways > 1 << 32:
        raise ValueError(f"{n} beats and {sets * ways} ways: the sources "
                         f"need n + sets * ways <= 2^32")
    if dev.type == "cpu":
        _check_ids(line_ids, rows)
        return cache_probe_rw_plain(line_ids, is_write, tags, valid, age,
                                    dirty, clock, write_back=write_back,
                                    rows=rows)
    per_beat = [torch.empty(n, dtype=torch.int32, device=dev)
                for _ in range(4)]
    new = [torch.empty_like(t) for t in (tags, valid, age, dirty)]
    clock = clock.reshape(1).contiguous()
    sources = [torch.empty(k, dtype=torch.int64, device=dev)
               for k in (n, n, sets * ways)]
    # row_src's event keys and the per-line last writes, both zeroed: one
    # fill.
    per_line = torch.zeros((2, rows), dtype=torch.int64, device=dev)
    if n == 0:
        for dst, src in zip(new, (tags, valid, age, dirty)):
            dst.copy_(src)
        sources[2].fill_(-1)
        return (*per_beat, *new, clock.clone(), *sources,
                per_line[0].fill_(-1))
    # Launched before the id-range check, as in cache_probe: the kernel
    # indexes its per-line arrays only by ids below ``rows``.
    lids = line_ids.to(torch.int32).contiguous()
    writes = (is_write != 0).to(torch.uint8).contiguous()
    order, start = group_by_set_on_card(lids % sets, sets)
    new_clock = torch.empty_like(clock)
    RW_LIB.launch("cache_probe_rw", lids.data_ptr(), writes.data_ptr(),
                  order.data_ptr(), start.data_ptr(), tags.data_ptr(),
                  valid.data_ptr(), age.data_ptr(), dirty.data_ptr(),
                  clock.data_ptr(), *(t.data_ptr() for t in per_beat),
                  *(t.data_ptr() for t in new), new_clock.data_ptr(),
                  *(t.data_ptr() for t in (*sources, *per_line)), sets, ways,
                  n, rows, int(write_back),
                  torch.cuda.current_stream(dev).cuda_stream)
    _check_ids(line_ids, rows)
    return (*per_beat, *new, new_clock, *sources, per_line[0])


def row_resolve(src: torch.Tensor, payload: torch.Tensor,
                extra: torch.Tensor, fallback: torch.Tensor,
                fallback_rows: torch.Tensor | None = None) -> torch.Tensor:
    """Copy the rows that value sources name.

    ``out[r]`` is ``payload[s]`` for ``0 <= s < N`` (``N`` payload rows),
    ``extra[s - N]`` for ``s >= N`` and ``fallback[fallback_rows[r]]``
    (``fallback[r]`` without ``fallback_rows``) for ``s < 0``, where
    ``s = src[r]``. ``src`` is 1-D int64 with every entry below
    ``N + len(extra)``; ``fallback_rows`` 1-D int64 of its length with
    rows of ``fallback`` (without it, ``fallback`` has ``len(src)``
    rows); ``payload``, ``extra`` and ``fallback`` 2-D of one dtype and
    width. Anything else raises ``ValueError``. Returns a
    new ``(len(src), width)`` tensor; pure copies, so its bits are the
    sources'.
    """
    devices = {t.device for t in (src, payload, extra, fallback)}
    if fallback_rows is not None:
        devices.add(fallback_rows.device)
    if len(devices) != 1:
        raise ValueError("inputs on several devices: "
                         f"{sorted(map(str, devices))}")
    dev = src.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {dev}")
    if src.ndim != 1 or src.dtype != torch.int64:
        raise ValueError(f"src must be 1-D int64, got {src.dtype} of shape "
                         f"{tuple(src.shape)}")
    if fallback_rows is not None and (
            fallback_rows.shape != src.shape
            or fallback_rows.dtype != torch.int64):
        raise ValueError(f"fallback_rows must be int64 {tuple(src.shape)}")
    if fallback_rows is None and fallback.shape[0] != src.shape[0]:
        raise ValueError(f"fallback must have {src.shape[0]} rows without "
                         f"fallback_rows, got {fallback.shape[0]}")
    rows_of = (payload, extra, fallback)
    if any(t.ndim != 2 or t.dtype != payload.dtype
           or t.shape[1] != payload.shape[1] for t in rows_of):
        raise ValueError("payload, extra and fallback must be 2-D of one "
                         "dtype and width, got "
                         + ", ".join(f"{t.dtype} {tuple(t.shape)}"
                                     for t in rows_of))
    if dev.type == "cpu":
        return row_resolve_plain(src, payload, extra, fallback,
                                 fallback_rows)
    payload, extra, fallback = (t.contiguous() for t in rows_of)
    src = src.contiguous()
    if fallback_rows is not None:
        fallback_rows = fallback_rows.contiguous()
    out = torch.empty((src.shape[0], payload.shape[1]), dtype=payload.dtype,
                      device=dev)
    if src.shape[0] == 0:
        return out
    RESOLVE_LIB.launch(
        "row_resolve", out.data_ptr(), src.data_ptr(),
        None if fallback_rows is None else fallback_rows.data_ptr(),
        payload.data_ptr(), payload.shape[0], extra.data_ptr(),
        fallback.data_ptr(), src.shape[0],
        payload.shape[1] * payload.element_size(),
        torch.cuda.current_stream(dev).cuda_stream)
    return out


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
