"""Cache engine — reconfigurable set-associative LRU cache (paper §IV-A).

The FPGA implementation keeps tags/data in URAM and runs two interlocked
pipelines (4-stage PE pipeline for lookups, 3-stage MEM pipeline for fills)
sharing Tag RAM, Data RAM and LRU state. Here the same structure is a
state dataclass of tensors — ``CacheState`` — walked one "pipeline beat"
at a time: each beat performs the tag compare, the LRU update, and (on
miss) the MEM-pipeline fill of the victim way. MEM-pipeline priority
(fills stall lookups) is inherent in the sequential walk.

This module is the *oracle* for the ``repro_torch.kernels.cache_lookup``
kernel. Address mapping: line = addr // line_bytes, set = line % num_sets,
tag = line // num_sets (floor division, as the reference's). Counterpart of
``repro.core.cache_engine``. Like the reference, no function changes the
state or table it is given; the sequential walks copy them once and then
update the copies beat by beat. Whole traces also take the set-parallel
engine of ``repro_torch.core.trace_engine`` (``engine="parallel"``, and
``"auto"`` where its preconditions hold, as the reference dispatches):
on a CUDA state that is one kernel launch for the tag walk, where the
sequential walk reads the host on every beat.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.core import scatter_util
from repro_torch.core.config import CacheConfig


@dataclasses.dataclass
class CacheState:
    """Tag RAM + Data RAM + LRU age matrix + dirty bits, as tensors.

    ``age`` holds the global access stamp of each way's last touch; LRU
    victim = argmin(age), with invalid ways pinned to age -1 so they are
    always chosen first (ties: the lowest way). ``clock`` is the global
    stamp counter. ``dirty`` marks ways whose Data RAM line is newer than
    DRAM (write-back policy); evicting a dirty way emits a victim
    write-back to the backing store.
    """

    tags: torch.Tensor    # (sets, ways) int32
    valid: torch.Tensor   # (sets, ways) bool
    age: torch.Tensor     # (sets, ways) int32
    data: torch.Tensor    # (sets, ways, line_elems) — cached lines
    clock: torch.Tensor   # () int32
    dirty: torch.Tensor   # (sets, ways) bool

    def clone(self) -> "CacheState":
        return CacheState(**{f.name: getattr(self, f.name).clone()
                             for f in dataclasses.fields(self)})


def init_cache(config: CacheConfig, line_elems: int,
               dtype: torch.dtype = torch.float32,
               device: str | torch.device = "cuda") -> CacheState:
    sets, ways = config.num_sets, config.associativity

    def full(value, dt, shape=(sets, ways)):
        return torch.full(shape, value, dtype=dt, device=device)

    return CacheState(
        tags=full(0, torch.int32), valid=full(False, torch.bool),
        age=full(-1, torch.int32),
        data=full(0, dtype, (sets, ways, line_elems)),
        clock=full(0, torch.int32, ()), dirty=full(False, torch.bool))


def _split_addr(line_id: int, num_sets: int) -> Tuple[int, int]:
    return line_id % num_sets, line_id // num_sets   # (set, tag)


def _probe(state: CacheState, s: int, t: int) -> Tuple[bool, int]:
    """(hit?, way) of tag ``t`` in set ``s``: the lowest matching way on a
    hit, else the LRU victim (lowest age, lowest way among equals)."""
    match = state.valid[s] & (state.tags[s] == t)
    if bool(match.any()):
        return True, int(match.to(torch.uint8).argmax())
    return False, int(state.age[s].argmin())


def _lookup_(state: CacheState, line_id: int, fill_line: torch.Tensor):
    """One read beat, updating ``state`` in place; returns (hit, line) —
    the line in the promoted dtype of the Data RAM and the fill, as the
    reference's ``where`` gives it."""
    s, t = _split_addr(line_id, state.tags.shape[0])
    hit, way = _probe(state, s, t)
    dt = torch.promote_types(state.data.dtype, fill_line.dtype)
    line_out = (state.data[s, way] if hit else fill_line).to(dt, copy=True)
    state.clock += 1
    state.tags[s, way] = t
    state.valid[s, way] = True
    state.age[s, way] = state.clock
    state.data[s, way] = line_out
    # read beat: a hit keeps the way's dirty bit (served from Data RAM),
    # a miss installs a fresh-from-DRAM line, which is clean.
    state.dirty[s, way] = hit and bool(state.dirty[s, way])
    return hit, line_out


def lookup(
    state: CacheState, line_id, fill_line: torch.Tensor,
) -> Tuple[CacheState, torch.Tensor, torch.Tensor]:
    """One *read-only* cache beat: probe ``line_id``; on miss install
    ``fill_line``.

    Returns (new_state, hit?, line_data). ``fill_line`` is the line the MEM
    pipeline would return from DRAM; on a hit it is ignored — the Data RAM
    copy is served (so a stale fill cannot clobber a dirty line).

    This beat has no write-back port: a miss that evicts a *dirty* way
    would lose the dirty line. Only feed it states with no dirty lines
    (pure read service) — mixed read/write traces go through
    :func:`access_rw` / :func:`simulate_trace_rw`, or :func:`flush` the
    state first.
    """
    new = state.clone()
    hit, line = _lookup_(new, int(line_id), fill_line)
    return new, torch.tensor(hit, device=state.tags.device), line


def simulate_trace_seq(
    state: CacheState, line_ids: torch.Tensor, table: torch.Tensor,
) -> Tuple[CacheState, torch.Tensor, torch.Tensor]:
    """Reference implementation of :func:`simulate_trace`: one beat per
    request, exactly the paper's shared-pipeline stall semantics. O(N)
    sequential steps — kept as the oracle the set-parallel engine is
    tested against, and as the fallback for pathological inputs."""
    st = state.clone()
    ids = line_ids.reshape(-1).tolist()
    hits = torch.zeros(len(ids), dtype=torch.bool)
    lines = table.new_empty(
        (len(ids), *state.data.shape[2:]),
        dtype=torch.promote_types(state.data.dtype, table.dtype))
    for i, lid in enumerate(ids):
        hits[i], lines[i] = _lookup_(st, lid, table[lid])
    return st, hits.to(table.device), lines


def simulate_trace(
    state: CacheState, line_ids: torch.Tensor, table: torch.Tensor,
    *, engine: str = "auto",
) -> Tuple[CacheState, torch.Tensor, torch.Tensor]:
    """Service a *read* trace through the cache against backing ``table``.

    ``table[line_id]`` plays DRAM. Returns (final_state, hits (N,) bool,
    lines (N, line_elems)). Like :func:`lookup`, this path has no
    write-back port — flush dirty state first, or use
    :func:`simulate_trace_rw` for mixed traces.

    ``engine`` selects the execution strategy — never the semantics (the
    two are bit-identical, see ``trace_engine``):

    * ``"auto"`` (default) — set-parallel engine when the trace is
      concrete, long enough, has no negative id, and the starting state is
      dirty-free (this path's no-write-back-port contract) and coherent
      with ``table``; sequential walk otherwise
      (``trace_engine.auto_parallel_ok``).
    * ``"parallel"`` — force the set-parallel engine (on a CUDA state, B5's
      kernel; a negative id raises ``ValueError``).
    * ``"sequential"`` — force the one-beat-per-request reference walk.
    """
    from repro_torch.core import trace_engine

    if engine == "sequential":
        return simulate_trace_seq(state, line_ids, table)
    if engine == "parallel":
        return trace_engine.simulate_trace_parallel(state, line_ids, table)
    if engine != "auto":
        raise ValueError(f"unknown engine {engine!r}")
    if trace_engine.auto_parallel_ok(state, line_ids, table=table):
        return trace_engine.simulate_trace_parallel(state, line_ids, table)
    return simulate_trace_seq(state, line_ids, table)


# ---------------------------------------------------------------------------
# Write path (write-allocate; write-back or write-through per CacheConfig)
# ---------------------------------------------------------------------------

def _line_of(tag, set_idx, num_sets: int):
    return tag * num_sets + set_idx


def _access_rw_(state: CacheState, table: torch.Tensor, line_id: int,
                is_write: bool, write_line: torch.Tensor, write_back: bool):
    """One read/write beat, updating ``state`` and ``table`` in place;
    returns (hit, line_out), the line in the promoted dtype of the Data
    RAM, the table and the payload."""
    num_sets = state.tags.shape[0]
    s, t = _split_addr(line_id, num_sets)
    hit, way = _probe(state, s, t)
    # Victim write-back: on a miss that evicts a valid dirty way, its line
    # returns to DRAM before the fill (same set, different tag — the victim
    # line can never equal ``line_id``). The line id wraps in int32 and is
    # clipped into the table, as the reference computes it.
    if not hit and bool(state.valid[s, way]) and bool(state.dirty[s, way]):
        victim = int(_line_of(state.tags[s, way], s, num_sets))
        table[min(max(victim, 0), table.shape[0] - 1)] = state.data[s, way]
    dt = torch.promote_types(torch.promote_types(
        state.data.dtype, table.dtype), write_line.dtype)
    if is_write:
        line_out = write_line.to(dt, copy=True)
    else:
        line_out = (state.data[s, way] if hit else table[line_id]).to(
            dt, copy=True)
    keep_dirty = hit and bool(state.dirty[s, way]) and not is_write
    if not write_back and is_write:
        table[line_id] = write_line
    state.clock += 1
    state.tags[s, way] = t
    state.valid[s, way] = True
    state.age[s, way] = state.clock
    state.data[s, way] = line_out
    state.dirty[s, way] = (is_write and write_back) or keep_dirty
    return hit, line_out


def access_rw(
    state: CacheState,
    table: torch.Tensor,
    line_id,
    is_write,
    write_line: torch.Tensor,
    *,
    write_back: bool = True,
) -> Tuple[CacheState, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One cache beat of a mixed read/write stream against backing ``table``.

    Write-allocate both ways; full-line writes (the controller's FLIT
    payload is one line). Under write-back a write only touches Data RAM
    and sets the dirty bit; DRAM sees the line when the way is evicted
    (victim flush — the MEM pipeline's write port). Under write-through
    every write also lands in ``table`` immediately and lines stay clean.

    Returns (new_state, new_table, hit?, line_out) where ``line_out`` is
    the value a read observes (reads see earlier writes — the same-address
    ordering the weak-consistency rule guarantees).
    """
    new, new_table = state.clone(), table.clone()
    hit, line = _access_rw_(new, new_table, int(line_id), bool(is_write),
                            write_line, write_back)
    return new, new_table, torch.tensor(hit, device=table.device), line


def simulate_trace_rw_seq(
    state: CacheState,
    line_ids: torch.Tensor,
    rw: torch.Tensor,
    write_lines: torch.Tensor,
    table: torch.Tensor,
    *,
    config: CacheConfig,
) -> Tuple[CacheState, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Reference implementation of :func:`simulate_trace_rw`: strict
    one-beat-at-a-time walk over :func:`access_rw`."""
    wb = config.write_policy == "write_back"
    st, tbl = state.clone(), table.clone()
    ids, writes = line_ids.reshape(-1).tolist(), rw.reshape(-1).tolist()
    hits = torch.zeros(len(ids), dtype=torch.bool)
    lines = state.data.new_empty(
        (len(ids), *state.data.shape[2:]),
        dtype=torch.promote_types(torch.promote_types(
            state.data.dtype, table.dtype), write_lines.dtype))
    for i, (lid, w) in enumerate(zip(ids, writes)):
        hits[i], lines[i] = _access_rw_(st, tbl, lid, w != 0,
                                        write_lines[i], wb)
    return st, tbl, hits.to(table.device), lines


def simulate_trace_rw(
    state: CacheState,
    line_ids: torch.Tensor,
    rw: torch.Tensor,
    write_lines: torch.Tensor,
    table: torch.Tensor,
    *,
    config: CacheConfig,
    engine: str = "auto",
) -> Tuple[CacheState, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Service a mixed read/write trace through the cache.

    ``rw[i]`` is 0 (read) / 1 (write); ``write_lines[i]`` is the payload of
    request i (ignored for reads). Returns (final_state, table', hits,
    lines) — call :func:`flush` on the final state to push residual dirty
    lines so ``table'`` matches the naive in-order write stream.

    ``engine``: ``"auto"`` / ``"parallel"`` / ``"sequential"`` — execution
    strategy only; results are bit-identical (see ``trace_engine``). The
    parallel engine additionally requires every line id to fall inside
    the table (``0 <= lid < table.shape[0]``; another raises
    ``ValueError``) and uniform table/data/payload dtypes, so its value
    reconstruction is exact; ``"auto"`` checks this and falls back. On a
    CUDA state its tag walk is the ``cache_probe_rw`` kernel.
    """
    from repro_torch.core import trace_engine

    wb = config.write_policy == "write_back"
    if engine == "sequential":
        return simulate_trace_rw_seq(state, line_ids, rw, write_lines,
                                     table, config=config)
    if engine == "parallel":
        return trace_engine.simulate_trace_rw_parallel(
            state, line_ids, rw, write_lines, table, write_back=wb)
    if engine != "auto":
        raise ValueError(f"unknown engine {engine!r}")
    if trace_engine.auto_parallel_ok(state, line_ids, rw=rw,
                                     write_lines=write_lines, table=table,
                                     rw_path=True):
        return trace_engine.simulate_trace_rw_parallel(
            state, line_ids, rw, write_lines, table, write_back=wb)
    return simulate_trace_rw_seq(state, line_ids, rw, write_lines, table,
                                 config=config)


def flush(state: CacheState, table: torch.Tensor
          ) -> Tuple[CacheState, torch.Tensor]:
    """Write every valid dirty line back to ``table``; clear dirty bits.

    Distinct (set, tag) pairs map to distinct lines, so the scatter has
    no duplicate targets among flushed ways; everything else is masked
    out of the write.
    """
    sets, ways = state.tags.shape
    set_grid = torch.arange(sets, dtype=state.tags.dtype,
                            device=state.tags.device)[:, None]
    lines = _line_of(state.tags, set_grid.expand(sets, ways), sets)
    mask = state.valid & state.dirty
    new_table = scatter_util.masked_row_set(
        table, lines.clamp(0, table.shape[0] - 1).reshape(-1),
        state.data.reshape(sets * ways, -1), mask.reshape(-1))
    return dataclasses.replace(
        state, dirty=torch.zeros_like(state.dirty)), new_table


@dataclasses.dataclass
class FilterResult:
    """Outcome of running a line-id trace through the cache *filter* —
    the pipeline-stage view of the cache engine (no data movement).

    ``hits[i]`` — request i hit in the cache. ``keep[i]`` — request i is
    forwarded to the DRAM stream (misses always; write hits only under
    write-through). ``wb_pos``/``wb_line`` — victim write-backs emitted
    by evictions of dirty lines: a WRITE of line ``wb_line[j]`` enters
    the DRAM stream immediately *before* the evicting miss at trace
    position ``wb_pos[j]`` (write-back policy only; at most one per
    miss). Residual dirty lines at end of trace are *not* flushed — the
    filter models steady-state occupancy, not teardown.
    """

    hits: np.ndarray      # (N,) bool
    keep: np.ndarray      # (N,) bool
    wb_pos: np.ndarray    # (W,) int64, ascending
    wb_line: np.ndarray   # (W,) int64

    @property
    def hit_rate(self) -> float:
        return float(self.hits.mean()) if self.hits.size else 0.0

    @property
    def n_writebacks(self) -> int:
        return int(self.wb_pos.shape[0])


def _empty_filter_result(n: int) -> FilterResult:
    return FilterResult(hits=np.zeros(n, bool), keep=np.ones(n, bool),
                        wb_pos=np.empty(0, np.int64),
                        wb_line=np.empty(0, np.int64))


#: once at most this many sets still have pending beats, the lockstep
#: walk hands their residual (serial hot-set) subtraces to the dict
#: walk — below ~32 live rows the fixed per-iteration numpy dispatch
#: cost exceeds the ~1µs/beat of the dict.
TAIL_SETS = 32
#: below this trace length the dict walk is trivially fast and the
#: sort/pad setup of the lockstep path is not worth paying.
MIN_LOCKSTEP_TRACE = 4096


class _CompactLayout:
    """Skew-compacted set-parallel layout shared by the numpy lockstep
    walks (:func:`hit_rate_oracle`, :func:`filter_trace_rw`).

    Sets are ordered by descending beat count, so at lockstep depth
    ``j`` the live sets are exactly the prefix ``[:k_js[j]]`` — columns
    are contiguous slices instead of boolean-masked full-width rows, and
    total lockstep work is ``Σ_s min(count_s, d_cut)`` instead of
    ``depth · sets``. Depth is cut at ``d_cut``, the beat count of the
    (``TAIL_SETS``+1)-th hottest set: beyond it at most ``TAIL_SETS``
    serial chains survive, and those residual subtraces (``tail_slices``)
    go to the per-set dict walk, seeded from the lockstep arrays.
    """

    def __init__(self, lids: np.ndarray, sets: int):
        n = lids.shape[0]
        self.set_idx = lids % sets
        self.tag = lids // sets
        self.counts = np.bincount(self.set_idx, minlength=sets)
        counts_d = np.sort(self.counts)[::-1]
        self.d_cut = int(counts_d[TAIL_SETS]) if sets > TAIL_SETS else 0
        self.vec_beats = int(np.minimum(self.counts, self.d_cut).sum())
        self.n = n

    @property
    def worthwhile(self) -> bool:
        """Enough lockstep-coverable work to beat the dict walk (the
        dict tail runs at seq speed, so the combined path only loses
        when setup overhead dominates — i.e. when almost everything is
        tail anyway)."""
        return (self.n >= MIN_LOCKSTEP_TRACE
                and self.vec_beats >= self.n // 4)

    def build(self):
        """Materialize the padded ``(K, d_cut)`` layout (cost O(n +
        K·d_cut); only call when :attr:`worthwhile`)."""
        sets = self.counts.shape[0]
        perm = np.argsort(self.set_idx, kind="stable")
        starts = np.zeros(sets + 1, np.int64)
        np.cumsum(self.counts, out=starts[1:])
        sorder = np.argsort(-self.counts, kind="stable")
        counts_d = self.counts[sorder]
        self.K = K = int(np.searchsorted(-counts_d, 0, side="left"))
        self.sorder = sorder
        cap = np.minimum(counts_d[:K], self.d_cut)
        mask = np.arange(self.d_cut)[None, :] < cap[:, None]
        self.perm2 = np.concatenate(
            [perm[starts[s]:starts[s] + c]
             for s, c in zip(sorder[:K].tolist(), cap.tolist())]) \
            if K else np.empty(0, np.int64)
        self.mask = mask
        # live-prefix length per lockstep depth: #{counts_d > j}
        self.k_js = np.searchsorted(-counts_d[:K], -np.arange(self.d_cut),
                                    side="left")
        # residual serial chains: (row i, set s, global slice) triples
        n_tail = int(np.searchsorted(-counts_d, -self.d_cut, side="left"))
        self.tail_slices = [
            (i, int(sorder[i]),
             perm[starts[sorder[i]] + self.d_cut:
                  starts[sorder[i]] + counts_d[i]])
            for i in range(n_tail)]

    def pad(self, vals: np.ndarray, dtype) -> np.ndarray:
        out = np.zeros((self.K, self.d_cut), dtype)
        out[self.mask] = vals[self.perm2]
        return out


def filter_trace_rw_seq(
    config: CacheConfig, line_ids: np.ndarray, rw: np.ndarray | None = None,
) -> FilterResult:
    """Reference implementation of :func:`filter_trace_rw` — one python
    dict per set, one iteration per request (the :func:`hit_rate_oracle_seq`
    walk extended with dirty bits and victim write-backs). Kept as the
    oracle the lockstep version is property-tested against."""
    sets, ways = config.num_sets, config.associativity
    wb = config.write_policy == "write_back"
    lids = np.asarray(line_ids, dtype=np.int64).ravel()
    rw_arr = np.zeros(lids.shape[0], np.int32) if rw is None \
        else np.asarray(rw, dtype=np.int32).ravel()
    res = _empty_filter_result(lids.shape[0])
    wb_pos: list[int] = []
    wb_line: list[int] = []
    entries: list[dict[int, list]] = [dict() for _ in range(sets)]
    for i, lid in enumerate(lids):
        s, t = int(lid % sets), int(lid // sets)
        e = entries[s]
        w = int(rw_arr[i]) == 1
        if t in e:
            res.hits[i] = True
            rec = e[t]
            rec[0] = i
            if w:
                rec[1] = wb           # write hit: dirty under write-back,
                res.keep[i] = not wb  # forwarded under write-through
            else:
                res.keep[i] = False   # read hit served from Data RAM
        else:
            if len(e) >= ways:
                vt = min(e, key=lambda k: e[k][0])
                if e[vt][1]:
                    wb_pos.append(i)
                    wb_line.append(vt * sets + s)
                del e[vt]
            e[t] = [i, w and wb]      # write-allocate; full-line FLIT
    res.wb_pos = np.asarray(wb_pos, np.int64)
    res.wb_line = np.asarray(wb_line, np.int64)
    return res


def filter_trace_rw(
    config: CacheConfig, line_ids: np.ndarray, rw: np.ndarray | None = None,
    *, engine: str = "auto",
) -> FilterResult:
    """Cache filter for the staged pipeline: classify a mixed read/write
    line trace, *remove* requests the cache absorbs, and emit the victim
    write-backs the write-back policy adds to the DRAM stream.

    Semantics (identical to :func:`filter_trace_rw_seq`, property-tested):
    read hits are served on-chip and dropped from the stream; write hits
    are absorbed (dirty) under ``write_back`` and forwarded under
    ``write_through``; misses always go downstream (write-allocate — a
    full-line write needs no fill read); evicting a dirty way inserts a
    WRITE of the victim line just before the evicting miss.

    Vectorized exactly like :func:`hit_rate_oracle` — the skew-compacted
    lockstep walk (:class:`_CompactLayout`): sets advance ordered by
    descending beat count so each depth step touches only the contiguous
    live prefix, with ``(K, ways)`` tag/age/dirty arrays; global arrival
    indices keep LRU victims identical to the dict walk, and the few
    residual serial hot-set chains finish in the dict walk seeded from
    the lockstep state. Tiny or chain-dominated traces dispatch to the
    sequential oracle.
    """
    if engine not in ("auto", "parallel", "sequential"):
        raise ValueError(f"unknown engine {engine!r}")
    sets, ways = config.num_sets, config.associativity
    wb = config.write_policy == "write_back"
    lids = np.asarray(line_ids, dtype=np.int64).ravel()
    n = lids.shape[0]
    if n == 0:
        return _empty_filter_result(0)
    rw_arr = np.zeros(n, np.int32) if rw is None \
        else np.asarray(rw, dtype=np.int32).ravel()
    if engine == "sequential":
        return filter_trace_rw_seq(config, lids, rw_arr)
    lay = _CompactLayout(lids, sets)
    if engine == "auto" and not lay.worthwhile:   # skewed/tiny: dict wins
        return filter_trace_rw_seq(config, lids, rw_arr)
    lay.build()
    K = lay.K
    tag_pad = lay.pad(lay.tag, np.int64)
    idx_pad = lay.pad(np.arange(n, dtype=np.int64), np.int64)
    w_pad = lay.pad(rw_arr == 1, bool)
    set_of_row = lay.sorder[:K].astype(np.int64)

    tags_arr = np.zeros((K, ways), np.int64)
    valid = np.zeros((K, ways), bool)
    age = np.full((K, ways), -1, np.int64)
    dirty = np.zeros((K, ways), bool)
    res = _empty_filter_result(n)
    wb_pos_parts: list[np.ndarray] = []
    wb_line_parts: list[np.ndarray] = []
    rows = np.arange(K)
    for j in range(lay.d_cut):
        k = int(lay.k_js[j])          # live prefix: sets with count > j
        t = tag_pad[:k, j]
        match = valid[:k] & (tags_arr[:k] == t[:, None])
        hit = match.any(axis=1)
        way = np.where(hit, match.argmax(axis=1), age[:k].argmin(axis=1))
        r = rows[:k]
        evict = ~hit & valid[r, way] & dirty[r, way]
        if evict.any():
            es = np.flatnonzero(evict)
            wb_pos_parts.append(idx_pad[es, j])
            wb_line_parts.append(tags_arr[es, way[es]] * sets
                                 + set_of_row[es])
        gi = idx_pad[:k, j]
        wl = w_pad[:k, j]
        old_dirty = dirty[r, way]
        tags_arr[r, way] = t
        valid[r, way] = True
        age[r, way] = gi
        dirty[r, way] = np.where(hit, np.where(wl, wb, old_dirty),
                                 wl & wb)
        res.hits[gi] = hit
        res.keep[gi] = ~hit | (wl & (not wb))
    tag_l = lay.tag
    wb_pos_tail: list[int] = []
    wb_line_tail: list[int] = []
    for i, s, sl in lay.tail_slices:
        e = {int(tags_arr[i, w]): [int(age[i, w]), bool(dirty[i, w])]
             for w in range(ways) if valid[i, w]}
        for g, t, is_w in zip(sl.tolist(), tag_l[sl].tolist(),
                              (rw_arr[sl] == 1).tolist()):
            if t in e:
                res.hits[g] = True
                rec = e[t]
                rec[0] = g
                if is_w:
                    rec[1] = wb
                    res.keep[g] = not wb
                else:
                    res.keep[g] = False
            else:
                if len(e) >= ways:
                    vt = min(e, key=lambda kk: e[kk][0])
                    if e[vt][1]:
                        wb_pos_tail.append(g)
                        wb_line_tail.append(vt * sets + s)
                    del e[vt]
                e[t] = [g, is_w and wb]
    if wb_pos_tail:
        wb_pos_parts.append(np.asarray(wb_pos_tail, np.int64))
        wb_line_parts.append(np.asarray(wb_line_tail, np.int64))
    if wb_pos_parts:
        pos = np.concatenate(wb_pos_parts)
        line = np.concatenate(wb_line_parts)
        order = np.argsort(pos, kind="stable")   # one eviction per miss
        res.wb_pos, res.wb_line = pos[order], line[order]
    return res


def hit_rate_oracle_seq(
    config: CacheConfig, line_ids: np.ndarray
) -> Tuple[np.ndarray, float]:
    """Reference implementation of :func:`hit_rate_oracle` — one python
    dict per set, one iteration per request. Kept as the independent
    oracle the vectorized version is property-tested against."""
    sets, ways = config.num_sets, config.associativity
    tags = [dict() for _ in range(sets)]      # set -> {tag: last_use}
    hits = np.zeros(line_ids.shape[0], dtype=bool)
    for i, lid in enumerate(np.asarray(line_ids, dtype=np.int64)):
        s, t = int(lid % sets), int(lid // sets)
        entry = tags[s]
        if t in entry:
            hits[i] = True
        elif len(entry) >= ways:
            del entry[min(entry, key=entry.get)]
        entry[t] = i
    return hits, float(hits.mean()) if hits.size else 0.0


def hit_rate_oracle(
    config: CacheConfig, line_ids: np.ndarray
) -> Tuple[np.ndarray, float]:
    """Fast numpy LRU-cache reference (no data movement) — hit mask + rate.

    Used by benchmarks where only the hit/miss classification feeds the
    timing model (Eq. 2) and by hypothesis tests as an independent oracle.

    Set-parallel vectorization: all sets advance in lockstep over their
    per-set subtraces (padded to the longest), with numpy ``(sets, ways)``
    tag/age arrays replacing the per-set python dicts — ``max_per_set``
    python iterations instead of N. Ages are global arrival indices
    (unique), so LRU victims are identical to the sequential dict walk.

    The lockstep walk is *skew-compacted* (:class:`_CompactLayout`):
    sets advance ordered by descending beat count so each depth step
    touches only the contiguous prefix of still-live sets, and once at
    most ``TAIL_SETS`` serial hot-set chains remain their residual beats
    fall through to the dict walk seeded from the lockstep state — total
    cost is O(n) array work plus dict-speed tails, so the parallel path
    never loses to the sequential oracle beyond setup noise. Traces
    where almost everything is one serial chain (or tiny ones) dispatch
    straight to the identical sequential oracle.
    """
    sets, ways = config.num_sets, config.associativity
    lids = np.asarray(line_ids, dtype=np.int64).ravel()
    n = lids.shape[0]
    hits = np.zeros(n, dtype=bool)
    if n == 0:
        return hits, 0.0
    lay = _CompactLayout(lids, sets)
    if not lay.worthwhile:             # skewed / tiny: dict walk is faster
        return hit_rate_oracle_seq(config, lids)
    lay.build()
    K = lay.K
    tag_pad = lay.pad(lay.tag, np.int64)
    idx_pad = lay.pad(np.arange(n, dtype=np.int64), np.int64)

    tags_arr = np.zeros((K, ways), np.int64)
    valid = np.zeros((K, ways), bool)
    age = np.full((K, ways), -1, np.int64)   # empty ways always win LRU
    rows = np.arange(K)
    for j in range(lay.d_cut):
        k = int(lay.k_js[j])          # live prefix: sets with count > j
        t = tag_pad[:k, j]
        match = valid[:k] & (tags_arr[:k] == t[:, None])
        hit = match.any(axis=1)
        way = np.where(hit, match.argmax(axis=1), age[:k].argmin(axis=1))
        r = rows[:k]
        gi = idx_pad[:k, j]
        tags_arr[r, way] = t
        valid[r, way] = True
        age[r, way] = gi
        hits[gi] = hit
    tag_l = lay.tag
    for i, _s, sl in lay.tail_slices:
        entry = {int(tags_arr[i, w]): int(age[i, w])
                 for w in range(ways) if valid[i, w]}
        for g, t in zip(sl.tolist(), tag_l[sl].tolist()):
            if t in entry:
                hits[g] = True
            elif len(entry) >= ways:
                del entry[min(entry, key=entry.get)]
            entry[t] = g
    return hits, float(hits.mean())
