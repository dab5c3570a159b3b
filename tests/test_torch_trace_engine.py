"""Port parity for the set-parallel cache engine: the port's
``simulate_trace(_rw)(engine="parallel")`` (``repro_torch.core.
trace_engine``; on the CPU the kernels' plain versions) against the
reference's set-parallel engine (``repro.core.cache_engine`` with
``engine="parallel"``) and against the port's own sequential walk, on the
same numpy inputs, over the reference's sweep
(``tests/core/test_trace_engine_equiv.py``): sets, ways, write policies,
cold, warm and dirty starting states, the auto dispatcher's fallbacks,
negative ids, single requests, all-miss streams and a chain deeper than
the reference's compaction threshold. ``engine="auto"`` must take the
branch the reference's ``auto_parallel_ok`` takes.

Tolerance: none. States, hits, served lines and tables are bit-identical.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cache_engine as jce
from repro.core import trace_engine as jte
from repro.core.config import CacheConfig as JCacheConfig
from repro_torch import convert
from repro_torch.core import cache_engine as tce
from repro_torch.core import trace_engine as tte
from repro_torch.core.config import CacheConfig
from repro_torch.kernels.cache_lookup import kernel as cl
from test_torch_cache_engine import _assert_equal, _port_state


def _same(got, want, what=""):
    """Port results against port results, bit for bit."""
    for i, (g, w) in enumerate(zip(got, want)):
        if isinstance(w, tce.CacheState):
            for f in dataclasses.fields(w):
                a, b = getattr(g, f.name), getattr(w, f.name)
                assert a.dtype == b.dtype and torch.equal(a, b), \
                    f"{what}.{f.name}"
        else:
            assert g.dtype == w.dtype and torch.equal(g, w), f"{what}[{i}]"


def _read_case(cfg, lids, table, warm, rng, dtype=jnp.float32):
    """One read trace through the reference's parallel engine and the
    port's parallel, sequential and auto paths; every result equal."""
    jcfg = JCacheConfig(**cfg)
    d = table.shape[1]
    jst = jce.init_cache(jcfg, d, dtype)
    jtab = jnp.asarray(table, dtype)
    if warm:        # chained state, same lineage (clean reads keep coherence)
        jst, _, _ = jce.simulate_trace_seq(
            jst, jnp.asarray(rng.integers(0, table.shape[0], 64), jnp.int32),
            jtab)
    jl = jnp.asarray(lids, jnp.int32)
    want = jce.simulate_trace(jst, jl, jtab, engine="parallel")
    tst = _port_state(jst)
    tl = torch.from_numpy(np.asarray(lids, np.int32))
    ttab = convert.to_tensor(np.asarray(jtab), "cpu")
    got = tce.simulate_trace(tst, tl, ttab, engine="parallel")
    for name, g, w in zip(("state", "hits", "lines"), got, want):
        _assert_equal(g, w, name)
    _same(got, tce.simulate_trace(tst, tl, ttab, engine="sequential"),
          "parallel against sequential")
    assert tte.auto_parallel_ok(tst, tl, table=ttab) == \
        jte.auto_parallel_ok(jst, jl, table=jtab)
    _same(tce.simulate_trace(tst, tl, ttab), got, "auto")
    return got


def _rw_case(cfg, lids, rw, n_rows, warm, rng, d=2):
    """One read/write trace: the reference's parallel engine, the port's
    parallel, sequential and auto paths, then ``flush`` of each."""
    jcfg = JCacheConfig(**cfg)
    table = jnp.asarray(rng.standard_normal((n_rows, d)), jnp.float32)
    jst = jce.init_cache(jcfg, d)
    if warm:    # enter with dirty lines from a prior trace (same lineage)
        n0 = 48
        jst, table, _, _ = jce.simulate_trace_rw_seq(
            jst, jnp.asarray(rng.integers(0, n_rows, n0), jnp.int32),
            jnp.asarray(rng.integers(0, 2, n0), jnp.int32),
            jnp.asarray(rng.standard_normal((n0, d)), jnp.float32),
            table, config=jcfg)
    n = len(lids)
    wl = rng.standard_normal((n, d)).astype(np.float32)
    args = (np.asarray(lids, np.int32), np.asarray(rw, np.int32), wl)
    want = jce.simulate_trace_rw(jst, *map(jnp.asarray, args), table,
                                 config=jcfg, engine="parallel")
    tst = _port_state(jst)
    targs = (*map(torch.from_numpy, args),
             torch.from_numpy(np.asarray(table)))
    pcfg = CacheConfig(**cfg)
    got = tce.simulate_trace_rw(tst, *targs, config=pcfg, engine="parallel")
    for name, g, w in zip(("state", "table", "hits", "lines"), got, want):
        _assert_equal(g, w, name)
    _same(got, tce.simulate_trace_rw(tst, *targs, config=pcfg,
                                     engine="sequential"), "sequential")
    assert tte.auto_parallel_ok(tst, targs[0], rw=targs[1],
                                write_lines=targs[2], table=targs[3],
                                rw_path=True) == \
        jte.auto_parallel_ok(jst, jnp.asarray(args[0]),
                             rw=jnp.asarray(args[1]),
                             write_lines=jnp.asarray(args[2]), table=table,
                             rw_path=True)
    _same(tce.simulate_trace_rw(tst, *targs, config=pcfg), got, "auto")
    jf = jce.flush(want[0], want[1])
    tf = tce.flush(got[0], got[1])
    _assert_equal(tf[1], jf[1], "flushed table")
    return got


@pytest.mark.parametrize("ways", [1, 2, 8])
@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_read_trace_matches_reference_parallel(ways, warm, seed):
    rng = np.random.default_rng(10 * seed + ways)
    lids = rng.integers(0, 900, int(rng.integers(1, 400)))
    table = rng.standard_normal((1024, 3)).astype(np.float32)
    _read_case(dict(num_lines=256, associativity=ways), lids, table, warm,
               rng)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_read_trace_at_many_sets_and_16_ways(dtype):
    """1024 lines, 16-way (64 sets), a Zipf trace long enough for the
    auto dispatcher to take the parallel path; bf16 lines too."""
    rng = np.random.default_rng(5)
    lids = (rng.zipf(1.2, 3000) - 1) % 4096
    table = rng.standard_normal((4096, 8)).astype(np.float32)
    _read_case(dict(num_lines=1024, associativity=16), lids, table, True,
               rng, dtype=dtype)


@pytest.mark.parametrize("policy", ["write_back", "write_through"])
@pytest.mark.parametrize("ways", [1, 4])
@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_rw_trace_matches_reference_parallel(policy, ways, warm, seed):
    """Mixed read/write stream: final state, backing table (raw and
    flushed), hit flags and served lines, from a cold or a dirty state."""
    rng = np.random.default_rng(7 * seed + 2 * ways)
    n = int(rng.integers(1, 300))
    _rw_case(dict(num_lines=256, associativity=ways, write_policy=policy),
             rng.integers(0, 600, n), rng.integers(0, 2, n), 640, warm, rng)


@pytest.mark.parametrize("policy", ["write_back", "write_through"])
def test_rw_trace_at_many_sets_and_16_ways(policy):
    rng = np.random.default_rng(9)
    n = 3000
    lids = (rng.zipf(1.2, n) - 1) % 4096
    _rw_case(dict(num_lines=1024, associativity=16, write_policy=policy),
             lids, rng.integers(0, 2, n), 4096, True, rng, d=4)


def test_auto_dispatch_falls_back_on_a_dirty_read_state(rng):
    """A read trace from a dirty state: both dispatchers refuse the
    parallel path, and ``"auto"`` gives the reference's result."""
    cfg = dict(num_lines=256, associativity=4, write_policy="write_back")
    jcfg = JCacheConfig(**cfg)
    table = jnp.asarray(rng.standard_normal((640, 2)), jnp.float32)
    jst, table, _, _ = jce.simulate_trace_rw_seq(
        jce.init_cache(jcfg, 2),
        jnp.asarray(rng.integers(0, 640, 64), jnp.int32),
        jnp.ones(64, jnp.int32),
        jnp.asarray(rng.standard_normal((64, 2)), jnp.float32), table,
        config=jcfg)
    lids = rng.integers(0, 640, 400).astype(np.int32)
    tst, ttab = _port_state(jst), torch.from_numpy(np.asarray(table))
    assert not jte.auto_parallel_ok(jst, jnp.asarray(lids), table=table)
    assert not tte.auto_parallel_ok(tst, torch.from_numpy(lids), table=ttab)
    want = jce.simulate_trace(jst, jnp.asarray(lids), table)
    got = tce.simulate_trace(tst, torch.from_numpy(lids), ttab)
    for name, g, w in zip(("state", "hits", "lines"), got, want):
        _assert_equal(g, w, name)


def test_auto_dispatch_falls_back_on_out_of_table_ids(rng):
    """Ids past the table on the read/write path: sequential on both
    sides; a forced ``"parallel"`` raises in the port (C3)."""
    cfg = dict(num_lines=256, associativity=2)
    table = rng.standard_normal((64, 2)).astype(np.float32)
    n = 300
    lids = rng.integers(0, 500, n).astype(np.int32)
    rw = rng.integers(0, 2, n).astype(np.int32)
    wl = rng.standard_normal((n, 2)).astype(np.float32)
    jst = jce.init_cache(JCacheConfig(**cfg), 2)
    jargs = (*map(jnp.asarray, (lids, rw, wl)), jnp.asarray(table))
    targs = tuple(map(torch.from_numpy, (lids, rw, wl, table)))
    tst = _port_state(jst)
    assert not jte.auto_parallel_ok(jst, jargs[0], rw=jargs[1],
                                    write_lines=jargs[2], table=jargs[3],
                                    rw_path=True)
    assert not tte.auto_parallel_ok(tst, targs[0], rw=targs[1],
                                    write_lines=targs[2], table=targs[3],
                                    rw_path=True)
    with pytest.raises(ValueError, match="outside"):
        tce.simulate_trace_rw(tst, *targs, config=CacheConfig(**cfg),
                              engine="parallel")


def test_auto_dispatch_falls_back_on_an_incoherent_state(rng):
    """A state warmed against another table breaks clean-line coherence:
    the dispatchers agree to fall back, and ``"auto"`` serves the Data
    RAM's copies as the reference does."""
    cfg = dict(num_lines=256, associativity=2)
    table_a = jnp.asarray(rng.standard_normal((512, 2)), jnp.float32)
    table_b = rng.standard_normal((512, 2)).astype(np.float32)
    jst, _, _ = jce.simulate_trace_seq(
        jce.init_cache(JCacheConfig(**cfg), 2),
        jnp.asarray(rng.integers(0, 512, 300), jnp.int32), table_a)
    lids = rng.integers(0, 512, 400).astype(np.int32)
    tst = _port_state(jst)
    assert not jte.auto_parallel_ok(jst, jnp.asarray(lids),
                                    table=jnp.asarray(table_b))
    assert not tte.auto_parallel_ok(tst, torch.from_numpy(lids),
                                    table=torch.from_numpy(table_b))
    want = jce.simulate_trace(jst, jnp.asarray(lids), jnp.asarray(table_b))
    got = tce.simulate_trace(tst, torch.from_numpy(lids),
                             torch.from_numpy(table_b))
    for name, g, w in zip(("state", "hits", "lines"), got, want):
        _assert_equal(g, w, name)


def test_auto_dispatch_falls_back_on_an_out_of_table_dirty_line(rng):
    """A resident dirty way caching a line beyond the (smaller) passed
    table would flush out of bounds: both dispatchers fall back, and the
    port's ``"auto"`` gives the reference's clipping result."""
    cfg = dict(num_lines=256, associativity=1, write_policy="write_back")
    jcfg = JCacheConfig(**cfg)
    big = jnp.asarray(rng.standard_normal((2048, 2)), jnp.float32)
    n0 = 64
    jst, big, _, _ = jce.simulate_trace_rw_seq(
        jce.init_cache(jcfg, 2),
        jnp.asarray(rng.integers(1500, 2048, n0), jnp.int32),
        jnp.ones(n0, jnp.int32),
        jnp.asarray(rng.standard_normal((n0, 2)), jnp.float32), big,
        config=jcfg)
    small = rng.standard_normal((640, 2)).astype(np.float32)
    n = 400
    lids = rng.integers(0, 640, n).astype(np.int32)
    rw = rng.integers(0, 2, n).astype(np.int32)
    wl = rng.standard_normal((n, 2)).astype(np.float32)
    jargs = (*map(jnp.asarray, (lids, rw, wl, small)),)
    targs = tuple(map(torch.from_numpy, (lids, rw, wl, small)))
    tst = _port_state(jst)
    assert not jte.auto_parallel_ok(jst, jargs[0], rw=jargs[1],
                                    write_lines=jargs[2], table=jargs[3],
                                    rw_path=True)
    assert not tte.auto_parallel_ok(tst, targs[0], rw=targs[1],
                                    write_lines=targs[2], table=targs[3],
                                    rw_path=True)
    want = jce.simulate_trace_rw(jst, *jargs, config=jcfg)
    got = tce.simulate_trace_rw(tst, *targs, config=CacheConfig(**cfg))
    for name, g, w in zip(("state", "table"), got, want):
        _assert_equal(g, w, name)


def test_negative_ids_stay_sequential_and_raise_when_forced(rng):
    """Negative ids wrap python-style through the sequential walk: auto
    keeps them there on both sides; the port's forced ``"parallel"``
    raises where the reference's takes numpy's floor ``%`` (C3)."""
    cfg = dict(num_lines=256, associativity=2)
    table = rng.standard_normal((512, 2)).astype(np.float32)
    lids = rng.integers(0, 512, 300).astype(np.int32)
    lids[5] = -3
    jst = jce.init_cache(JCacheConfig(**cfg), 2)
    tst = _port_state(jst)
    assert not jte.auto_parallel_ok(jst, jnp.asarray(lids),
                                    table=jnp.asarray(table))
    assert not tte.auto_parallel_ok(tst, torch.from_numpy(lids),
                                    table=torch.from_numpy(table))
    want = jce.simulate_trace(jst, jnp.asarray(lids), jnp.asarray(table))
    got = tce.simulate_trace(tst, torch.from_numpy(lids),
                             torch.from_numpy(table))
    for name, g, w in zip(("state", "hits", "lines"), got, want):
        _assert_equal(g, w, name)
    with pytest.raises(ValueError, match="outside"):
        tce.simulate_trace(tst, torch.from_numpy(lids),
                           torch.from_numpy(table), engine="parallel")


@pytest.mark.parametrize("lid,ways,lines", [(0, 1, 256), (4000, 2, 4096),
                                            (777, 8, 256), (3, 8, 4096)])
def test_single_request_trace(lid, ways, lines):
    """One request: one miss, zero hits, on every engine."""
    table = np.zeros((4096, 2), np.float32)
    got = _read_case(dict(num_lines=lines, associativity=ways),
                     np.asarray([lid]), table, False,
                     np.random.default_rng(lid))
    assert not bool(got[1][0])


@pytest.mark.parametrize("n", [64, 255, 256, 257, 1024, 4097])
@pytest.mark.parametrize("shape", [(256, 4), (1024, 1)])
def test_all_miss_trace(n, shape):
    """Distinct line ids everywhere: every beat a miss, on lengths that
    straddle the auto dispatcher's minimum and the reference's tail
    chunks."""
    lines, ways = shape
    table = np.random.default_rng(n).standard_normal(
        (n, 2)).astype(np.float32)
    got = _read_case(dict(num_lines=lines, associativity=ways),
                     np.arange(n), table, False, np.random.default_rng(n))
    assert not bool(got[1].any())


def test_chain_deeper_than_the_compaction_threshold():
    """One hot set of 5000 beats (40 tags over 16 ways) among cold ones:
    a chain past the reference's tail chunks (256, 1024, 4096) and its
    lockstep threshold (4096 beats)."""
    rng = np.random.default_rng(3)
    sets = 64
    hot = 5 + sets * rng.integers(0, 40, 5000)
    cold = rng.integers(0, 64 * sets, 1500)
    lids = np.concatenate([hot, cold])[rng.permutation(6500)]
    rw = rng.integers(0, 2, lids.size)
    _read_case(dict(num_lines=sets * 16, associativity=16), lids,
               rng.standard_normal((64 * sets, 2)).astype(np.float32), True,
               rng)
    _rw_case(dict(num_lines=sets * 16, associativity=16), lids, rw,
             64 * sets, True, rng)


@pytest.mark.parametrize("sets", [1, 64, 2048, 32768])
def test_partition_by_set_matches_reference(sets):
    rng = np.random.default_rng(sets)
    lids = rng.integers(0, 4 * sets + 7, 5000)
    want = jte.partition_by_set(lids, sets)
    got = tte.partition_by_set(torch.from_numpy(lids), sets)
    for name, g, w in zip(("perm", "starts", "counts"), got, want):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)


def _tag_round_walk(ids, writes, tags, valid, age, dirty, clock,
                    write_back):
    """The reference's ``_tag_round`` step, beat by beat in arrival order,
    in numpy: the oracle of ``cache_probe_rw_plain``."""
    sets, ways = tags.shape
    tags, valid, age, dirty = (a.copy() for a in (tags, valid, age, dirty))
    out = np.zeros((4, ids.size), np.int32)
    for i, (lid, w) in enumerate(zip(ids.tolist(), writes.tolist())):
        s, t = lid % sets, lid // sets
        match = (valid[s] != 0) & (tags[s] == t)
        hit = bool(match.any())
        way = int(np.argmax(match)) if hit else int(np.argmin(age[s]))
        way_dirty = bool(valid[s, way]) and bool(dirty[s, way])
        keep = hit and way_dirty and not w
        out[:, i] = (hit, way, not hit and way_dirty, tags[s, way])
        tags[s, way], valid[s, way] = t, 1
        age[s, way] = np.int32(clock + i + 1)
        dirty[s, way] = (bool(w) and write_back) or keep
    return (*out, tags, valid, age, dirty,
            np.asarray([clock + ids.size], np.int32))


@pytest.mark.parametrize("write_back", [True, False])
@pytest.mark.parametrize("start", ["empty", "random", "tied"])
def test_probe_rw_plain_is_the_tag_round_step(write_back, start):
    """``cache_probe_rw_plain`` against a per-beat loop of ``_tag_round``'s
    step, all nine outputs, from an empty state, a random one (valid and
    dirty bits, ages) and one whose ages tie."""
    rng = np.random.default_rng(2 + write_back)
    sets, ways, n = 16, 4, 600
    ids = np.concatenate([rng.integers(0, 40 * sets, n - 100),
                          3 + sets * rng.integers(0, 9, 100)]
                         )[rng.permutation(n)].astype(np.int32)
    writes = rng.integers(0, 2, n).astype(np.int32)
    shape = (sets, ways)
    if start == "empty":
        state = [np.zeros(shape, np.int32), np.zeros(shape, np.int32),
                 np.full(shape, -1, np.int32), np.zeros(shape, np.int32)]
    else:
        state = [rng.integers(0, 40, shape), rng.integers(0, 2, shape),
                 rng.integers(0, 3, shape) if start == "tied"
                 else rng.permutation(sets * ways).reshape(shape),
                 rng.integers(0, 2, shape)]
        state = [a.astype(np.int32) for a in state]
    clock = 7
    want = _tag_round_walk(ids, writes, *state, clock, write_back)
    got = cl.cache_probe_rw(
        torch.from_numpy(ids), torch.from_numpy(writes),
        *map(torch.from_numpy, state),
        torch.tensor([clock], dtype=torch.int32), write_back=write_back,
        rows=40 * sets)
    names = ("hits", "ways", "evict", "vic_tag", "tags", "valid", "age",
             "dirty", "clock")
    for name, g, w in zip(names, got, want):
        assert g.dtype == torch.int32, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)


@pytest.mark.parametrize("case", ["negative id", "write flags shape",
                                  "dirty dtype", "id past the limit"])
def test_probe_rw_rejects_what_the_kernel_does_not_take(case):
    st = tce.init_cache(CacheConfig(num_lines=256, associativity=4), 1,
                        device="cpu")
    ids = torch.tensor([1, 2, 3], dtype=torch.int32)
    writes = torch.tensor([0, 1, 0], dtype=torch.int32)
    dirty = st.dirty.to(torch.int32)
    rows = 1 << 10
    if case == "negative id":
        ids = torch.tensor([1, -2, 3], dtype=torch.int32)
    elif case == "write flags shape":
        writes = writes[:2]
    elif case == "dirty dtype":
        dirty = st.dirty
    else:
        rows = 3
    with pytest.raises(ValueError):
        cl.cache_probe_rw(ids, writes, st.tags, st.valid.to(torch.int32),
                          st.age, dirty, st.clock, write_back=True,
                          rows=rows)


def test_parallel_engine_repeats_its_bits(rng):
    """Two calls of the parallel engine give the same bits (no float
    atomics, C1's rule) and leave their inputs unchanged."""
    cfg = CacheConfig(num_lines=256, associativity=4)
    st = tce.init_cache(cfg, 3, device="cpu")
    n = 2000
    lids = torch.from_numpy(rng.integers(0, 700, n))
    rw = torch.from_numpy(rng.integers(0, 2, n))
    wl = torch.from_numpy(rng.standard_normal((n, 3)).astype(np.float32))
    table = torch.from_numpy(rng.standard_normal((700, 3)).astype(
        np.float32))
    before = (st.clone(), table.clone())
    first = tce.simulate_trace_rw(st, lids, rw, wl, table, config=cfg,
                                  engine="parallel")
    _same(first, tce.simulate_trace_rw(st, lids, rw, wl, table, config=cfg,
                                       engine="parallel"), "second call")
    _same((st, table), before, "inputs")


def _tag_round_values(ids, writes, tags, valid, age, dirty, clock,
                      write_back, rows):
    """``_tag_round``'s step beat by beat, tracking where each value comes
    from as the sequential engine moves it: each way's data and each table
    row carry a source (a beat's payload ``b``, the pre-trace content of
    way ``flat`` as ``n + flat``, the original row as -1). A victim flush
    writes its way's source to its (clipped) row, then a write-through
    write its own; a hit serves the way's source, a miss the row's. The
    oracle of ``cache_probe_rw_plain``'s value sources, from states a
    trace can reach (one way for a line)."""
    sets, ways = tags.shape
    n = ids.size
    tags, valid, age, dirty = (a.copy() for a in (tags, valid, age, dirty))
    way_src = np.where((valid != 0) & (dirty != 0),
                       n + np.arange(sets * ways).reshape(sets, ways), -1)
    row_src = np.full(rows, -1, np.int64)
    src, flush_src = np.full(n, -1, np.int64), np.full(n, -1, np.int64)
    last = np.full(sets * ways, -1, np.int64)
    for b, (lid, w) in enumerate(zip(ids.tolist(), writes.tolist())):
        s, t = lid % sets, lid // sets
        match = (valid[s] != 0) & (tags[s] == t)
        hit = bool(match.any())
        way = int(np.argmax(match)) if hit else int(np.argmin(age[s]))
        way_dirty = bool(valid[s, way]) and bool(dirty[s, way])
        if not hit and way_dirty:
            flush_src[b] = way_src[s, way]
            row_src[min(max(int(tags[s, way]) * sets + s, 0), rows - 1)] = \
                flush_src[b]
        src[b] = b if w else way_src[s, way] if hit else row_src[lid]
        way_src[s, way] = src[b]
        if w and not write_back:
            row_src[lid] = b
        keep = hit and way_dirty and not w
        tags[s, way], valid[s, way] = t, 1
        age[s, way] = np.int32(clock + b + 1)
        dirty[s, way] = (bool(w) and write_back) or keep
        last[s * ways + way] = b
    return src, flush_src, last, row_src


def _value_trace(kind, rng, sets):
    """Read/write traces that stress the value sources: ``hot line`` (one
    line written, evicted by four others of its set and read back, over
    and over), ``single set`` (every beat in set 3) and ``dirty write
    miss`` (writes fill a set, then a write misses and evicts a dirty way
    at its own beat), each mixed with random beats."""
    if kind == "hot line":
        rounds = [[5, 5 + sets, 5 + 2 * sets, 5 + 3 * sets, 5 + 4 * sets, 5]
                  for _ in range(30)]
        ids = np.asarray(rounds).reshape(-1)
        rw = np.tile([1, 0, 1, 0, 0, 0], 30)
    elif kind == "single set":
        ids = 3 + sets * rng.integers(0, 12, 300)
        rw = rng.integers(0, 2, 300)
    else:
        rounds = [[k * sets + 2 * j for k in range(5)] for j in range(4)]
        ids = np.asarray(rounds * 8).reshape(-1)
        rw = np.ones(ids.size, np.int64)
        rw[::7] = 0
    noise = rng.integers(0, 40 * sets, ids.size // 2)
    at = np.sort(rng.choice(ids.size + noise.size, noise.size,
                            replace=False))
    mixed = np.empty(ids.size + noise.size, np.int64)
    flags = np.empty_like(mixed)
    keep = np.ones(mixed.size, bool)
    keep[at] = False
    mixed[keep], flags[keep] = ids, rw
    mixed[at], flags[at] = noise, rng.integers(0, 2, noise.size)
    return mixed.astype(np.int32), flags.astype(np.int32)


@pytest.mark.parametrize("kind", ["hot line", "single set",
                                  "dirty write miss"])
@pytest.mark.parametrize("start", ["empty", "warm dirty"])
@pytest.mark.parametrize("write_back", [True, False])
def test_probe_rw_plain_value_sources_follow_the_values(kind, start,
                                                        write_back):
    """``cache_probe_rw_plain``'s value sources (``src``, ``flush_src``,
    ``last``, ``row_src``) against a per-beat loop of ``_tag_round``'s
    step that tracks values, from an empty state and from the dirty state
    a write-back trace leaves; its other nine outputs against
    ``_tag_round_walk``."""
    rng = np.random.default_rng(["hot line", "single set"].count(kind)
                                + 3 * write_back)
    sets, ways, rows = 8, 4, 8 * 40
    shape = (sets, ways)
    state = [np.zeros(shape, np.int32), np.zeros(shape, np.int32),
             np.full(shape, -1, np.int32), np.zeros(shape, np.int32)]
    clock = 0
    if start == "warm dirty":
        warm_ids = rng.integers(0, rows, 200).astype(np.int32)
        walk = _tag_round_walk(warm_ids, rng.integers(0, 2, 200), *state,
                               clock, True)
        state, clock = list(walk[4:8]), int(walk[8][0])
        assert (state[3] != 0).any()
    ids, writes = _value_trace(kind, rng, sets)
    got = cl.cache_probe_rw(
        torch.from_numpy(ids), torch.from_numpy(writes),
        *map(torch.from_numpy, state),
        torch.tensor([clock], dtype=torch.int32), write_back=write_back,
        rows=rows)
    assert len(got) == 13
    walk = _tag_round_walk(ids, writes, *state, clock, write_back)
    for g, w in zip(got[:9], walk):
        np.testing.assert_array_equal(g.numpy(), w)
    want = _tag_round_values(ids, writes, *state, clock, write_back, rows)
    for name, g, w in zip(("src", "flush_src", "last", "row_src"), got[9:],
                          want):
        assert g.dtype == torch.int64, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    if kind == "dirty write miss" and (write_back or start != "empty"):
        assert (got[2].numpy() & writes).any(), "no write evicted a dirty way"


@pytest.mark.parametrize("kind", ["hot line", "single set",
                                  "dirty write miss"])
@pytest.mark.parametrize("policy", ["write_back", "write_through"])
@pytest.mark.parametrize("warm", [False, True])
def test_rw_engine_on_value_traces_matches_reference_parallel(kind, policy,
                                                              warm):
    """The engine on the value-source traces against the reference's
    set-parallel engine and the port's sequential walk."""
    rng = np.random.default_rng(len(kind) + warm)
    ids, rw = _value_trace(kind, rng, 64)
    _rw_case(dict(num_lines=256, associativity=4, write_policy=policy),
             ids, rw, 64 * 40, warm, rng)


@pytest.mark.parametrize("policy", ["write_back", "write_through"])
def test_forced_parallel_clips_an_out_of_table_dirty_line(policy, rng):
    """A forced ``engine="parallel"`` from resident dirty ways whose lines
    lie past the (smaller) passed table: both engines clip their flushes
    to the last row, where they compete in arrival order with the row's
    own events, a write-through write to it at the flush's own beat
    included (the write lands last)."""
    cfg = dict(num_lines=256, associativity=1, write_policy="write_back")
    jcfg = JCacheConfig(**cfg)
    big = jnp.asarray(rng.standard_normal((2048, 2)), jnp.float32)
    warm_ids = np.concatenate([rng.integers(1500, 2048, 63), [1663]])
    jst, big, _, _ = jce.simulate_trace_rw_seq(
        jce.init_cache(jcfg, 2), jnp.asarray(warm_ids, jnp.int32),
        jnp.ones(64, jnp.int32),
        jnp.asarray(rng.standard_normal((64, 2)), jnp.float32), big,
        config=jcfg)
    small = rng.standard_normal((640, 2)).astype(np.float32)
    n = 400
    lids = rng.integers(0, 640, n).astype(np.int32)
    lids[[7, 50, 51, 300]] = [639, 127, 639, 383]   # set 127, row 639
    rw = rng.integers(0, 2, n).astype(np.int32)
    rw[[7, 51]] = 1
    wl = rng.standard_normal((n, 2)).astype(np.float32)
    pcfg = dict(cfg, write_policy=policy)
    jargs = (*map(jnp.asarray, (lids, rw, wl, small)),)
    want = jce.simulate_trace_rw(jst, *jargs, config=JCacheConfig(**pcfg),
                                 engine="parallel")
    got = tce.simulate_trace_rw(_port_state(jst),
                                *map(torch.from_numpy, (lids, rw, wl, small)),
                                config=CacheConfig(**pcfg), engine="parallel")
    for name, g, w in zip(("state", "table", "hits", "lines"), got, want):
        _assert_equal(g, w, name)
    assert not np.array_equal(got[1].numpy()[639], small[639])


@pytest.mark.parametrize("case", ["src dtype", "widths", "dtypes",
                                  "fallback rows", "devices"])
def test_row_resolve_rejects_what_the_kernel_does_not_take(case):
    src = torch.tensor([0, -1, 3])
    payload, extra = torch.zeros((2, 4)), torch.zeros((2, 4))
    fallback, fb_rows = torch.zeros((3, 4)), None
    if case == "src dtype":
        src = src.int()
    elif case == "widths":
        extra = torch.zeros((2, 5))
    elif case == "dtypes":
        fallback = fallback.double()
    elif case == "fallback rows":
        fallback = torch.zeros((5, 4))
    else:
        fb_rows = torch.zeros(3, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError):
        cl.row_resolve(src, payload, extra, fallback, fb_rows)


def test_row_resolve_copies_the_rows_its_sources_name(rng):
    """Each kind of source, with and without ``fallback_rows``, against
    numpy row picks; the bits are the sources'."""
    payload = rng.standard_normal((5, 3)).astype(np.float32)
    extra = rng.standard_normal((4, 3)).astype(np.float32)
    fallback = rng.standard_normal((7, 3)).astype(np.float32)
    src = rng.integers(-1, 9, 7)
    rows = rng.integers(0, 7, 7)
    pool = np.concatenate([payload, extra])
    for fb in (None, rows):
        want = np.where((src >= 0)[:, None], pool[np.maximum(src, 0)],
                        fallback[np.arange(7) if fb is None else fb])
        got = cl.row_resolve(*map(torch.from_numpy, (src, payload, extra,
                                                     fallback)),
                             None if fb is None else torch.from_numpy(fb))
        np.testing.assert_array_equal(got.numpy(), want)
