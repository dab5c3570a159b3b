"""Port parity for the cache engine: ``repro_torch.core.cache_engine``
against ``repro.core.cache_engine`` — single beats (``lookup``,
``access_rw``), whole read and read/write traces under both write
policies, ``flush``, the trace filter and the hit-rate oracle — from the
same numpy inputs, with the starting states carried across by
``repro_torch.convert.cache_state``.

Tolerance: none. Every beat moves whole lines and integer metadata, so
states, tables, hits and served lines are bit-identical.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import cache_engine as jce
from repro.core.config import CacheConfig as JCacheConfig
from repro_torch import convert
from repro_torch.core import cache_engine as tce
from repro_torch.core.config import CacheConfig

D = 4                      # line elements


def _t(a):
    return convert.to_tensor(np.asarray(a), "cpu")


def _port_state(jstate):
    return convert.cache_state(
        *(np.asarray(getattr(jstate, f.name))
          for f in dataclasses.fields(jstate)), "cpu")


def _assert_equal(got, want, what=""):
    if isinstance(want, jce.CacheState):
        assert isinstance(got, tce.CacheState)
        for f in dataclasses.fields(want):
            _assert_equal(getattr(got, f.name), getattr(want, f.name),
                          f"{what}.{f.name}")
        return
    w = np.asarray(want)
    g = got.float().numpy() if got.dtype == torch.bfloat16 else got.numpy()
    if w.dtype.name == "bfloat16":
        w = w.astype(np.float32)
    assert g.shape == w.shape, what
    np.testing.assert_array_equal(g, w, err_msg=what)


def _warm_state(cfg, rng, *, dirty=False, dtype=jnp.float32, n=400):
    """A reference state after a read/write trace: valid ways, ages,
    Data RAM lines and (with ``dirty``) dirty bits under write-back."""
    jcfg = JCacheConfig(**cfg)
    lids = rng.integers(0, cfg["num_lines"] * 3, n)
    rw = rng.integers(0, 2, n) if dirty else np.zeros(n, np.int64)
    table = jnp.asarray(rng.standard_normal((cfg["num_lines"] * 3, D)),
                        dtype)
    wl = jnp.asarray(rng.standard_normal((n, D)), dtype)
    st, _, _, _ = jce.simulate_trace_rw_seq(
        jce.init_cache(jcfg, D, dtype), jnp.asarray(lids, jnp.int32),
        jnp.asarray(rw, jnp.int32), wl, table, config=jcfg)
    return st


CFGS = [dict(num_lines=256, associativity=1), dict(num_lines=256,
                                                   associativity=4),
        dict(num_lines=1024, associativity=16)]


def test_init_cache_matches_reference():
    for cfg in CFGS:
        for dtype, tdtype in ((jnp.float32, torch.float32),
                              (jnp.bfloat16, torch.bfloat16)):
            got = tce.init_cache(CacheConfig(**cfg), D, tdtype, device="cpu")
            _assert_equal(got, jce.init_cache(JCacheConfig(**cfg), D, dtype))
            assert got.data.dtype == tdtype and got.clock.dtype == torch.int32


@pytest.mark.parametrize("cfg", CFGS)
def test_lookup_beats_match_reference(cfg, rng):
    """One beat at a time from a warm state: hit, served line and the
    whole new state; the given state is not changed."""
    jst = _warm_state(cfg, rng)
    tst = _port_state(jst)
    table = rng.standard_normal((cfg["num_lines"] * 3, D)).astype(np.float32)
    for lid in rng.integers(0, cfg["num_lines"] * 3, 12).tolist():
        before = tst.clone()
        jst, jhit, jline = jce.lookup(jst, jnp.int32(lid),
                                      jnp.asarray(table[lid]))
        new, thit, tline = tce.lookup(tst, lid, torch.from_numpy(table[lid]))
        _assert_equal(thit, jhit, "hit")
        _assert_equal(tline, jline, "line")
        _assert_equal(new, jst, "state")
        for f in dataclasses.fields(before):
            assert torch.equal(getattr(tst, f.name), getattr(before, f.name))
        tst = new


@pytest.mark.parametrize("cfg", CFGS)
@pytest.mark.parametrize("engine", ["auto", "sequential"])
@pytest.mark.parametrize("warm", [False, True])
def test_simulate_trace_matches_reference(cfg, engine, warm, rng):
    jcfg = JCacheConfig(**cfg)
    jst = _warm_state(cfg, rng) if warm else jce.init_cache(jcfg, D)
    table = rng.standard_normal((cfg["num_lines"] * 4, D)).astype(np.float32)
    lids = rng.integers(0, cfg["num_lines"] * 4, 300).astype(np.int32)
    jres = jce.simulate_trace(jst, jnp.asarray(lids), jnp.asarray(table),
                              engine=engine)
    tres = tce.simulate_trace(_port_state(jst), torch.from_numpy(lids),
                              torch.from_numpy(table), engine=engine)
    for name, g, w in zip(("state", "hits", "lines"), tres, jres):
        _assert_equal(g, w, name)


def test_parallel_engine_is_not_ported_yet():
    """The set-parallel engine, which this test once found missing, is
    ported: ``engine="parallel"`` runs (on the CPU, the kernels' plain
    versions) and gives the sequential walk's bits; an unknown engine
    still raises."""
    cfg = CacheConfig(num_lines=256, associativity=4)
    st0 = tce.init_cache(cfg, D, device="cpu")
    ids = torch.tensor([3, 67, 3, 131, 195, 3], dtype=torch.int32)
    table = torch.arange(256 * D, dtype=torch.float32).reshape(256, D)
    wl = -table[:6]
    for got, want in (
            (tce.simulate_trace(st0, ids, table, engine="parallel"),
             tce.simulate_trace(st0, ids, table, engine="sequential")),
            (tce.simulate_trace_rw(st0, ids, ids % 2, wl, table, config=cfg,
                                   engine="parallel"),
             tce.simulate_trace_rw(st0, ids, ids % 2, wl, table, config=cfg,
                                   engine="sequential"))):
        for g, w in zip(got, want):
            if isinstance(w, tce.CacheState):
                for f in dataclasses.fields(w):
                    assert torch.equal(getattr(g, f.name), getattr(w, f.name))
            else:
                assert torch.equal(g, w)
    with pytest.raises(ValueError, match="engine"):
        tce.simulate_trace(st0, ids, table, engine="fast")


@pytest.mark.parametrize("policy", ["write_back", "write_through"])
@pytest.mark.parametrize("cfg", CFGS)
@pytest.mark.parametrize("warm", [False, True])
def test_simulate_trace_rw_and_flush_match_reference(policy, cfg, warm,
                                                     rng):
    """Final state, table, hits, served lines, then ``flush``; from a warm
    dirty state too, so victim write-backs run."""
    c = dict(cfg, write_policy=policy)
    jcfg = JCacheConfig(**c)
    jst = _warm_state(cfg, rng, dirty=True) if warm else \
        jce.init_cache(jcfg, D)
    n = 300
    table = rng.standard_normal((cfg["num_lines"] * 4, D)).astype(np.float32)
    lids = rng.integers(0, cfg["num_lines"] * 4, n).astype(np.int32)
    rw = rng.integers(0, 2, n).astype(np.int32)
    wl = rng.standard_normal((n, D)).astype(np.float32)
    jres = jce.simulate_trace_rw(jst, jnp.asarray(lids), jnp.asarray(rw),
                                 jnp.asarray(wl), jnp.asarray(table),
                                 config=jcfg)
    tres = tce.simulate_trace_rw(_port_state(jst), *map(torch.from_numpy,
                                                        (lids, rw, wl,
                                                         table)),
                                 config=CacheConfig(**c))
    for name, g, w in zip(("state", "table", "hits", "lines"), tres, jres):
        _assert_equal(g, w, name)
    jflushed = jce.flush(jres[0], jres[1])
    tflushed = tce.flush(tres[0], tres[1])
    _assert_equal(tflushed[0], jflushed[0], "flushed state")
    _assert_equal(tflushed[1], jflushed[1], "flushed table")


@pytest.mark.parametrize("write_back", [True, False])
def test_access_rw_beats_match_reference(write_back, rng):
    """Single read/write beats with bf16 Data RAM and table and float32
    payloads: the served line keeps the promoted dtype, as ``where``
    gives it, and the given state and table are not changed."""
    cfg = dict(num_lines=256, associativity=2)
    jst = _warm_state(cfg, rng, dirty=True, dtype=jnp.bfloat16)
    table = jnp.asarray(rng.standard_normal((768, D)), jnp.bfloat16)
    tst, ttab = _port_state(jst), _t(table)
    for _ in range(16):
        lid = int(rng.integers(0, 768))
        is_w = bool(rng.integers(0, 2))
        wline = rng.standard_normal(D).astype(np.float32)
        jst, table, jhit, jline = jce.access_rw(
            jst, table, jnp.int32(lid), jnp.bool_(is_w), jnp.asarray(wline),
            write_back=write_back)
        before = ttab.clone()
        new, new_tab, thit, tline = tce.access_rw(
            tst, ttab, lid, is_w, torch.from_numpy(wline),
            write_back=write_back)
        assert torch.equal(ttab, before)
        _assert_equal(thit, jhit, "hit")
        assert tline.dtype == torch.float32
        _assert_equal(tline, jline, "line")
        _assert_equal(new, jst, "state")
        _assert_equal(new_tab, table, "table")
        tst, ttab = new, new_tab


@settings(max_examples=15, deadline=None, derandomize=True)
@given(st.lists(st.tuples(st.integers(0, 600), st.integers(0, 1)),
                min_size=1, max_size=60),
       st.sampled_from(["write_back", "write_through"]),
       st.sampled_from([1, 4]))
def test_property_rw_trace_matches_reference(reqs, policy, ways):
    c = dict(num_lines=256, associativity=ways, write_policy=policy)
    n = len(reqs)
    lids = np.array([r[0] for r in reqs], np.int32)
    rw = np.array([r[1] for r in reqs], np.int32)
    wl = (np.arange(n, dtype=np.float32)[:, None] + 1.0) * np.ones(
        (1, 2), np.float32)
    table = np.zeros((1024, 2), np.float32)
    jst = jce.init_cache(JCacheConfig(**c), 2)
    jres = jce.simulate_trace_rw(jst, *map(jnp.asarray, (lids, rw, wl,
                                                         table)),
                                 config=JCacheConfig(**c))
    tres = tce.simulate_trace_rw(_port_state(jst), *map(torch.from_numpy,
                                                        (lids, rw, wl,
                                                         table)),
                                 config=CacheConfig(**c))
    for name, g, w in zip(("state", "table", "hits", "lines"), tres, jres):
        _assert_equal(g, w, name)


@pytest.mark.parametrize("policy", ["write_back", "write_through"])
@pytest.mark.parametrize("engine", ["auto", "parallel", "sequential"])
@pytest.mark.parametrize("n,skew", [(300, 0.0), (6000, 0.0), (6000, 1.2)])
def test_filter_trace_rw_matches_reference(policy, engine, n, skew, rng):
    """Short traces take the dict walk; long ones the skew-compacted
    lockstep walk and its serial tails (``skew`` draws Zipf line ids)."""
    c = dict(num_lines=512, associativity=4, write_policy=policy)
    lids = (rng.zipf(1 + skew, n) % 5000 if skew
            else rng.integers(0, 5000, n))
    rw = rng.integers(0, 2, n)
    want = jce.filter_trace_rw(JCacheConfig(**c), lids, rw, engine=engine)
    got = tce.filter_trace_rw(CacheConfig(**c), lids, rw, engine=engine)
    for f in ("hits", "keep", "wb_pos", "wb_line"):
        g, w = getattr(got, f), getattr(want, f)
        assert g.dtype == w.dtype, f
        np.testing.assert_array_equal(g, w, err_msg=f)
    assert got.hit_rate == want.hit_rate
    assert got.n_writebacks == want.n_writebacks
    np.testing.assert_array_equal(
        tce.filter_trace_rw_seq(CacheConfig(**c), lids, rw).hits, want.hits)


@pytest.mark.parametrize("n,skew", [(0, 0.0), (300, 0.0), (6000, 0.0),
                                    (6000, 1.2)])
@pytest.mark.parametrize("ways", [1, 4, 16])
def test_hit_rate_oracle_matches_reference(n, skew, ways, rng):
    c = dict(num_lines=1024, associativity=ways)
    lids = (rng.zipf(1 + skew, n) % 9000 if skew
            else rng.integers(0, 9000, n))
    hits, rate = tce.hit_rate_oracle(CacheConfig(**c), lids)
    jhits, jrate = jce.hit_rate_oracle(JCacheConfig(**c), lids)
    np.testing.assert_array_equal(hits, jhits)
    assert rate == jrate
    shits, srate = tce.hit_rate_oracle_seq(CacheConfig(**c), np.asarray(lids))
    np.testing.assert_array_equal(shits, jhits)
    assert srate == jrate


@settings(max_examples=20, deadline=None, derandomize=True)
@given(st.lists(st.integers(0, 1000), min_size=1, max_size=80))
def test_property_trace_hits_match_hit_rate_oracle(lids):
    c = CacheConfig(num_lines=256, associativity=4)
    _, hits, lines = tce.simulate_trace(
        tce.init_cache(c, 2, device="cpu"),
        torch.tensor(lids, dtype=torch.int32),
        torch.arange(2048, dtype=torch.float32).reshape(1024, 2))
    np.testing.assert_array_equal(hits.numpy(),
                                  tce.hit_rate_oracle(c, np.asarray(lids))[0])
    assert lines[:, 0].tolist() == [2.0 * i for i in lids]
