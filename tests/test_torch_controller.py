"""Port parity for the slice as a whole: the port's ``MemoryController``
(``device="cpu"``, kernels on and off) against the JAX controller with its
Pallas kernels (``use_pallas=True``, interpret mode) and without, on the same
inputs, with state carried across by ``repro_torch.convert``; and the
ARCHITECTURE §1 identity table (no engine changes a result) on the port.

Tolerances: gathers and ``set`` scatters are bit-equal; ``add`` scatters sum
each run in float32 in another association (rtol = atol = 1e-5 for float32,
one bf16 ulp for bf16, see ``test_torch_sorted_scatter.py``).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import config as jcfg
from repro.core import controller as jctl
from repro.kernels.sorted_scatter.ref import scatter_ref as jscatter_ref
from repro_torch import convert
from repro_torch.core import controller as tctl
from repro_torch.kernels.sorted_scatter.ref import scatter_ref

VOCAB, D = 256, 64          # yi-34b SMOKE_CONFIG widths
ENGINES = [(True, True), (True, False), (False, True)]   # (scheduler, cache)


def _jcfg(sched, cache):
    """A JAX config derived from PAPER_EVAL_CONFIG with the scheduler and
    cache toggled (the DMA engine stays on, so one engine always is)."""
    base = jcfg.PAPER_EVAL_CONFIG
    return dataclasses.replace(
        base, scheduler=dataclasses.replace(base.scheduler, enabled=sched),
        cache=dataclasses.replace(base.cache, enabled=cache))


def _pair(sched=True, cache=True, use_pallas=True, use_kernels=True):
    """The JAX controller and the port's, the port's config carried over
    through ``convert.config_from_dict``."""
    j = _jcfg(sched, cache)
    t = convert.config_from_dict(dataclasses.asdict(j))
    return (jctl.MemoryController(j, use_pallas=use_pallas),
            tctl.MemoryController(t, use_kernels=use_kernels, device="cpu"))


def _inputs(rng, dtype="float32", shape=(4, 9)):
    table = jnp.asarray(rng.standard_normal((VOCAB, D)),
                        jnp.float32).astype(dtype)
    idx = rng.integers(0, VOCAB, shape).astype(np.int32)
    idx.reshape(-1)[:5] = idx.reshape(-1)[-1]          # a run of 6
    vals = jnp.asarray(rng.standard_normal((*shape, D)),
                       jnp.float32).astype(dtype)
    return table, jnp.asarray(idx), vals


def _port(*arrays):
    return [convert.to_tensor(np.asarray(a), "cpu") for a in arrays]


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _bf16_ulps(got, want):
    a, b = _f32(got).astype(np.float64), _f32(want).astype(np.float64)
    mag = np.maximum(np.abs(a), np.abs(b))
    exp = np.floor(np.log2(np.where(mag > 0, mag, 1.0)))
    return float((np.abs(a - b) / np.exp2(np.maximum(exp - 7, -133))).max())


def _assert_scatter_close(got, want, mode, dtype):
    if mode == "set":
        np.testing.assert_array_equal(_f32(got), _f32(want))
    elif dtype == "bfloat16":
        assert _bf16_ulps(got, want) <= 1.0
    else:
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("sched,cache", ENGINES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("use_pallas,use_kernels",
                         [(True, True), (False, False)])
def test_gather_matches_reference(sched, cache, dtype, use_pallas,
                                  use_kernels, rng):
    jmc, tmc = _pair(sched, cache, use_pallas, use_kernels)
    table, idx, _ = _inputs(rng, dtype)
    t_table, t_idx = _port(table, idx)
    got = tmc.gather(t_table, t_idx)
    assert got.shape == (*idx.shape, D) and got.dtype == t_table.dtype
    np.testing.assert_array_equal(_f32(got), _f32(jmc.gather(table, idx)))
    assert torch.equal(got, t_table[t_idx.long()])


@pytest.mark.parametrize("sched,cache", ENGINES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cached_gather_with_cache_carried_over(sched, cache, dtype, rng):
    jmc, tmc = _pair(sched, cache)
    table, idx, _ = _inputs(rng, dtype, (60,))
    hot = np.concatenate([np.asarray(idx)[:10],
                          rng.choice(VOCAB, 20, replace=False)])
    jcache = jctl.HotRowCache.build(table, np.unique(hot))
    tcache = convert.hot_row_cache(np.asarray(jcache.hot_ids),
                                   np.asarray(jcache.hot_data), "cpu")
    t_table, t_idx = _port(table, idx)
    got = tmc.cached_gather(t_table, t_idx, tcache)
    np.testing.assert_array_equal(
        _f32(got), _f32(jmc.cached_gather(table, idx, jcache)))
    assert torch.equal(got, t_table[t_idx.long()])
    np.testing.assert_array_equal(tcache.hit_mask(t_idx).numpy(),
                                  np.asarray(jcache.hit_mask(idx)))
    assert bool(tcache.hit_mask(t_idx[:10]).all())


@pytest.mark.parametrize("sched,cache", ENGINES)
@pytest.mark.parametrize("mode", ["set", "add"])
@pytest.mark.parametrize("use_pallas,use_kernels",
                         [(True, True), (False, False)])
def test_scatter_matches_reference(sched, cache, mode, use_pallas,
                                   use_kernels, rng):
    jmc, tmc = _pair(sched, cache, use_pallas, use_kernels)
    table, idx, vals = _inputs(rng)
    t_table, t_idx, t_vals = _port(table, idx, vals)
    got = tmc.scatter(t_table, t_idx, t_vals, mode=mode)
    assert got.shape == t_table.shape and got.dtype == t_table.dtype
    _assert_scatter_close(got, jmc.scatter(table, idx, vals, mode=mode),
                          mode, "float32")
    _assert_scatter_close(got, jscatter_ref(table, idx, vals, mode), mode,
                          "float32")


@pytest.mark.parametrize("mode", ["set", "add"])
@pytest.mark.parametrize("cache", [True, False])
def test_cached_scatter_matches_reference_and_stays_coherent(mode, cache,
                                                             rng):
    jmc, tmc = _pair(True, cache)
    table, idx, vals = _inputs(rng, "bfloat16", (40,))
    jcache = jctl.HotRowCache.build(table, np.unique(np.asarray(idx)[:12]))
    tcache = convert.hot_row_cache(np.asarray(jcache.hot_ids),
                                   np.asarray(jcache.hot_data), "cpu")
    t_table, t_idx, t_vals = _port(table, idx, vals)
    new_t, new_tc = tmc.cached_scatter(t_table, t_idx, t_vals, tcache,
                                       mode=mode)
    new_j, new_jc = jmc.cached_scatter(table, idx, vals, jcache, mode=mode)
    _assert_scatter_close(new_t, new_j, mode, "bfloat16")
    _assert_scatter_close(new_tc.hot_data, new_jc.hot_data, mode, "bfloat16")
    if cache:       # re-pinned: a cached read after the write sees it
        assert torch.equal(tmc.cached_gather(new_t, t_idx, new_tc),
                           new_t[t_idx.long()])
    else:           # the cache passes through untouched
        assert new_tc is tcache


@pytest.mark.parametrize("sched", [True, False])
def test_bf16_add_accumulates_in_f32_on_both_paths(sched):
    """The toggle identity on a bf16 table: 128 addends of 0.5 onto 256
    give 320 whether or not the scheduler reorders the batch."""
    _, tmc = _pair(sched, True)
    table = convert.to_tensor(np.asarray(jnp.full((4, 2), 256.0,
                                                  jnp.bfloat16)), "cpu")
    assert table.dtype == torch.bfloat16
    out = tmc.scatter(table, torch.zeros(128, dtype=torch.int32),
                      torch.full((128, 2), 0.5, dtype=torch.bfloat16),
                      mode="add")
    assert out[0].float().tolist() == [320.0, 320.0]


def test_last_writer_wins_with_engines_on_and_off():
    table = torch.zeros((16, 4))
    idx = torch.tensor([7, 2, 7, 7, 2], dtype=torch.int32)
    vals = torch.arange(1.0, 6.0)[:, None].expand(5, 4).contiguous()
    for sched in (True, False):
        for use_kernels in (True, False):
            _, tmc = _pair(sched, True, use_kernels=use_kernels)
            out = tmc.scatter(table, idx, vals)
            assert out[7].tolist() == [4.0] * 4      # arrival 3 is last
            assert out[2].tolist() == [5.0] * 4      # arrival 4 is last


def test_scatter_set_last_matches_reference(rng):
    table, idx, vals = _inputs(rng, shape=(50,))
    want = jctl.scatter_set_last(table, idx, vals)
    got = tctl.scatter_set_last(*_port(table, idx, vals))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_empty_hot_set_is_all_miss(rng):
    table, idx, _ = _inputs(rng, shape=(33,))
    t_table, t_idx = _port(table, idx)
    cache = tctl.HotRowCache.build(t_table, np.empty(0, np.int32))
    assert not bool(cache.hit_mask(t_idx).any())
    assert torch.equal(cache.gather(t_table, t_idx), t_table[t_idx.long()])


TOGGLES = [(True, True), (True, False), (False, True), (False, False)]
"""(scheduler, use_kernels): every path of the port's ``scatter``."""


@pytest.mark.parametrize("sched,use_kernels", TOGGLES)
def test_set_casts_values_to_the_table_dtype(sched, use_kernels, rng):
    """float32 values into a bf16 table: ``set`` rounds them to bf16 on
    every path, as the reference's XLA path does; ``add`` sums them in
    float32 and rounds once to bf16 on every path, as the reference does
    (the float32 gradients of a bf16 embedding table)."""
    jmc, tmc = _pair(sched, True, use_pallas=False, use_kernels=use_kernels)
    table, idx, _ = _inputs(rng, "bfloat16", (30,))
    vals = jnp.asarray(rng.standard_normal((30, D)) * 1e-3, jnp.float32)
    t_table, t_idx, t_vals = _port(table, idx, vals)
    got = tmc.scatter(t_table, t_idx, t_vals)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_f32(got), _f32(jmc.scatter(table, idx,
                                                              vals)))
    got = tmc.scatter(t_table, t_idx, t_vals, mode="add")
    assert got.dtype == torch.bfloat16
    _assert_scatter_close(got, jmc.scatter(table, idx, vals, mode="add"),
                          "add", "bfloat16")


@pytest.mark.parametrize("sched,use_kernels", TOGGLES)
@pytest.mark.parametrize("use_pallas", [True, False])
def test_f32_add_into_a_bf16_table_is_not_rounded_first(sched, use_kernels,
                                                        use_pallas):
    """0.001 four times onto a zero bf16 row: the reference sums at
    float32 and gives bf16(0.002) for row 0 (two addends) — not the sum of
    two bf16(0.001) — on every path of both packages."""
    jmc, tmc = _pair(sched, True, use_pallas=use_pallas,
                     use_kernels=use_kernels)
    idx = np.asarray([0, 2, 3, 0], np.int32)
    vals = np.full((4, 3), 0.001, np.float32)
    table = jnp.zeros((4, 3), jnp.bfloat16)
    want = jmc.scatter(table, jnp.asarray(idx), jnp.asarray(vals), mode="add")
    got = tmc.scatter(*_port(table, idx, vals), mode="add")
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_f32(got), _f32(want))
    assert got[0].tolist() == [torch.tensor(0.002).bfloat16().item()] * 3


@pytest.mark.parametrize("sched,use_kernels", TOGGLES)
@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("vdtype", ["int32", "float32"])
def test_add_on_an_int32_table_matches_reference(sched, use_kernels,
                                                 use_pallas, vdtype):
    """``add`` into an int32 table sums at float32 and truncates toward
    zero once: ``[[14,15,16],[3,4,5],[13,14,15],[16,17,18]]`` for 7 added
    at rows 0, 2, 3, 0 of ``arange(12)``, on every path of both packages;
    float32 values (exact quarters, so no sum order rounds) likewise."""
    jmc, tmc = _pair(sched, True, use_pallas=use_pallas,
                     use_kernels=use_kernels)
    table = np.arange(12, dtype=np.int32).reshape(4, 3)
    idx = np.asarray([0, 2, 3, 0], np.int32)
    vals = np.full((4, 3), 7, np.int32) if vdtype == "int32" else \
        np.asarray([[2.25], [-7.75], [1.5], [4.75]], np.float32).repeat(3, 1)
    want = np.asarray(jmc.scatter(jnp.asarray(table), jnp.asarray(idx),
                                  jnp.asarray(vals), mode="add"))
    got = tmc.scatter(*_port(table, idx, vals), mode="add")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if vdtype == "int32":
        assert got.tolist() == [[14, 15, 16], [3, 4, 5], [13, 14, 15],
                                [16, 17, 18]]
    else:                          # 6 - 7.75 = -1.75 truncates to -1
        assert got[:, 0].tolist() == [7, 3, -1, 10]


def test_bad_mode_raises():
    _, tmc = _pair()
    with pytest.raises(ValueError, match="mode"):
        tmc.scatter(torch.zeros((4, 2)), torch.tensor([1]),
                    torch.zeros((1, 2)), mode="max")


@settings(max_examples=20, deadline=None, derandomize=True)
@given(st.lists(st.integers(0, 15), min_size=1, max_size=100),
       st.sampled_from(["set", "add"]), st.sampled_from(ENGINES),
       st.booleans())
def test_property_identity_table(ids, mode, engines, use_kernels):
    """ARCHITECTURE §1 on the port: every engine setting gives the naive
    access — ``table[idx]`` and the in-order write stream."""
    _, tmc = _pair(*engines, use_kernels=use_kernels)
    table = torch.arange(16 * 4, dtype=torch.float32).reshape(16, 4)
    idx = torch.tensor(ids, dtype=torch.int32)
    vals = torch.arange(len(ids), dtype=torch.float32)[:, None].expand(
        len(ids), 4).contiguous()
    assert torch.equal(tmc.gather(table, idx), table[idx.long()])
    got = tmc.scatter(table, idx, vals, mode=mode)
    torch.testing.assert_close(got, scatter_ref(table, idx, vals, mode),
                               rtol=1e-5, atol=1e-5)


def _hot_run_inputs(dtype, seed=7, rows=300, d=16, n=1500, hot=900):
    """Unsorted ids with one hot row of ``hot`` slots among short runs."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, rows, n)
    idx[rng.permutation(n)[:hot]] = 11
    table = torch.from_numpy(rng.standard_normal((rows, d))).to(dtype)
    vals = torch.from_numpy(rng.standard_normal((n, d))).to(dtype)
    return table, torch.from_numpy(idx.astype(np.int32)), vals


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sched", [True, False])
def test_plain_add_repeats_its_bits(sched, dtype):
    """The plain ``add`` (kernels off), scheduled or not, gives the same
    bits in two calls, on a batch with a hot row of 900 slots."""
    _, tmc = _pair(sched, False, use_kernels=False)
    table, idx, vals = _hot_run_inputs(getattr(torch, dtype))
    a = tmc.scatter(table, idx, vals, mode="add")
    assert torch.equal(a, tmc.scatter(table, idx, vals, mode="add"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_unscheduled_add_agrees_with_scheduled(dtype):
    """With the scheduler off the plain ``add`` still sums each row's
    addends as one run and writes the row once; it agrees with the
    scheduled path within the tolerance of this file, and both with the
    JAX reference's in-order write stream."""
    on, off = (_pair(s, False, use_kernels=False)[1] for s in (True, False))
    table, idx, vals = _hot_run_inputs(getattr(torch, dtype))
    got_off = off.scatter(table, idx, vals, mode="add")
    got_on = on.scatter(table, idx, vals, mode="add")
    _assert_scatter_close(got_off, got_on, "add", dtype)
    jt, jv = (jnp.asarray(_f32(x)).astype(dtype) for x in (table, vals))
    want = jscatter_ref(jt, jnp.asarray(idx.numpy()), jv, "add")
    _assert_scatter_close(got_off, want, "add", dtype)


@pytest.mark.parametrize("sched,cache", [(True, True), (False, False)])
def test_capture_records_the_references_stream(sched, cache, rng):
    """A controller with a ``TraceCapture`` records the reference's
    ``op_counts`` and ``replay_arrays`` for the same gather, cached
    gather, scatter and bulk calls; without one (``capture=None``) every
    result is bit-identical."""
    from repro.core.capture import TraceCapture as JCapture
    from repro_torch.core.capture import TraceCapture
    table, idx, vals = _inputs(rng)
    j, t = _pair(sched, cache, use_pallas=False)
    ttable, tidx, tvals = _port(table, idx, vals)
    hot = np.arange(0, VOCAB, 7)
    jhot = jctl.HotRowCache.build(table, jnp.asarray(hot, jnp.int32))
    thot = tctl.HotRowCache.build(ttable, hot)
    kv = rng.standard_normal((4, 300)).astype(np.float32)
    src = rng.standard_normal(5000).astype(np.float32)

    def calls(mc, tab, ix, vs, hotc, kv, src):
        return [mc.gather(tab, ix), mc.cached_gather(tab, ix, hotc),
                mc.scatter(tab, ix, vs), mc.scatter(tab, ix, vs, mode="add"),
                mc.bulk_read(kv), mc.bulk_write(kv, src[:700],
                                                offset_elems=123)]

    j.capture, t.capture = JCapture(), TraceCapture()
    jcalls = calls(j, table, idx, vals, jhot, jnp.asarray(kv),
                   jnp.asarray(src))
    traced = calls(t, ttable, tidx, tvals, thot, torch.from_numpy(kv),
                   torch.from_numpy(src))
    assert t.capture.op_counts() == j.capture.op_counts()
    for got, want in zip(t.capture.replay_arrays(4),
                         j.capture.replay_arrays(4)):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    assert len(t.capture) == len(j.capture) > 0
    t.capture = None
    for got, want in zip(calls(t, ttable, tidx, tvals, thot,
                               torch.from_numpy(kv), torch.from_numpy(src)),
                         traced):
        assert torch.equal(got, want)
    assert torch.equal(traced[0], _port(jcalls[0])[0])
