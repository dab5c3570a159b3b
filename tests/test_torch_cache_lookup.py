"""Port parity for B5, the cache probe, and its entry point
``cache_service``: ``repro_torch`` (the kernel's plain version, as it runs
for CPU tensors) against the JAX kernel in interpret mode, its scan oracle
``cache_probe_ref`` and the python LRU oracle ``hit_rate_oracle``, with
states carried across by ``repro_torch.convert.cache_state``.

Tolerance: none. The probe computes integers and the data path moves rows,
so hits, ways, the whole state trajectory and the served lines are
bit-equal.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core.cache_engine import hit_rate_oracle as jhit_rate_oracle
from repro.core.cache_engine import init_cache as jinit_cache
from repro.core.config import CacheConfig as JCacheConfig
from repro.kernels.cache_lookup.kernel import cache_probe as jcache_probe
from repro.kernels.cache_lookup.ops import cache_service as jcache_service
from repro.kernels.cache_lookup.ref import cache_probe_ref as jcache_probe_ref
from repro_torch import convert
from repro_torch.core import cache_engine as tce
from repro_torch.core.config import CacheConfig
from repro_torch.kernels.cache_lookup import kernel as tkernel
from repro_torch.kernels.cache_lookup import ops as tops
from repro_torch.kernels.cache_lookup import ref as tref


def _port_state(jstate):
    return convert.cache_state(
        *(np.asarray(getattr(jstate, f.name))
          for f in dataclasses.fields(jstate)), "cpu")


def _probe_args(jstate, lids):
    """The probe's five arguments, as JAX arrays and as the port's."""
    jargs = (jnp.asarray(lids, jnp.int32), jstate.tags,
             jstate.valid.astype(jnp.int32), jstate.age, jstate.clock)
    targs = tuple(convert.to_tensor(np.asarray(a), "cpu") for a in jargs)
    return jargs, targs


def _assert_outputs_equal(got, want):
    assert len(got) == len(want) == 6
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == torch.int32, f"output {i}"
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).reshape(
            g.shape), err_msg=f"output {i}")


def _warm(cfg, rng, n=300):
    """A non-empty starting state: the reference cache after ``n`` beats."""
    st0 = jinit_cache(JCacheConfig(**cfg), 4)
    lids = jnp.asarray(rng.integers(0, cfg["num_lines"] * 3, n), jnp.int32)
    _, _, tags, valid, age, clock = jcache_probe(
        lids, st0.tags, st0.valid.astype(jnp.int32), st0.age, st0.clock)
    return dataclasses.replace(st0, tags=tags, valid=valid != 0, age=age,
                               clock=clock.reshape(()))


@pytest.mark.parametrize("ways", [1, 2, 4, 8])
@pytest.mark.parametrize("lines", [256, 1024])
@pytest.mark.parametrize("warm", [False, True])
def test_probe_matches_pallas_kernel_and_oracles(ways, lines, warm, rng):
    cfg = dict(num_lines=lines, associativity=ways)
    jstate = _warm(cfg, rng) if warm else jinit_cache(JCacheConfig(**cfg), 4)
    jargs, targs = _probe_args(jstate, rng.integers(0, lines * 2, 96))
    got = tkernel.cache_probe(*targs)
    _assert_outputs_equal(got, jcache_probe(*jargs))
    _assert_outputs_equal(got, jcache_probe_ref(*jargs))
    _assert_outputs_equal(got, tref.cache_probe_ref(*targs))
    assert int(got[5]) == int(jstate.clock) + 96
    for before, arg in zip(targs[1:], _probe_args(jstate, [])[1][1:]):
        assert torch.equal(before, arg)           # the inputs are unchanged


def test_probe_matches_python_oracle(rng):
    cfg = dict(num_lines=512, associativity=4)
    lids = rng.integers(0, 700, 128)
    _, targs = _probe_args(jinit_cache(JCacheConfig(**cfg), 4), lids)
    hits = tkernel.cache_probe(*targs)[0] != 0
    np.testing.assert_array_equal(
        hits.numpy(), jhit_rate_oracle(JCacheConfig(**cfg), lids)[0])
    np.testing.assert_array_equal(
        hits.numpy(), tce.hit_rate_oracle(CacheConfig(**cfg), lids)[0])


@settings(max_examples=25, deadline=None, derandomize=True)
@given(st.lists(st.integers(0, 600), min_size=1, max_size=60),
       st.sampled_from([1, 2, 4, 16]))
def test_property_probe_agrees_with_hit_rate_oracle(lids, ways):
    cfg = dict(num_lines=256, associativity=ways)
    st0 = tce.init_cache(CacheConfig(**cfg), 4, device="cpu")
    out = tkernel.cache_probe(torch.tensor(lids, dtype=torch.int32),
                              st0.tags, st0.valid.int(), st0.age, st0.clock)
    want, _ = jhit_rate_oracle(JCacheConfig(**cfg), np.asarray(lids))
    np.testing.assert_array_equal((out[0] != 0).numpy(), want)


def test_lru_eviction_order():
    """Fill a set beyond its ways; the least-recently-used way must go."""
    cfg = dict(num_lines=256, associativity=2)  # 128 sets
    sets = 128
    # beat3 evicts `sets` (LRU after the beat2 refresh of 0); beat4
    # re-misses `sets` and evicts 0; beat5 therefore misses 0 again.
    seq = [0, sets, 0, 2 * sets, sets, 0]
    jargs, targs = _probe_args(jinit_cache(JCacheConfig(**cfg), 4), seq)
    got = tkernel.cache_probe(*targs)
    assert (got[0] != 0).tolist() == [False, False, True, False, False,
                                      False]
    assert got[1].tolist() == [0, 1, 0, 1, 0, 1]
    _assert_outputs_equal(got, jcache_probe(*jargs))


def test_ties_pick_the_lowest_way():
    """Several invalid ways at age -1 and equal stale ages: the lowest way
    wins, as ``jnp.argmin`` picks it; a tag present in two ways (only an
    imported state can hold that) hits the lower one."""
    tags = torch.tensor([[5, 9, 5, 0]], dtype=torch.int32)
    valid = torch.tensor([[1, 1, 1, 0]], dtype=torch.int32)
    age = torch.tensor([[3, 2, 2, -1]], dtype=torch.int32)
    clock = torch.tensor([7], dtype=torch.int32)
    hits, ways, *_ = tkernel.cache_probe(
        torch.tensor([5, 11, 12], dtype=torch.int32), tags, valid, age, clock)
    assert hits.tolist() == [1, 0, 0] and ways.tolist() == [0, 3, 1]
    out = jcache_probe(*(jnp.asarray(t.numpy()) for t in
                         (torch.tensor([5, 11, 12]), tags, valid, age,
                          clock)))
    _assert_outputs_equal(tkernel.cache_probe(
        torch.tensor([5, 11, 12], dtype=torch.int32), tags, valid, age,
        clock), out)


def test_group_by_set():
    order, start = tkernel.group_by_set(torch.tensor([2, 0, 2, 1, 0]), 4)
    assert order.tolist() == [1, 4, 3, 0, 2]
    assert start.tolist() == [0, 2, 3, 5, 5]


def _bad(case):
    lids = torch.tensor([1, 2, 3], dtype=torch.int32)
    tags = torch.zeros((8, 4), dtype=torch.int32)
    valid, age = tags.clone(), tags.clone()
    clock = torch.zeros(1, dtype=torch.int32)
    if case == "negative_id":
        lids = torch.tensor([1, -2, 3], dtype=torch.int32)
    elif case == "id_past_int32":
        lids = torch.tensor([1, 1 << 31], dtype=torch.int64)
    elif case == "float_ids":
        lids = lids.float()
    elif case == "two_d_ids":
        lids = lids.reshape(1, 3)
    elif case == "too_many_ways":
        tags = valid = age = torch.zeros((2, 33), dtype=torch.int32)
    elif case == "age_dtype":
        age = age.long()
    elif case == "valid_shape":
        valid = torch.zeros((8, 2), dtype=torch.int32)
    elif case == "strided_tags":
        tags = torch.zeros((4, 8), dtype=torch.int32).t()
    elif case == "clock":
        clock = torch.zeros(2, dtype=torch.int32)
    return lids, tags, valid, age, clock


@pytest.mark.parametrize("case", ["negative_id", "id_past_int32", "float_ids",
                                  "two_d_ids", "too_many_ways", "age_dtype",
                                  "valid_shape", "strided_tags", "clock"])
def test_wrapper_rejects_what_the_kernel_does_not_take(case):
    with pytest.raises(ValueError):
        tkernel.cache_probe(*_bad(case))


@pytest.mark.parametrize("limit,ok", [(4, True), (3, False), (0, False),
                                      ((1 << 31) + 1, False)])
def test_probe_checks_ids_against_the_callers_limit(limit, ok):
    """Ids are checked once, against ``[0, limit)``; the limit itself must
    lie in ``(0, 2^31]``."""
    args = _bad("none")
    if ok:
        assert tkernel.cache_probe(*args, limit=limit)[5].item() == 3
    else:
        with pytest.raises(ValueError):
            tkernel.cache_probe(*args, limit=limit)


def _service_both(cfg, table, lids, jstate):
    jlines, jhits, jnew = jcache_service(jnp.asarray(table),
                                         jnp.asarray(lids, jnp.int32), jstate)
    tlines, thits, tnew = tops.cache_service(
        torch.from_numpy(table), torch.from_numpy(np.asarray(lids)),
        _port_state(jstate))
    return (jlines, jhits, jnew), (tlines, thits, tnew)


def _assert_states_equal(got, want):
    for f in dataclasses.fields(want):
        g, w = getattr(got, f.name), np.asarray(getattr(want, f.name))
        np.testing.assert_array_equal(g.numpy(), w, err_msg=f.name)
        assert g.shape == w.shape, f.name


@pytest.mark.parametrize("ways,lines", [(1, 256), (2, 256), (4, 1024),
                                        (16, 256)])
@pytest.mark.parametrize("warm", [False, True])
def test_cache_service_matches_reference_with_repeated_ways(ways, lines,
                                                            warm, rng):
    """Several beats of one batch land on one (set, way) — a direct-mapped
    cache under a stream four times its size makes that certain — and the
    last one must win in the Data RAM, as in the reference and in the
    sequential walk."""
    cfg = dict(num_lines=lines, associativity=ways)
    table = rng.standard_normal((lines * 4, 4)).astype(np.float32)
    jstate = _warm(cfg, rng) if warm else jinit_cache(JCacheConfig(**cfg), 4)
    # The Data RAM of a valid way holds its line, as a real run leaves it.
    sets = lines // ways
    held = np.asarray(jstate.tags) * sets + np.arange(sets)[:, None]
    jstate = dataclasses.replace(jstate, data=jnp.asarray(np.where(
        np.asarray(jstate.valid)[..., None], table[held], 0)))
    lids = rng.integers(0, lines * 4, 400).astype(np.int32)
    (jl, jh, jn), (tl, th, tn) = _service_both(cfg, table, lids, jstate)
    slots = (lids % (lines // ways)) * ways + np.asarray(
        jcache_probe(jnp.asarray(lids), jstate.tags,
                     jstate.valid.astype(jnp.int32), jstate.age,
                     jstate.clock)[1])
    assert np.unique(slots).size < slots.size          # repeated targets
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tl.numpy(), table[lids])
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    assert th.dtype == torch.bool
    _assert_states_equal(tn, jn)
    # The sequential walk fills the same ways with the same lines.
    seq, hits, lines_seq = tce.simulate_trace_seq(
        _port_state(jstate), torch.from_numpy(lids), torch.from_numpy(table))
    assert torch.equal(hits, th) and torch.equal(lines_seq, tl)
    assert torch.equal(seq.data, tn.data) and torch.equal(seq.age, tn.age)


def test_cache_service_keeps_a_hit_way_dirty(rng):
    """A read beat keeps a hit way's dirty bit and installs a clean line on
    a miss (the reference's ``dirty & hit`` rule)."""
    cfg = dict(num_lines=256, associativity=4)
    jstate = _warm(cfg, rng)
    dirty = np.asarray(jstate.valid).copy()
    jstate = dataclasses.replace(jstate, dirty=jnp.asarray(dirty))
    table = rng.standard_normal((768, 4)).astype(np.float32)
    lids = rng.integers(0, 768, 200).astype(np.int32)
    (_, _, jn), (_, _, tn) = _service_both(cfg, table, lids, jstate)
    _assert_states_equal(tn, jn)
    assert bool(tn.dirty.any()) and not bool(tn.dirty.all())


@pytest.mark.parametrize("bad", [-1, 768])
def test_cache_service_rejects_a_line_outside_the_table(bad):
    state = tce.init_cache(CacheConfig(num_lines=256), 4, device="cpu")
    with pytest.raises(ValueError, match="outside"):
        tops.cache_service(torch.zeros((768, 4)),
                           torch.tensor([3, bad, 5]), state)


@pytest.mark.parametrize("ids", ["empty_sets", "one_hot_set", "uniform",
                                 "more_sets_than_int16"])
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_group_by_set_on_card_matches_group_by_set(ids, dtype, rng):
    """The CUDA branch's grouping without a host sync (a sort and a
    search, no ``bincount``), run on CPU tensors, gives ``group_by_set``'s
    order and starts: with sets that get no beat, with one hot set, with
    uniform ids, and with more sets than int16 sort keys hold."""
    sets = 40000 if ids == "more_sets_than_int16" else 64
    set_idx = {"empty_sets": rng.choice([3, 17, 40], 500),
               "one_hot_set": np.where(rng.random(2000) < 0.9, 11,
                                       rng.integers(0, sets, 2000)),
               "uniform": rng.integers(0, sets, 3000),
               "more_sets_than_int16": rng.integers(0, sets, 3000)}[ids]
    set_idx = torch.from_numpy(set_idx).to(dtype)
    order, start = tkernel.group_by_set_on_card(set_idx, sets)
    want_order, want_start = tkernel.group_by_set(set_idx, sets)
    assert order.dtype == torch.int64 and start.dtype == torch.int32
    assert order.tolist() == want_order.tolist()
    assert start.tolist() == want_start.tolist()
