"""Port parity for B1, the bitonic sort: ``repro_torch`` (the kernel's plain
version, as it runs for CPU tensors) against the JAX Pallas kernel in
interpret mode and ``jnp.argsort(stable=True)``, bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import scheduler as jsched
from repro.kernels.bitonic_sort import kernel as jkernel
from repro.kernels.bitonic_sort import ops as jops
from repro_torch.core import scheduler as tsched
from repro_torch.kernels.bitonic_sort import kernel as tkernel
from repro_torch.kernels.bitonic_sort import ops as tops
from repro_torch.kernels.bitonic_sort import ref as tref

I32MAX = np.iinfo(np.int32).max


def _eq(t, j):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("g,n", [(1, 4), (1, 64), (3, 128), (1, 512)])
@pytest.mark.parametrize("key_range", [4, 1000])
def test_batched_network_matches_pallas(g, n, key_range, rng):
    keys = rng.integers(0, key_range, (g, n)).astype(np.int32)
    vals = rng.integers(0, 10_000, (g, n)).astype(np.int32)
    want = jkernel.bitonic_sort_batched(jnp.asarray(keys), jnp.asarray(vals))
    got = tkernel.bitonic_sort_batched(torch.from_numpy(keys),
                                       torch.from_numpy(vals))
    for t, j in zip(got, want):
        _eq(t, j)
    _eq(got[1], jnp.argsort(jnp.asarray(keys), axis=-1, stable=True))


@pytest.mark.parametrize("n", [1, 3, 33, 100, 250])
def test_non_power_of_two_with_int32_max_keys(n, rng):
    """Real INT32_MAX keys sort ahead of the INT32_MAX pad (the pad's ids
    are larger), so the sliced-off tail is exactly the pad."""
    keys = rng.integers(0, 7, n).astype(np.int32)
    keys[rng.integers(0, n, max(1, n // 4))] = I32MAX
    vals = rng.integers(0, 99, n).astype(np.int32)
    want = jops.sort_with_indices(jnp.asarray(keys), jnp.asarray(vals))
    got = tops.sort_with_indices(torch.from_numpy(keys),
                                 torch.from_numpy(vals))
    for t, j in zip(got, want):
        _eq(t, j)
    _eq(got[1], np.argsort(keys, kind="stable"))


def test_rows_with_padding_sort_independently(rng):
    keys = rng.integers(0, 50, (7, 60)).astype(np.int32)
    keys[2, :5] = I32MAX
    want = jops.sort_with_indices(jnp.asarray(keys))
    got = tops.sort_with_indices(torch.from_numpy(keys))
    for t, j in zip(got, want):
        _eq(t, j)


def test_int64_keys_cast_after_range_check():
    keys = torch.tensor([5, 1, 5, 0, 2**31 - 1], dtype=torch.int64)
    skeys, perm = tops.sort_with_indices(keys)
    assert skeys.dtype == perm.dtype == torch.int32
    assert perm.tolist() == [3, 1, 0, 2, 4]
    with pytest.raises(ValueError, match="int32"):
        tops.sort_with_indices(torch.tensor([2**31], dtype=torch.int64))
    with pytest.raises(ValueError, match="integers"):
        tops.sort_with_indices(torch.tensor([0.5, 1.0]))


def test_empty_batch():
    skeys, perm = tops.sort_with_indices(torch.zeros(0, dtype=torch.int32))
    assert skeys.shape == perm.shape == (0,)


def _i32(*shape):
    return torch.zeros(shape, dtype=torch.int32)


@pytest.mark.parametrize("keys,vals", [
    (_i32(1, 6), _i32(1, 6)),                  # N not a power of two
    (_i32(8), _i32(8)),                        # 1-D
    (_i32(1, 8).long(), _i32(1, 8)),           # int64 keys
    (_i32(1, 8), _i32(1, 8).float()),          # float payload
    (_i32(8, 2).t(), _i32(2, 8)),              # non-contiguous keys
    (_i32(1, 8), _i32(1, 4)),                  # shapes differ
])
def test_wrapper_rejects_what_the_kernel_does_not_take(keys, vals):
    with pytest.raises(ValueError):
        tkernel.bitonic_sort_batched(keys, vals)


def test_network_stage_count_matches_eq1():
    from repro_torch.core.config import scheduler_sort_stages
    calls = []
    orig = tkernel._compare_exchange

    def counting(*a):
        calls.append(a[3:])
        return orig(*a)

    tkernel._compare_exchange = counting
    try:
        x = torch.arange(64, dtype=torch.int32).flip(0)[None]
        tkernel.sort_network(x, x.clone(), x.clone())
    finally:
        tkernel._compare_exchange = orig
    assert len(calls) == scheduler_sort_stages(64) == 21


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("shape", [(100,), (4, 64)])
def test_sort_requests_matches_reference(use_kernels, shape, rng):
    keys = rng.integers(0, 20, shape).astype(np.int32)
    # The reference's XLA path takes 1-D keys only (its final take runs
    # along axis 0); the port sorts each row of a 2-D batch either way,
    # as the reference's Pallas path does.
    want = jsched.sort_requests(jnp.asarray(keys),
                                use_pallas=use_kernels or len(shape) == 2)
    got = tsched.sort_requests(torch.from_numpy(keys),
                               use_kernels=use_kernels)
    for t, j in zip(got, want):
        _eq(t, j)
        assert t.dtype == torch.int32


def test_ref_oracle_is_a_stable_sort(rng):
    keys = torch.from_numpy(rng.integers(0, 5, (3, 40)).astype(np.int32))
    vals = torch.from_numpy(rng.integers(0, 9, (3, 40)).astype(np.int32))
    got = tops.sort_with_indices(keys, vals)
    for t, r in zip(got, tref.sort_with_indices_ref(keys, vals)):
        assert torch.equal(t, r)


@settings(max_examples=30, deadline=None, derandomize=True)
@given(st.lists(st.integers(0, 7), min_size=1, max_size=200))
def test_property_duplicate_heavy_keys_match_argsort(xs):
    keys = np.asarray(xs, np.int32)
    skeys, perm = tops.sort_with_indices(torch.from_numpy(keys))
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(perm.numpy(), order)
    np.testing.assert_array_equal(skeys.numpy(), keys[order])
    inv = tops.inverse_permutation(perm)
    np.testing.assert_array_equal(inv.numpy(), np.argsort(order,
                                                          kind="stable"))


# --- The kernel's launch plan: stages whose stride fits a chunk run in
# shared memory in one launch.
def _network(n):
    m = n.bit_length() - 1
    return [(k, j) for k in range(1, m + 1) for j in range(k - 1, -1, -1)]


def _plan_stages(plan, chunk):
    """The network stages (k, j) that ``plan`` runs, in its order: a local
    launch (k_first, k_last) runs j = min(k, c)-1..0 for each k."""
    c = chunk.bit_length() - 1
    stages = []
    for kind, a, b in plan:
        if kind == "global":
            stages.append((a, b))
        else:
            stages += [(k, j) for k in range(a, b + 1)
                       for j in range(min(k, c) - 1, -1, -1)]
    return stages


@pytest.mark.parametrize("n,chunk,launches", [
    (512, 4096, 1), (1024, 4096, 1), (4096, 4096, 1), (8192, 4096, 3),
    (32768, 4096, 10), (32768, 16384, 3), (32768, 1024, 21),
    (32768, 2048, 15), (2, 2, 1), (8, 2, 6), (64, 8, 10)])
def test_stage_plan_runs_every_stage_once_in_network_order(n, chunk,
                                                           launches):
    plan = tkernel.stage_plan(n, chunk)
    c = min(chunk, n)
    assert len(plan) == launches
    assert plan[0] == ("local", 1, c.bit_length() - 1)
    assert _plan_stages(plan, c) == _network(n)
    for kind, a, b in plan:
        if kind == "global":      # only strides a chunk cannot hold
            assert (1 << b) >= c


@pytest.mark.parametrize("g,n", [(3, 256), (1, 2), (2, 64), (4, 128),
                                 (1, 1024)])
@pytest.mark.parametrize("kind", ["duplicates", "int32_max"])
def test_network_by_plan_equals_stable_sort(g, n, kind, rng):
    """Every plan runs the network's stages in the network's order (the
    test above), so the plain network is the plan's result: it must equal
    a stable sort on duplicate-heavy keys and on real INT32_MAX keys."""
    if kind == "duplicates":
        keys = rng.integers(0, 4, (g, n)).astype(np.int32)
    else:
        keys = rng.integers(0, 50, (g, n)).astype(np.int32)
        keys[:, rng.integers(0, n, max(1, n // 3))] = I32MAX
    vals = rng.integers(0, 10_000, (g, n)).astype(np.int32)
    tk, tv = torch.from_numpy(keys), torch.from_numpy(vals)
    ids = torch.arange(n, dtype=torch.int32).expand(g, n).contiguous()
    skeys, perm, svals = tkernel.sort_network(tk, ids, tv)
    want_keys, want_perm = torch.sort(tk, dim=-1, stable=True)
    assert torch.equal(skeys, want_keys)
    assert torch.equal(perm.long(), want_perm)
    assert torch.equal(svals, torch.take_along_dim(tv, want_perm, dim=-1))
    _eq(perm, jnp.argsort(jnp.asarray(keys), axis=-1, stable=True))
    got = tkernel.bitonic_sort_batched(tk, tv)
    for t, w in zip(got, (skeys, perm, svals)):
        assert torch.equal(t, w)


@pytest.mark.parametrize("n,chunk,launches", [
    (2, 2, 1), (512, 512, 1), (1024, 1024, 1), (2048, 2048, 1),
    (32768, 2048, 15)])
def test_default_chunk_fits_the_row_and_a_block(n, chunk, launches):
    """The wrapper's chunk: the whole row up to DEFAULT_CHUNK (one launch
    at the scheduler's 512 and the serve path's 1024), never past
    MAX_CHUNK's shared memory."""
    assert tkernel.default_chunk(n) == chunk <= tkernel.MAX_CHUNK
    assert len(tkernel.stage_plan(n, tkernel.default_chunk(n))) == launches
