"""Port parity for B2, the sorted gather: ``repro_torch`` (the kernel's
plain version, as it runs for CPU tensors) against the JAX op with its
Pallas kernel in interpret mode, bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.sorted_gather import kernel as jkernel
from repro.kernels.sorted_gather import ops as jops
from repro_torch import convert
from repro_torch.kernels.sorted_gather import kernel as tkernel
from repro_torch.kernels.sorted_gather import ops as tops
from repro_torch.kernels.sorted_gather import ref as tref

VOCAB, D = 256, 64          # yi-34b SMOKE_CONFIG widths


def _table(rng, dtype):
    if dtype == "int32":
        return jnp.asarray(rng.integers(-50, 50, (VOCAB, D)), jnp.int32)
    return jnp.asarray(rng.standard_normal((VOCAB, D)), jnp.float32).astype(
        dtype)


def _as_f32(x):
    """Exact float32 view of a port tensor or a JAX array (bf16 and the
    small int32 values widen exactly)."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
@pytest.mark.parametrize("shape", [(40,), (4, 24)])
@pytest.mark.parametrize("use_bitonic", [False, True])
def test_matches_pallas_op(dtype, shape, use_bitonic, rng):
    table = _table(rng, dtype)
    idx = rng.integers(0, VOCAB, shape).astype(np.int32)
    idx.reshape(-1)[:6] = idx.reshape(-1)[0]          # a run of duplicates
    want = jops.sorted_gather(table, jnp.asarray(idx),
                              use_bitonic=use_bitonic)
    t_table = convert.to_tensor(np.asarray(table), "cpu")
    got = tops.sorted_gather(t_table, torch.from_numpy(idx),
                             use_bitonic=use_bitonic)
    assert got.dtype == t_table.dtype and got.shape == (*shape, D)
    np.testing.assert_array_equal(_as_f32(got), _as_f32(want))
    assert torch.equal(got, tref.gather_ref(t_table, torch.from_numpy(idx)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_rows_matches_pallas_kernel(dtype, rng):
    table = _table(rng, dtype)
    sidx = np.sort(rng.integers(0, VOCAB, 50)).astype(np.int32)
    want = jkernel.gather_rows(table, jnp.asarray(sidx))
    got = tkernel.gather_rows(convert.to_tensor(np.asarray(table), "cpu"),
                              torch.from_numpy(sidx))
    np.testing.assert_array_equal(_as_f32(got), _as_f32(want))


def test_empty_batch(rng):
    table = torch.from_numpy(rng.standard_normal((VOCAB, D)).astype(
        np.float32))
    for use_bitonic in (False, True):
        out = tops.sorted_gather(table, torch.zeros((0,), dtype=torch.int32),
                                 use_bitonic=use_bitonic)
        assert out.shape == (0, D)
    assert tkernel.gather_rows(table, torch.zeros(
        (0,), dtype=torch.int64)).shape == (0, D)


def test_out_of_range_index_raises_where_jax_fills_nan(rng):
    """The known difference: ``jnp.take`` fills a row past the end with
    NaN (and wraps a negative index); the port raises ``ValueError``."""
    table = _table(rng, "float32")
    past_end = np.asarray([3, VOCAB], np.int32)
    assert np.isnan(np.asarray(jnp.take(table, jnp.asarray(past_end),
                                        axis=0))[1]).all()
    t_table = convert.to_tensor(np.asarray(table), "cpu")
    for bad in (past_end, np.asarray([-1, 3], np.int32)):
        with pytest.raises(ValueError, match="outside"):
            tops.sorted_gather(t_table, torch.from_numpy(bad))


@pytest.mark.parametrize("bad", ["float_idx", "2d_idx", "strided_table"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    table = torch.zeros((8, 4))
    idx = torch.tensor([1, 2])
    if bad == "float_idx":
        idx = idx.float()
    elif bad == "2d_idx":
        idx = idx[None]
    else:
        table = torch.zeros((4, 8)).t()
    with pytest.raises(ValueError):
        tkernel.gather_rows(table, idx)
