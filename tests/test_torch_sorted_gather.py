"""Port parity for B2, the sorted gather: ``repro_torch`` (the kernel's
plain version, as it runs for CPU tensors) against the JAX op with its
Pallas kernel in interpret mode, bit for bit."""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.sorted_gather import kernel as jkernel
from repro.kernels.sorted_gather import ops as jops
from repro_torch import convert
from repro_torch.kernels import _build
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


# The kernel's span: the sorted slots one block owns (csrc/sorted_gather.cu).
SPAN = int(re.search(r"constexpr int kSpan = (\d+);",
                     (_build.CSRC / "sorted_gather.cu").read_text()).group(1))


def _runs(lengths, rng, rows=VOCAB):
    """Sorted indices made of runs of the given lengths, distinct rows."""
    ids = np.sort(rng.choice(rows, len(lengths), replace=False))
    return np.repeat(ids, lengths).astype(np.int32)


@pytest.mark.parametrize("case", ["one_long_run", "runs_cross_spans",
                                  "n_not_a_multiple_of_the_span",
                                  "shorter_than_a_span"])
def test_gather_rows_by_runs_matches_pallas_kernel(case, rng):
    """The wrapper's contract at the shapes that stress the kernel's spans:
    one run longer than many spans, runs that start and end inside spans,
    a ragged last span, a single partial span; equal to the JAX Pallas
    kernel (interpret mode) and to ``table[idx]``."""
    lengths = {"one_long_run": [5 * SPAN + 3],
               "runs_cross_spans": [SPAN - 3, 2 * SPAN + 1, 5, SPAN + 7],
               "n_not_a_multiple_of_the_span": [1] * (3 * SPAN + 5),
               "shorter_than_a_span": [1, SPAN - 2]}[case]
    sidx = _runs(lengths, rng)
    assert sidx.size % SPAN or case == "one_long_run"
    table = _table(rng, "float32")
    want = jkernel.gather_rows(table, jnp.asarray(sidx))
    got = tkernel.gather_rows(convert.to_tensor(np.asarray(table), "cpu"),
                              torch.from_numpy(sidx))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), np.asarray(table)[sidx])


def test_gather_rows_of_a_5000_slot_run(rng):
    """A hot token's run of 5000 equal indices, as in a Zipf batch."""
    table = _table(rng, "bfloat16")
    sidx = np.full(5000, 17, np.int32)
    t_table = convert.to_tensor(np.asarray(table), "cpu")
    got = tkernel.gather_rows(t_table, torch.from_numpy(sidx))
    assert got.shape == (5000, D)
    assert torch.equal(got, t_table[17].expand(5000, D))


@pytest.mark.parametrize("dtype,d,width", [
    ("bfloat16", 64, 16), ("bfloat16", 4, 8), ("float32", 1, 4),
    ("bfloat16", 3, 2), ("uint8", 5, 1), ("int32", 3, 4)])
def test_gather_rows_at_each_access_width(dtype, d, width, rng):
    """Row pitches whose widest aligned access is 16, 8, 4, 2 and 1 bytes
    (the kernel's two routes and its width ladder), bit-equal to the JAX
    Pallas kernel where JAX takes the dtype, else to ``table[idx]``."""
    np_dtype = {"uint8": np.uint8, "int32": np.int32}.get(dtype, np.float32)
    table = (rng.integers(0, 200, (50, d)) if dtype in ("uint8", "int32")
             else rng.standard_normal((50, d))).astype(np_dtype)
    t_table = torch.from_numpy(table).to(getattr(torch, dtype))
    pitch = d * t_table.element_size()
    assert max(w for w in (16, 8, 4, 2, 1) if pitch % w == 0) == width
    sidx = _runs([3, SPAN + 2, 1, 9], rng, rows=50)
    got = tkernel.gather_rows(t_table, torch.from_numpy(sidx))
    assert torch.equal(got, t_table[torch.from_numpy(sidx).long()])
    if dtype != "uint8":
        want = jkernel.gather_rows(jnp.asarray(table).astype(dtype),
                                   jnp.asarray(sidx))
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want, np.float32))


def test_gather_rows_from_a_misaligned_table_view(rng):
    """A contiguous table view two bytes into its buffer (on the card: the
    "vec" route at 2-byte accesses) gathers what a copy of it gathers."""
    buf = torch.from_numpy(rng.standard_normal(1 + 40 * 8).astype(
        np.float32)).to(torch.bfloat16)
    view = buf[1:].view(40, 8)
    assert view.is_contiguous() and \
        view.data_ptr() - buf.data_ptr() == view.element_size()
    sidx = torch.from_numpy(_runs([4, 1, SPAN + 1], rng, rows=40))
    assert torch.equal(tkernel.gather_rows(view, sidx),
                       view.clone()[sidx.long()])
