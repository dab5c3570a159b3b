"""Port parity for B3, the sorted scatter: ``repro_torch`` (the kernel's plain
version, as it runs for CPU tensors) against the JAX op with its Pallas
kernel in interpret mode and the in-order write-stream oracle.

Tolerances: ``set`` moves values and is bit-equal. ``add`` sums each run in
float32 in another association than the reference (rtol = atol = 1e-5 for
float32 tables); a bf16 table rounds that float32 sum once, and a sum that
differs in its last bits can round to the neighbouring bf16 value, so bf16
is held to one bf16 ulp.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.kernels.sorted_scatter import coalesce as jcoalesce
from repro.kernels.sorted_scatter import kernel as jkernel
from repro.kernels.sorted_scatter import ops as jops
from repro.kernels.sorted_scatter import ref as jref
from repro_torch import convert
from repro_torch.kernels.sorted_scatter import coalesce as tcoalesce
from repro_torch.kernels.sorted_scatter import kernel as tkernel
from repro_torch.kernels.sorted_scatter import ops as tops
from repro_torch.kernels.sorted_scatter import ref as tref

VOCAB, D = 256, 64          # yi-34b SMOKE_CONFIG widths


def _arrays(rng, dtype, shape):
    """A (VOCAB, D) table, ``shape`` ids with a long duplicate run, and
    values, as JAX arrays of ``dtype``."""
    idx = rng.integers(0, VOCAB, shape).astype(np.int32)
    idx.reshape(-1)[:8] = idx.reshape(-1)[-1]          # a run of 9
    if dtype == "int32":
        table = jnp.asarray(rng.integers(-50, 50, (VOCAB, D)), jnp.int32)
        vals = jnp.asarray(rng.integers(-50, 50, (*shape, D)), jnp.int32)
    else:
        table = jnp.asarray(rng.standard_normal((VOCAB, D)),
                            jnp.float32).astype(dtype)
        vals = jnp.asarray(rng.standard_normal((*shape, D)),
                           jnp.float32).astype(dtype)
    return table, jnp.asarray(idx), vals


def _port(*arrays):
    return [convert.to_tensor(np.asarray(a), "cpu") for a in arrays]


def _as_f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _bf16_ulps(got, want):
    """Max |got - want| in bf16 ulps of the larger magnitude."""
    a, b = _as_f32(got).astype(np.float64), _as_f32(want).astype(np.float64)
    mag = np.maximum(np.abs(a), np.abs(b))
    exp = np.floor(np.log2(np.where(mag > 0, mag, 1.0)))
    ulp = np.exp2(np.maximum(exp - 7, -133))
    return float((np.abs(a - b) / ulp).max())


def _assert_add_close(got, want, dtype):
    if dtype == "bfloat16":
        assert _bf16_ulps(got, want) <= 1.0
    else:
        np.testing.assert_allclose(_as_f32(got), _as_f32(want),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
@pytest.mark.parametrize("shape", [(40,), (4, 24)])
@pytest.mark.parametrize("use_bitonic", [False, True])
def test_set_matches_pallas_op_bit_for_bit(dtype, shape, use_bitonic, rng):
    table, idx, vals = _arrays(rng, dtype, shape)
    want = jops.sorted_scatter(table, idx, vals, use_bitonic=use_bitonic)
    t_table, t_idx, t_vals = _port(table, idx, vals)
    got = tops.sorted_scatter(t_table, t_idx, t_vals, use_bitonic=use_bitonic)
    assert got.dtype == t_table.dtype and got.shape == t_table.shape
    np.testing.assert_array_equal(_as_f32(got), _as_f32(want))
    np.testing.assert_array_equal(
        _as_f32(got), _as_f32(jref.scatter_ref(table, idx, vals)))
    assert torch.equal(got, tref.scatter_ref(t_table, t_idx, t_vals))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(40,), (4, 24)])
def test_add_matches_pallas_op(dtype, shape, rng):
    table, idx, vals = _arrays(rng, dtype, shape)
    want = jops.sorted_scatter(table, idx, vals, mode="add")
    t_table, t_idx, t_vals = _port(table, idx, vals)
    got = tops.sorted_scatter(t_table, t_idx, t_vals, mode="add")
    assert got.dtype == t_table.dtype
    _assert_add_close(got, want, dtype)
    _assert_add_close(got, jref.scatter_ref(table, idx, vals, "add"), dtype)
    _assert_add_close(got, tref.scatter_ref(t_table, t_idx, t_vals, "add"),
                      dtype)


@pytest.mark.parametrize("tdtype,vdtype", [
    ("bfloat16", "float32"), ("float16", "float32"), ("float32", "bfloat16"),
    ("int32", "int32"), ("int32", "float32"), ("float32", "int32")])
@pytest.mark.parametrize("use_bitonic", [False, True])
def test_add_of_another_value_dtype_matches_pallas_op(tdtype, vdtype,
                                                      use_bitonic, rng):
    """Values of another dtype than the table are cast to the accumulator
    ``promote_types(float32, table.dtype)``, summed there and rounded once
    (an int32 table truncates toward zero), as the reference's
    ``coalesce_add_runs`` does. Integer-valued addends keep every sum
    exact, so int32 tables are bit-equal; float tables as above."""
    table, idx, _ = _arrays(rng, "float32", (40,))
    if tdtype == "int32":
        table = jnp.asarray(rng.integers(-50, 50, (VOCAB, D)), jnp.int32)
    table = table.astype(tdtype)
    raw = rng.standard_normal((40, D)) * (4 if tdtype == "int32" else 1e-2)
    vals = jnp.asarray(np.round(raw * 4) / 4 if tdtype == "int32" else raw,
                       jnp.float32).astype(vdtype)
    want = jops.sorted_scatter(table, idx, vals, mode="add",
                               use_bitonic=use_bitonic)
    t_table, t_idx, t_vals = _port(table, idx, vals)
    got = tops.sorted_scatter(t_table, t_idx, t_vals, mode="add",
                              use_bitonic=use_bitonic)
    assert got.dtype == t_table.dtype
    if tdtype == "int32":
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    elif tdtype == "float16":      # one float16 ulp
        w16 = np.asarray(want).astype(np.float16)
        assert (np.abs(_as_f32(got) - w16.astype(np.float32))
                <= np.spacing(np.abs(w16)).astype(np.float32)).all()
    else:
        _assert_add_close(got, want, tdtype)
    assert torch.equal(got, tops.sorted_scatter(t_table, t_idx, t_vals,
                                                mode="add", backend="torch"))


@pytest.mark.parametrize("mode", ["set", "add"])
def test_scatter_rows_matches_pallas_kernel(mode, rng):
    """The kernel step alone on a presorted batch; for ``add`` the JAX
    kernel takes the runs folded by ``coalesce_add_runs`` beforehand,
    which the port's kernel fuses."""
    table, idx, vals = _arrays(rng, "float32", (48,))
    order = np.argsort(np.asarray(idx), kind="stable")
    sidx, svals = jnp.asarray(np.asarray(idx)[order]), vals[order]
    folded = (jcoalesce.coalesce_add_runs(table, sidx, svals)
              if mode == "add" else svals)
    want = jkernel.scatter_rows(table, sidx, folded)
    t_table, t_sidx, t_svals = _port(table, sidx, svals)
    got = tkernel.scatter_rows(t_table, t_sidx, t_svals, mode=mode)
    _assert_add_close(got, want, "float32")
    if mode == "set":
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_coalesce_add_runs_matches_reference(dtype, rng):
    table, idx, vals = _arrays(rng, dtype, (60,))
    order = np.argsort(np.asarray(idx), kind="stable")
    sidx, svals = jnp.asarray(np.asarray(idx)[order]), vals[order]
    want = jcoalesce.coalesce_add_runs(table, sidx, svals)
    got = tcoalesce.coalesce_add_runs(*_port(table, sidx, svals))
    assert got.dtype == convert.to_tensor(np.asarray(table), "cpu").dtype
    _assert_add_close(got, want, dtype)


@pytest.mark.parametrize("mode", ["set", "add"])
def test_kernel_and_torch_backends_agree(mode, rng):
    t_table, t_idx, t_vals = _port(*_arrays(rng, "float32", (3, 30)))
    a = tops.sorted_scatter(t_table, t_idx, t_vals, mode=mode,
                            backend="kernel")
    b = tops.sorted_scatter(t_table, t_idx, t_vals, mode=mode,
                            backend="torch")
    assert torch.equal(a, b)


def test_bf16_add_is_not_swallowed():
    """Runs accumulate in float32 and round once: 128 addends of 0.5 onto
    256 in bf16 give 320, where bf16 adds one at a time would stay 256."""
    table = torch.full((4, 2), 256.0, dtype=torch.bfloat16)
    vals = torch.full((128, 2), 0.5, dtype=torch.bfloat16)
    out = tops.sorted_scatter(table, torch.zeros(128, dtype=torch.int32),
                              vals, mode="add")
    assert out[0].float().tolist() == [320.0, 320.0]
    assert torch.equal(out[1:], table[1:])


@pytest.mark.parametrize("mode", ["set", "add"])
def test_table_is_not_changed_and_empty_batch(mode, rng):
    t_table, t_idx, t_vals = _port(*_arrays(rng, "float32", (20,)))
    before = t_table.clone()
    tops.sorted_scatter(t_table, t_idx, t_vals, mode=mode)
    assert torch.equal(t_table, before)
    out = tops.sorted_scatter(t_table, torch.zeros(0, dtype=torch.int32),
                              torch.zeros((0, D)), mode=mode)
    assert torch.equal(out, before)


def _bad(case):
    table, sidx = torch.zeros((8, 4)), torch.tensor([1, 1, 3])
    vals, mode = torch.ones((3, 4)), "set"
    if case == "unsorted":
        sidx = torch.tensor([3, 1, 1])
    elif case == "out_of_range":
        sidx = torch.tensor([1, 1, 8])
    elif case == "negative":
        sidx = torch.tensor([-1, 1, 3])
    elif case == "vals_dtype":
        vals = vals.double()
    elif case == "vals_shape":
        vals = torch.ones((3, 5))
    elif case == "add_int_table":      # int32 adds; int64 has no type code
        table, vals, mode = table.long(), vals.long(), "add"
    elif case == "mode":
        mode = "max"
    elif case == "strided_table":
        table = torch.zeros((4, 8)).t()
    return table, sidx, vals, mode


@pytest.mark.parametrize("case", ["unsorted", "out_of_range", "negative",
                                  "vals_dtype", "vals_shape", "add_int_table",
                                  "mode", "strided_table"])
def test_wrapper_rejects_what_the_kernel_does_not_take(case):
    table, sidx, vals, mode = _bad(case)
    with pytest.raises(ValueError):
        tkernel.scatter_rows(table, sidx, vals, mode=mode)


@settings(max_examples=25, deadline=None, derandomize=True)
@given(st.lists(st.integers(0, 7), min_size=1, max_size=120),
       st.sampled_from(["set", "add"]))
def test_property_duplicate_heavy_ids_match_write_stream(ids, mode):
    """Few distinct rows, long runs: the port equals the in-order write
    stream of both packages' oracles."""
    table = np.arange(16 * 4, dtype=np.float32).reshape(16, 4)
    idx = np.asarray(ids, np.int32)
    vals = (np.arange(len(ids), dtype=np.float32)[:, None]
            * np.ones((1, 4), np.float32))
    got = tops.sorted_scatter(torch.from_numpy(table), torch.from_numpy(idx),
                              torch.from_numpy(vals), mode=mode)
    want = jref.scatter_ref(jnp.asarray(table), jnp.asarray(idx),
                            jnp.asarray(vals), mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    if mode == "set":
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _hot_run_batch(seed=5, n_short=700, hot=5000, rows=512, d=24,
                   dtype=torch.float32):
    """A sorted batch with one run of ``hot`` slots among short runs (the
    hot token of an embedding-gradient batch), its table and values."""
    rng = np.random.default_rng(seed)
    idx = np.concatenate([rng.integers(0, rows, n_short),
                          np.full(hot, rows // 3)])
    sidx = torch.from_numpy(np.sort(idx, kind="stable").astype(np.int64))
    table = torch.from_numpy(rng.standard_normal((rows, d))).to(dtype)
    vals = torch.from_numpy(rng.standard_normal((idx.size, d))).to(dtype)
    return table, sidx, vals


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch", ["hot_run", "short_runs"])
def test_coalesce_add_runs_repeats_its_bits(dtype, batch):
    """The plain ``add`` sums each run with a segment sum in slot order, no
    atomics: two calls give the same bits, with one 5000-slot run among
    short runs and with short runs alone."""
    table, sidx, vals = _hot_run_batch(
        dtype=dtype, hot=5000 if batch == "hot_run" else 0)
    a = tcoalesce.coalesce_add_runs(table, sidx, vals)
    b = tcoalesce.coalesce_add_runs(table, sidx, vals)
    assert a.dtype == dtype and torch.equal(a, b)
    got = tkernel.scatter_rows_plain(table, sidx, vals, mode="add")
    assert torch.equal(got, tkernel.scatter_rows_plain(table, sidx, vals,
                                                       mode="add"))


def test_coalesce_add_runs_is_a_float32_per_run_sum():
    """Each slot's value is ``table[row] + Σrun`` summed in float32: within
    float32 reassociation of the float64 per-run sum, that is (run length
    + 1) · eps of the magnitudes summed, also for the 5000-slot run."""
    table, sidx, vals = _hot_run_batch()
    got = tcoalesce.coalesce_add_runs(table, sidx, vals).double()
    t64, v64, s = table.double(), vals.double(), sidx.numpy()
    for row in np.unique(s):
        run = np.flatnonzero(s == row)
        want = t64[row] + v64[run].sum(0)
        mag = t64[row].abs() + v64[run].abs().sum(0)
        bound = (run.size + 1) * np.finfo(np.float32).eps * mag
        assert bool(((got[run] - want).abs() <= bound).all()), row


def _runs_batch(case, rng):
    """Sorted indices of one shape that the span plan must cut right."""
    s = tkernel.SPAN
    if case == "one_run_of_all":
        return torch.full((4 * s + 3,), 7, dtype=torch.int64)
    if case in ("runs_of_span", "runs_of_span_plus_1", "runs_of_2span"):
        length = {"runs_of_span": s, "runs_of_span_plus_1": s + 1,
                  "runs_of_2span": 2 * s}[case]
        return torch.arange(5).repeat_interleave(length) * 3
    if case == "mixed":
        lengths = rng.choice([1, 2, s - 1, s, s + 1, 2 * s, 2 * s + 1,
                              3 * s + 5], 40)
        return torch.from_numpy(np.repeat(np.arange(40) * 2, lengths))
    # The main path's Zipf(1.1) token ids at a small width: 8 x 512 slots
    # over a 2000-row vocabulary, so the hottest runs span many spans.
    p = np.arange(1, 2001, dtype=np.float64) ** -1.1
    ids = rng.permutation(2000)[rng.choice(2000, 4096, p=p / p.sum())]
    return torch.from_numpy(np.sort(ids).astype(np.int32))


@pytest.mark.parametrize("case", ["one_run_of_all", "runs_of_span",
                                  "runs_of_span_plus_1", "runs_of_2span",
                                  "mixed", "zipf"])
def test_span_plan_cuts_each_long_run_into_its_spans(case, rng):
    """The plan that the CUDA kernels follow: runs of at most SPAN slots
    are short and get no span; every longer run is covered by its spans
    exactly once, in slot order, each span SPAN slots from the run's first
    slot (the last one fewer); each run names its table row; the lists
    stay inside ``plan_capacity`` (under 2n/SPAN spans)."""
    sidx = _runs_batch(case, rng)
    n, s = sidx.numel(), tkernel.SPAN
    plan = tkernel.span_plan_plain(sidx)
    _, lengths = torch.unique_consecutive(sidx, return_counts=True)
    starts = (torch.cumsum(lengths, 0) - lengths).tolist()
    want_short = [(a, a + n_ - 1) for a, n_ in zip(starts, lengths.tolist())
                  if n_ <= s]
    want_long = [(a, a + n_ - 1) for a, n_ in zip(starts, lengths.tolist())
                 if n_ > s]
    assert list(zip(plan.short_first.tolist(),
                    plan.short_last.tolist())) == want_short
    assert list(zip(plan.long_first.tolist(),
                    plan.long_last.tolist())) == want_long
    rows = sidx.tolist()
    assert plan.short_row.tolist() == [rows[a] for a, _ in want_short]
    assert plan.long_row.tolist() == [rows[a] for a, _ in want_long]
    spans = []
    for m, (a, e) in enumerate(want_long):
        k0 = plan.long_span0[m].item()
        want_spans = [(b, min(b + s - 1, e)) for b in range(a, e + 1, s)]
        got_spans = list(zip(plan.span_first.tolist(),
                             plan.span_last.tolist()))
        assert got_spans[k0:k0 + len(want_spans)] == want_spans
        spans += want_spans
    assert list(zip(plan.span_first.tolist(),   # every span, in slot order
                    plan.span_last.tolist())) == spans
    long_cap, span_cap = tkernel.plan_capacity(n)
    assert len(want_long) <= long_cap and len(spans) <= span_cap < 2 * n / s
    if case == "one_run_of_all":
        assert plan.short_first.numel() == 0 and len(spans) == -(-n // s)
    if case == "runs_of_span":
        assert plan.span_first.numel() == 0 and plan.long_first.numel() == 0
    if case in ("runs_of_span_plus_1", "runs_of_2span"):
        assert plan.long_span0.tolist() == [0, 2, 4, 6, 8]
        assert (plan.span_last - plan.span_first + 1).tolist() == [
            s, n // 5 - s] * 5
    # The spans' sums folded in span order are each run's sum: exact on
    # integer values.
    vals = torch.from_numpy(rng.integers(-50, 50, (n, 3)).astype(np.float64))
    got = torch.zeros((n, 3), dtype=torch.float64)
    for m, (a, e) in enumerate(want_long):
        k0 = plan.long_span0[m].item()
        for k in range(k0, k0 + -(-(e - a + 1) // s)):
            got[e] += vals[plan.span_first[k]:plan.span_last[k] + 1].sum(0)
    for a, e in want_short:
        got[e] = vals[a:e + 1].sum(0)
    table = torch.zeros((int(sidx.max()) + 1, 3), dtype=torch.float64)
    want = tcoalesce.coalesce_add_runs(table, sidx, vals)
    last = tkernel.last_of_run(sidx)
    assert torch.equal(got[last], want[last])


def test_plan_capacity_holds_at_the_bound():
    """The lists' lengths are bounds reached by some batch: runs of SPAN +
    1 slots give the most long runs, and then ceil(L / SPAN) = 2 spans
    each."""
    s = tkernel.SPAN
    for runs in (1, 2, 7):
        sidx = torch.arange(runs).repeat_interleave(s + 1)
        plan = tkernel.span_plan_plain(sidx)
        long_cap, span_cap = tkernel.plan_capacity(sidx.numel())
        assert plan.long_first.numel() == long_cap == runs
        assert plan.span_first.numel() == 2 * runs <= span_cap
