"""Port parity for ``repro_torch.models.layers`` (CPU, plain versions of
the kernels) against ``repro.models.layers`` on the same numpy inputs.

Tolerances: float32 within 1e-6; bf16 within one bf16 ulp of the
reference's result beyond that float32 tolerance (where a result is a sum
that cancels to near zero, the two frameworks' float32 summation orders
alone differ by many ulps of the tiny result before either rounds to
bf16); gathers, ``set`` scatters and KV appends exact; ``add`` scatters
within float32 reassociation (1e-5)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.config import MemoryControllerConfig as JMC
from repro.core.config import SchedulerConfig as JSched
from repro.models import layers as jl
from repro_torch import convert
from repro_torch.core.config import MemoryControllerConfig as TMC
from repro_torch.core.config import SchedulerConfig as TSched
from repro_torch.models import layers as tl


def _pair(a, dtype="float32"):
    j = jnp.asarray(a).astype(dtype)
    return j, convert.to_tensor(np.asarray(j), "cpu")


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32), np.float64)


F32_TOL = 1e-6


def _close(got, want, dtype):
    """float32: within F32_TOL; bf16: within one ulp of the larger
    magnitude beyond that float32 tolerance."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)
        return
    _, exp = np.frexp(np.maximum(np.abs(got), np.abs(want)))
    ulp = np.ldexp(1.0, np.maximum(exp - 8, -133))
    excess = np.abs(got - want) - ulp - F32_TOL * (1 + np.abs(want))
    assert excess.max() <= 0, f"beyond one bf16 ulp by {excess.max()}"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm(dtype, rng):
    jx, tx = _pair(rng.standard_normal((3, 5, 64)) * 3, dtype)
    jw, tw = _pair(rng.standard_normal(64), dtype)
    got = tl.rms_norm(tx, tw)
    assert got.dtype == tx.dtype
    _close(got, jl.rms_norm(jx, jw), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope(dtype, rng):
    jx, tx = _pair(rng.standard_normal((2, 7, 4, 32)), dtype)
    pos = rng.integers(0, 4000, (2, 7)).astype(np.int32)
    got = tl.rope(tx, torch.from_numpy(pos), 10_000.0)
    want = jl.rope(jx, jnp.asarray(pos), 10_000.0)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_swiglu(dtype, rng):
    jx, tx = _pair(rng.standard_normal((6, 32)), dtype)
    ws = [_pair(rng.standard_normal(s) / np.sqrt(s[0]), dtype)
          for s in ((32, 48), (32, 48), (48, 32))]
    got = tl.swiglu(tx, *(t for _, t in ws))
    want = jl.swiglu(jx, *(j for j, _ in ws))
    if dtype == "float32":
        _close(got, want, dtype)
    else:
        # three bf16 matmuls and a bf16 product round at other places in
        # the two frameworks: the reference tests' bf16 bound
        np.testing.assert_allclose(_np(got), _np(want), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("group", [1, 2, 7])
def test_decode_attention(group, dtype, rng):
    B, C, KV, hd = 3, 20, 2, 16
    jq, tq = _pair(rng.standard_normal((B, KV * group, hd)), dtype)
    jk, tk = _pair(rng.standard_normal((B, C, KV, hd)), dtype)
    jv, tv = _pair(rng.standard_normal((B, C, KV, hd)), dtype)
    valid = np.arange(C)[None, :] < np.array([[1], [13], [20]])
    got = tl.decode_attention(tq, tk, tv, torch.from_numpy(valid))
    want = jl.decode_attention(jq, jk, jv, jnp.asarray(valid))
    assert got.dtype == tq.dtype
    _close(got, want, dtype)


def _mc(enabled):
    return (JMC(scheduler=JSched(enabled=enabled)),
            TMC(scheduler=TSched(enabled=enabled)))


@pytest.mark.parametrize("shape", [(), (40,), (3, 24), (2, 1)])
@pytest.mark.parametrize("enabled", [True, False])
def test_mc_embed_is_exact(shape, enabled, rng):
    jmc, tmc = _mc(enabled)
    jt, tt = _pair(rng.standard_normal((50, 16)), "bfloat16")
    toks = rng.integers(0, 50, shape).astype(np.int32)
    toks.reshape(-1)[:3] = toks.reshape(-1)[0]           # a run
    got = tl.mc_embed(tt, torch.from_numpy(toks), tmc)
    want = jl.mc_embed(jt, jnp.asarray(toks), jmc)
    assert got.shape == want.shape == (*shape, 16)
    np.testing.assert_array_equal(_np(got), _np(want))
    plain = tl.mc_embed(tt, torch.from_numpy(toks), tmc, use_kernels=False)
    assert torch.equal(plain, got)


@pytest.mark.parametrize("mode", ["set", "add"])
@pytest.mark.parametrize("enabled", [True, False])
def test_mc_scatter(mode, enabled, rng):
    jmc, tmc = _mc(enabled)
    jt, tt = _pair(rng.standard_normal((30, 8)))
    toks = rng.integers(0, 30, (4, 16)).astype(np.int32)
    vals = rng.standard_normal((4, 16, 8)).astype(np.float32)
    got = tl.mc_scatter(tt, torch.from_numpy(toks), torch.from_numpy(vals),
                        tmc, mode=mode)
    want = jl.mc_scatter(jt, jnp.asarray(toks), jnp.asarray(vals), jmc,
                         mode=mode)
    if mode == "set":
        np.testing.assert_array_equal(_np(got), _np(want))
    else:
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)
    assert not torch.equal(got, tt)          # a new table; tt unchanged
    np.testing.assert_array_equal(_np(tt), _np(jt))


@pytest.mark.parametrize("slot", [0, 5, 9])
@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_mc_kv_append_is_an_in_place_slot_copy(slot, dtype, rng):
    """The port writes the cache in place; the reference returns a new
    one: the contents agree exactly, at the ring buffer's last slot too."""
    jbuf, tbuf = _pair(rng.integers(-100, 100, (2, 10, 3, 4)), dtype)
    jnew, tnew = _pair(rng.integers(-100, 100, (2, 1, 3, 4)), dtype)
    want = jl.mc_kv_append(jbuf, jnew, slot, JMC(), axis=1)
    got = tl.mc_kv_append(tbuf, tnew, slot, TMC(), axis=1)
    assert got is tbuf
    np.testing.assert_array_equal(_np(got), _np(want))
    # the scale rows of an int8 cache are appended along the same axis
    jsc, tsc = _pair(rng.standard_normal((2, 10, 3)))
    jns, tns = _pair(rng.standard_normal((2, 1, 3)))
    np.testing.assert_array_equal(
        _np(tl.mc_kv_append(tsc, tns, slot, TMC())),
        _np(jl.mc_kv_append(jsc, jns, slot, JMC())))


def test_mc_kv_append_past_the_buffer_raises():
    """The reference's dynamic_update_slice clamps an out-of-range slot
    (writing another position); the port refuses it."""
    buf = torch.zeros((1, 4, 2))
    with pytest.raises((IndexError, RuntimeError)):
        tl.mc_kv_append(buf, torch.ones((1, 1, 2)), 4, TMC())
