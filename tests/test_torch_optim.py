"""Port parity for the optimizer substrate (``repro_torch.optim``, on the
CPU): the reference's tests/test_optim.py on the port (all but the
compressed all-reduce, which comes with the mesh), and the port against
``repro.optim`` on the same inputs: ``lr_schedule`` over a whole schedule,
N AdamW steps from the same params and gradient stream (clipping, warmup
and decay engaged), and the int8 quantizer.

Tolerances: float32 rtol 1e-5, atol 1e-7 (XLA's and torch's float32
``pow``, ``cos`` and ``sqrt`` may differ in the last bit, and ten steps
carry it); a bf16 parameter within one bf16 ulp of the reference's (its
float32 update may round the other way); int8 codes exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim.adamw import OptimizerConfig as JConfig
from repro.optim.adamw import adamw_update as jadamw_update
from repro.optim.adamw import init_opt_state as jinit_opt_state
from repro.optim.adamw import lr_schedule as jlr_schedule
from repro.optim.compress import compress_int8 as jcompress_int8
from repro_torch import convert
from repro_torch.models.params import leaves, map_tree
from repro_torch.optim import (OptimizerConfig, adamw_update,
                               compress_int8, decompress_int8,
                               global_norm, init_opt_state, init_residuals,
                               lr_schedule)

RTOL, ATOL = 1e-5, 1e-7


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


# ---------------------------------------------------------------------------
# The reference's tests/test_optim.py, on the port
# ---------------------------------------------------------------------------

def test_adamw_optimizes_quadratic():
    params = {"w": torch.randn(8, generator=_gen())}
    target = torch.arange(8.0)
    cfg = OptimizerConfig(peak_lr=0.1, warmup_steps=1, total_steps=200,
                          weight_decay=0.0)
    opt = init_opt_state(params)

    def loss_fn(p):
        return torch.sum((p["w"] - target) ** 2)

    loss0 = float(loss_fn(params))
    for _ in range(100):
        w = params["w"].detach().requires_grad_()
        (g,) = torch.autograd.grad(loss_fn({"w": w}), [w])
        params, opt, _ = adamw_update({"w": g}, opt, params, cfg)
    assert float(loss_fn(params)) < 0.1 * loss0
    assert int(opt["step"]) == 100


def test_grad_clipping_bounds_update():
    params = {"w": torch.zeros(4)}
    cfg = OptimizerConfig(peak_lr=1e-2, warmup_steps=0, clip_norm=1.0)
    opt = init_opt_state(params)
    huge = {"w": torch.full((4,), 1e9)}
    p2, _, metrics = adamw_update(huge, opt, params, cfg)
    assert float(metrics["grad_norm"]) > 1e9 - 1
    assert torch.isfinite(p2["w"]).all()
    assert float(p2["w"].abs().max()) < 1.0


def test_lr_schedule_shape():
    cfg = OptimizerConfig(peak_lr=1e-3, warmup_steps=10, total_steps=100,
                          min_lr_ratio=0.1)
    lrs = [float(lr_schedule(torch.tensor(s), cfg)) for s in range(101)]
    assert lrs[0] == 0.0
    np.testing.assert_allclose(lrs[10], 1e-3, rtol=1e-5)
    assert all(a >= b - 1e-12 for a, b in zip(lrs[10:], lrs[11:]))
    np.testing.assert_allclose(lrs[100], 1e-4, rtol=1e-3)


def test_weight_decay_only_on_matrices():
    g = _gen()
    w2 = torch.randn(4, 4, generator=g) * 10
    b1 = torch.randn(4, generator=g) * 10
    params = {"w": w2, "b": b1}
    cfg = OptimizerConfig(peak_lr=1e-2, warmup_steps=0, weight_decay=1.0)
    opt = init_opt_state(params)
    zero_g = map_tree(torch.zeros_like, params)
    p2, _, _ = adamw_update(zero_g, opt, params, cfg)
    assert float((p2["b"] - b1).abs().max()) < 1e-6       # no decay
    assert float((p2["w"] - w2).abs().max()) > 1e-4       # decayed


def test_int8_compression_error_bounded():
    g = torch.randn(1024, generator=_gen()) * 3.0
    q, scale = compress_int8(g)
    back = decompress_int8(q, scale)
    assert q.dtype == torch.int8
    max_err = float((back - g).abs().max())
    assert max_err <= float(scale) / 2 + 1e-6    # half-ulp rounding bound


# ---------------------------------------------------------------------------
# Against the reference
# ---------------------------------------------------------------------------

def test_update_is_functional():
    """The arguments are not changed: the step returns new trees."""
    params = {"w": torch.randn(3, 3, generator=_gen()), "b": torch.ones(3)}
    before = map_tree(torch.clone, params)
    opt = init_opt_state(params)
    grads = map_tree(torch.ones_like, params)
    new, state, _ = adamw_update(grads, opt, params, OptimizerConfig(
        warmup_steps=0))
    for a, b in zip(leaves(params), leaves(before)):
        assert torch.equal(a, b)
    assert int(opt["step"]) == 0 and int(state["step"]) == 1
    assert not torch.equal(new["w"], params["w"])
    assert state["m"]["w"].dtype == torch.float32


def test_lr_schedule_matches_reference():
    cfg = dict(peak_lr=3e-3, min_lr_ratio=0.2, warmup_steps=7,
               total_steps=50)
    steps = np.arange(0, 60, dtype=np.int32)
    want = np.asarray(jlr_schedule(jnp.asarray(steps), JConfig(**cfg)))
    got = lr_schedule(torch.from_numpy(steps), OptimizerConfig(**cfg))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=1e-12)


def _tree(rng):
    """A parameter tree with matrices (decayed), a vector and a 3-D stack,
    as numpy float32."""
    return {"embed": {"table": rng.standard_normal((16, 8))},
            "layers": {"w": rng.standard_normal((2, 8, 8)) * 0.1,
                       "ln": 1 + 0.1 * rng.standard_normal(8)},
            "head": rng.standard_normal((8, 16)) * 0.1}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_steps_match_reference(dtype):
    """Ten steps from the same params and gradients (float32, drawn per
    step from a seed; the global norm above ``clip_norm`` at some steps,
    below at others); params, both moments, step, grad_norm and lr after
    every step."""
    rng = np.random.default_rng(0)
    init = map_tree(lambda a: a.astype(np.float32), _tree(rng))
    cfg = dict(peak_lr=1e-2, warmup_steps=3, total_steps=20,
               weight_decay=0.1, clip_norm=2.0)
    jparams = jax.tree.map(lambda a: jnp.asarray(a, dtype), init)
    tparams = map_tree(lambda a: convert.to_tensor(
        np.asarray(jnp.asarray(a, dtype)), "cpu"), init)
    jopt, topt = jinit_opt_state(jparams), init_opt_state(tparams)
    for step in range(10):
        g = map_tree(lambda a: rng.standard_normal(a.shape).astype(
            np.float32) * (0.3 if step % 2 else 1.0), init)
        jparams, jopt, jm = jadamw_update(
            jax.tree.map(jnp.asarray, g), jopt, jparams, JConfig(**cfg))
        tparams, topt, tm = adamw_update(
            map_tree(torch.from_numpy, g), topt, tparams,
            OptimizerConfig(**cfg))
        assert int(topt["step"]) == int(jopt["step"]) == step + 1
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=RTOL)
        for tree in ("m", "v"):
            for t, j in zip(leaves(topt[tree]), jax.tree.leaves(jopt[tree])):
                np.testing.assert_allclose(t.numpy(), np.asarray(j),
                                           rtol=RTOL, atol=ATOL)
        for t, j in zip(leaves(tparams), jax.tree.leaves(jparams)):
            assert str(t.dtype).endswith(dtype)
            j = np.asarray(j.astype(jnp.float32))
            if dtype == "float32":
                np.testing.assert_allclose(t.numpy(), j, rtol=RTOL,
                                           atol=ATOL)
            else:   # one bf16 ulp: 2^-7 of the magnitude
                ulp = np.exp2(np.floor(np.log2(np.abs(j) + 1e-30)) - 7)
                assert (np.abs(t.float().numpy() - j) <= ulp).all()
    want = np.sqrt(sum(np.square(x, dtype=np.float64).sum()
                       for x in leaves(g)))
    assert float(global_norm(map_tree(torch.from_numpy, g))) == \
        pytest.approx(want, rel=1e-6)


def test_int8_codes_match_reference():
    g = (np.random.default_rng(1).standard_normal(4096) * 3.0).astype(
        np.float32)
    jq, jscale = jcompress_int8(jnp.asarray(g))
    tq, tscale = compress_int8(torch.from_numpy(g))
    assert float(tscale) == float(jscale)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))


def test_init_residuals_are_float32_zeros():
    params = {"a": torch.ones(2, 3, dtype=torch.bfloat16),
              "b": {"c": torch.ones(4)}}
    res = init_residuals(params)
    assert [t.dtype for t in leaves(res)] == [torch.float32] * 2
    assert [t.shape for t in leaves(res)] == [t.shape for t in
                                              leaves(params)]
    assert not any(t.any() for t in leaves(res))
