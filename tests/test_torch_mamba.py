"""Port parity for the Mamba-2 (SSD) mixer (``repro_torch.models.blocks``:
``mamba_forward``, ``mamba_decode``, ``MambaCache``, on the CPU) against
``repro.models.blocks`` on the same float32 params and inputs.

Outputs and every cache leaf at rtol = atol = 1e-4 (two frameworks'
float32 products and cumulative sums in another order); the chunked
forward is also held to itself across chunk sizes and to a stepwise
``mamba_decode`` at the reference's own 1e-4."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.core.capture import TraceCapture as JCapture
from repro.models import blocks as jblocks
from repro.models import build_lm as jbuild_lm
from repro.models.sharding import make_rules
from repro_torch import convert
from repro_torch.core.capture import TraceCapture as TCapture
from repro_torch.models import blocks as tblocks

ARCH = "mamba2_2p7b"     # smoke: d_model 64, 4 heads of 32, state 16, chunk 16
TOL = dict(rtol=1e-4, atol=1e-4)


@functools.lru_cache(maxsize=None)
def _layer0():
    jcfg = dataclasses.replace(jget_arch(ARCH, smoke=True),
                               param_dtype="float32")
    params = jbuild_lm(jcfg).init(jax.random.key(0))
    return jax.tree.map(lambda t: np.asarray(t[0]),
                        params["layers"]["pos0"]["mamba"])


def _setup(chunk=None):
    jcfg = dataclasses.replace(jget_arch(ARCH, smoke=True),
                               param_dtype="float32")
    if chunk is not None:
        jcfg = dataclasses.replace(
            jcfg, ssm=dataclasses.replace(jcfg.ssm, chunk=chunk))
    tcfg = convert.arch_config_from_dict(dataclasses.asdict(jcfg))
    leaves = _layer0()
    return (jcfg, tcfg, jax.tree.map(jnp.asarray, leaves),
            convert.lm_params(leaves, "cpu"))


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(got, want, what):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), err_msg=what, **TOL)


def test_params_keep_float32_leaves_in_bf16():
    """``a_log`` and ``dt_bias`` stay float32 in a bf16 model; the
    conversion keeps every leaf's dtype."""
    jcfg = jget_arch(ARCH, smoke=True)
    jp = jbuild_lm(jcfg).init(jax.random.key(1))["layers"]["pos0"]["mamba"]
    tp = convert.lm_params(jax.tree.map(np.asarray, jp), "cpu")
    for k, v in jp.items():
        assert str(tp[k].dtype).endswith(str(v.dtype)), k
    assert tp["a_log"].dtype == tp["dt_bias"].dtype == torch.float32
    assert tp["w_zx"].dtype == torch.bfloat16


@pytest.mark.parametrize("S", [32, 23, 5, 1])
def test_mamba_forward_matches_reference(S):
    """Two chunks, a ragged tail (23: padded with dt = 0), one short chunk
    (5 < chunk) and one token; the output and the four cache leaves."""
    jcfg, tcfg, jp, tp = _setup()
    x = _x((2, S, jcfg.d_model))
    want, wc = jblocks.mamba_forward(jp, jnp.asarray(x), jcfg,
                                     make_rules(None), None)
    got, gc = tblocks.mamba_forward(tp, torch.from_numpy(x), tcfg)
    assert isinstance(gc, tblocks.MambaCache)
    _close(got, want, "out")
    for f in tblocks.MambaCache._fields:
        g, w = getattr(gc, f), getattr(wc, f)
        assert g.shape == w.shape and str(g.dtype).endswith(str(w.dtype)), f
        _close(g, w, f)


def test_mamba_decode_matches_reference():
    """Eight steps from a prefill's cache, the cache carried on each side."""
    jcfg, tcfg, jp, tp = _setup()
    x = _x((3, 20, jcfg.d_model), seed=1)
    steps = _x((8, 3, jcfg.d_model), seed=2)
    _, wc = jblocks.mamba_forward(jp, jnp.asarray(x), jcfg,
                                  make_rules(None), None)
    _, gc = tblocks.mamba_forward(tp, torch.from_numpy(x), tcfg)
    for t in range(8):
        want, wc = jblocks.mamba_decode(jp, jnp.asarray(steps[t]), wc, jcfg,
                                        make_rules(None), None)
        got, gc = tblocks.mamba_decode(tp, torch.from_numpy(steps[t]), gc,
                                       tcfg)
        _close(got, want, f"step {t}")
        for f in tblocks.MambaCache._fields:
            _close(getattr(gc, f), getattr(wc, f), f"step {t} {f}")


def test_ssd_chunk_size_invariance():
    """The chunked SSD gives the same result for any chunk size."""
    outs = []
    x = torch.from_numpy(_x((2, 32, 64), seed=3))
    for chunk in (4, 8, 16, 32):
        _, tcfg, _, tp = _setup(chunk)
        out, cache = tblocks.mamba_forward(tp, x, tcfg)
        outs.append((out, cache.ssm))
    for out, ssm in outs[1:]:
        _close(out, outs[0][0], "out")
        _close(ssm, outs[0][1], "ssm")


@pytest.mark.parametrize("S", [37, 16])
def test_chunked_forward_matches_stepwise_decode(S):
    """``mamba_decode`` from a zero state, one token at a time, gives the
    chunked forward's outputs and final state (37: two chunks and a
    ragged tail)."""
    _, tcfg, _, tp = _setup()
    x = torch.from_numpy(_x((2, S, 64), seed=4))
    want, wc = tblocks.mamba_forward(tp, x, tcfg)
    d_in, H, P, N = 128, 4, 32, 16
    cache = tblocks.MambaCache(torch.zeros(2, 3, d_in), torch.zeros(2, 3, N),
                               torch.zeros(2, 3, N), torch.zeros(2, H, P, N))
    outs = []
    for t in range(S):
        o, cache = tblocks.mamba_decode(tp, x[:, t], cache, tcfg)
        outs.append(o)
    _close(torch.stack(outs, 1), want.numpy(), "out")
    for f in tblocks.MambaCache._fields:
        _close(getattr(cache, f), getattr(wc, f).numpy(), f)


def test_ssm_state_update_record_matches_reference():
    jcfg, tcfg, jp, tp = _setup()
    x = _x((3, 4, jcfg.d_model), seed=5)
    _, wc = jblocks.mamba_forward(jp, jnp.asarray(x), jcfg,
                                  make_rules(None), None)
    _, gc = tblocks.mamba_forward(tp, torch.from_numpy(x), tcfg)
    with JCapture() as jcap:
        for t in range(2):
            _, wc = jblocks.mamba_decode(jp, jnp.asarray(x[:, t]), wc, jcfg,
                                         make_rules(None), None)
    with TCapture() as tcap:
        for t in range(2):
            _, gc = tblocks.mamba_decode(tp, torch.from_numpy(x[:, t]), gc,
                                         tcfg)
    want, got = jcap.rows(), tcap.rows()
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert tcap.op_counts() == jcap.op_counts() == {"ssm_state_update": 24}
    assert tcap.n_rows_total == jcap.n_rows_total
