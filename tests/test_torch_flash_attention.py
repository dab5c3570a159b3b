"""Port parity for B6, flash attention: ``repro_torch``'s op (the kernel's
plain version, as it runs for CPU tensors) against the JAX package's three
routes to the same function — the dense oracle ``attention_ref``, the
Pallas kernel in interpret mode and the XLA-path
``repro.models.layers.flash_attention`` — on the same numpy inputs.

Tolerances are the reference tests' own (tests/kernels/
test_flash_attention.py): float32 3e-5, bf16 2e-2."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as jops
from repro.kernels.flash_attention.ref import attention_ref as jref
from repro.models import layers as jlayers
from repro_torch import convert
from repro_torch.kernels.flash_attention import kernel as tkernel
from repro_torch.kernels.flash_attention import ops as tops
from repro_torch.kernels.flash_attention import ref as tref

# (B, S, H, KV, hd, causal, window, q_block, kv_block, dtype)
CASES = {
    "gqa": (2, 128, 4, 2, 32, True, None, 128, 128, "float32"),
    "gqa_bidir": (2, 128, 4, 2, 32, False, None, 128, 128, "float32"),
    "mha": (1, 256, 8, 8, 16, True, None, 128, 128, "float32"),
    "mha_bidir": (1, 256, 8, 8, 16, False, None, 128, 128, "float32"),
    "mqa": (2, 128, 4, 1, 32, True, None, 128, 128, "float32"),
    "mqa_bidir": (2, 128, 4, 1, 32, False, None, 128, 128, "float32"),
    "window32": (1, 256, 4, 2, 32, True, 32, 64, 64, "float32"),
    "window64": (1, 256, 4, 2, 32, True, 64, 64, 64, "float32"),
    "window128": (1, 256, 4, 2, 32, True, 128, 64, 64, "float32"),
    "blocks32x128": (1, 128, 2, 2, 16, True, None, 32, 128, "float32"),
    "blocks128x32": (1, 128, 2, 2, 16, True, None, 128, 32, "float32"),
    "blocks64x64": (1, 128, 2, 2, 16, True, None, 64, 64, "float32"),
    "bf16": (1, 128, 4, 2, 32, True, None, 128, 128, "bfloat16"),
    "group7": (1, 128, 14, 2, 16, True, None, 64, 64, "float32"),
    "hd80_bidir": (1, 128, 4, 4, 80, False, None, 128, 128, "float32"),
    "window_past_S": (1, 128, 4, 2, 32, True, 300, 64, 64, "float32"),
    "ragged": (2, 100, 4, 2, 32, True, None, 32, 64, "float32"),
    "ragged_window": (1, 77, 4, 1, 16, True, 20, 16, 32, "float32"),
}
TOL = {"float32": 3e-5, "bfloat16": 2e-2}


def _qkv(case, seed=0):
    B, S, H, KV, hd, *_, dtype = CASES[case]
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(shape).astype(np.float32)
            for shape in ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd))]
    jx = [jnp.asarray(a).astype(dtype) for a in arrs]
    tx = [convert.to_tensor(np.asarray(a), "cpu") for a in jx]
    return jx, tx


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("route", ["ref", "pallas", "xla"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_port_matches_reference_route(case, route):
    B, S, H, KV, hd, causal, window, qb, kb, dtype = CASES[case]
    (q, k, v), (tq, tk, tv) = _qkv(case)
    got = tops.flash_attention(tq, tk, tv, causal=causal, window=window,
                               q_block=qb, kv_block=kb)
    assert got.dtype == tq.dtype and got.shape == (B, S, H, hd)
    if route == "ref":
        want = jref(q, k, v, causal=causal, window=window)
    elif route == "xla":
        want = jlayers.flash_attention(q, k, v, causal=causal, window=window,
                                       q_block=qb, kv_block=kb)
    elif S % qb or S % kb:
        # The Pallas op asserts that S divides by its blocks; the port
        # masks the ragged tail instead (ROADMAP C).
        with pytest.raises(AssertionError):
            jops.flash_attention(q, k, v, causal=causal, window=window,
                                 q_block=qb, kv_block=kb)
        want = jref(q, k, v, causal=causal, window=window)
    else:
        want = jops.flash_attention(q, k, v, causal=causal, window=window,
                                    q_block=qb, kv_block=kb, interpret=True)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=TOL[dtype],
                               atol=TOL[dtype])


@pytest.mark.parametrize("case", ["gqa", "window32", "group7", "ragged",
                                  "bf16"])
def test_port_oracle_matches_reference_oracle(case):
    _, _, _, _, _, causal, window, _, _, dtype = CASES[case]
    (q, k, v), (tq, tk, tv) = _qkv(case, seed=1)
    want = jref(q, k, v, causal=causal, window=window)
    got = tref.attention_ref(tq, tk, tv, causal=causal, window=window)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=TOL[dtype],
                               atol=TOL[dtype])


@pytest.mark.parametrize("case", ["window32", "ragged_window", "mqa_bidir"])
def test_plain_result_does_not_depend_on_its_blocks(case):
    _, _, _, _, _, causal, window, *_ = CASES[case]
    _, (tq, tk, tv) = _qkv(case, seed=2)
    outs = [tkernel.flash_attention_plain(tq, tk, tv, causal=causal,
                                          window=window, q_block=qb,
                                          kv_block=kb)
            for qb, kb in [(16, 16), (32, 128), (512, 1024), (7, 13)]]
    for out in outs[1:]:
        np.testing.assert_allclose(out.numpy(), outs[0].numpy(), rtol=3e-6,
                                   atol=3e-6)


def test_single_token_is_its_value():
    """S = 1: the one query attends its own key only."""
    _, (tq, tk, tv) = _qkv("gqa")
    q, k, v = tq[:, :1], tk[:, :1], tv[:, :1]
    out = tops.flash_attention(q, k, v)
    assert torch.equal(out, v.repeat_interleave(2, dim=2))


@pytest.mark.parametrize("bad", ["hd24", "hd144", "dtype", "window0",
                                 "kv_heads", "int"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    q = torch.zeros((1, 8, 4, 32))
    k = v = torch.zeros((1, 8, 2, 32))
    kw = {}
    if bad == "hd24":
        q, k, v = q[..., :24], k[..., :24], v[..., :24]
    elif bad == "hd144":
        q, k = torch.zeros((1, 8, 4, 144)), torch.zeros((1, 8, 2, 144))
        v = k
    elif bad == "dtype":
        k = k.to(torch.bfloat16)
    elif bad == "window0":
        kw["window"] = 0
    elif bad == "kv_heads":
        k = v = torch.zeros((1, 8, 3, 32))
    else:
        q, k, v = (t.to(torch.int32) for t in (q, k, v))
    with pytest.raises(ValueError):
        tkernel.flash_attention_fwd(q, k, v, **kw)
    assert tkernel.LIB.launches == 0
