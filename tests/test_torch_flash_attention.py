"""Port parity for B6, flash attention: ``repro_torch``'s op (the kernel's
plain version, as it runs for CPU tensors) against the JAX package's three
routes to the same function — the dense oracle ``attention_ref``, the
Pallas kernel in interpret mode and the XLA-path
``repro.models.layers.flash_attention`` — on the same numpy inputs.

Tolerances are the reference tests' own (tests/kernels/
test_flash_attention.py): float32 3e-5, bf16 2e-2."""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as jops
from repro.kernels.flash_attention.ref import attention_ref as jref
from repro.models import layers as jlayers
from repro_torch import convert
from repro_torch.kernels._build import CSRC
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


# --- The tensor-core kernel's arithmetic: P split into terms of bf16, and
# the out_dtype keyword. Small versions of chip_smoke.py's ATTN_CASES:
# (S, hd, causal, window).
SPLIT_CASES = {
    "serve_like": (256, 128, True, None),
    "window_20": (300, 64, True, 20),
    "bidir_hd80": (200, 80, False, None),
    "ragged_hd128": (250, 128, True, None),
    "window_3": (200, 128, True, 3),
}


# The tensor-core kernel's term count, stated once, in its source.
P_TERMS = int(re.search(r"constexpr int kPTerms = (\d+);",
                        (CSRC / "flash_attention.cu").read_text()).group(1))


def split_p(p, dtype, terms):
    """The kernel's split: ``p`` (float32) as ``terms`` tensors of
    ``dtype``, each the remainder of the ones before (exact in float32),
    rounded once; their float32 sum approximates ``p``."""
    out, rest = [], p
    for _ in range(terms):
        out.append(rest.to(dtype))
        rest = rest - out[-1].float()
    return out


def _softmax_rows(case, seed):
    """Dense float32 P, its row sums and V (float64) for one (batch,
    head) on bf16-valued q, k, v, as the kernel sees them."""
    S, hd, causal, window = SPLIT_CASES[case]
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal((S, hd)).astype(
        np.float32)).to(torch.bfloat16).double() for _ in range(3))
    s = (q @ k.T) * hd ** -0.5
    pos = torch.arange(S)
    mask = torch.ones((S, S), dtype=torch.bool)
    if causal:
        mask &= pos[None, :] <= pos[:, None]
    if window is not None:
        mask &= pos[None, :] > pos[:, None] - window
    s = torch.where(mask, s, float("-inf"))
    p = torch.exp(s - s.amax(-1, keepdim=True)).float()   # float32 P
    return p, p.double().sum(-1, keepdim=True), v


@pytest.mark.parametrize("terms,bound", [(2, 2.0 ** -16), (3, 2.0 ** -24)])
def test_split_of_p_reconstructs_p(terms, bound):
    rng = np.random.default_rng(3)
    p = torch.from_numpy(np.exp(-rng.exponential(3.0, 100_000)).astype(
        np.float32))
    parts = split_p(p, torch.bfloat16, terms)
    assert len(parts) == terms and all(t.dtype == torch.bfloat16
                                       for t in parts)
    got = sum(t.double() for t in parts)
    rel = ((got - p.double()).abs() / p.double()).max()
    assert float(rel) <= bound


@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_split_p_keeps_attention_within_3e5_where_one_rounding_does_not(
        case):
    """P V with P split into bf16 terms (exact float64 products, as the
    tensor cores accumulate exact bf16 products in float32) stays within
    the reference's 3e-5 of the float32 result; P rounded once to bf16
    does not. This is why the kernel splits P."""
    worst = {}
    for seed in range(3):
        p, l, v = _softmax_rows(case, seed)
        want = (p.double() @ v) / l
        for terms in (1, 2, P_TERMS):
            parts = split_p(p, torch.bfloat16, terms)
            got = sum(t.double() for t in parts) @ v / l
            err = float((got - want).abs().max())
            worst[terms] = max(worst.get(terms, 0.0), err)
    assert worst[1] > 3e-5, worst
    assert worst[2] <= 3e-5 and worst[P_TERMS] <= 3e-5, worst
    assert worst[P_TERMS] <= worst[2]


@pytest.mark.parametrize("dtype,bad", [
    (torch.bfloat16, torch.float16), (torch.bfloat16, torch.float64),
    (torch.bfloat16, torch.int32), (torch.bfloat16, "float32"),
    (torch.float16, torch.bfloat16), (torch.float32, torch.bfloat16)])
def test_out_dtype_rejects_what_it_does_not_take(dtype, bad):
    q = torch.zeros((1, 8, 4, 32), dtype=dtype)
    k = v = torch.zeros((1, 8, 2, 32), dtype=dtype)
    with pytest.raises(ValueError, match="out_dtype"):
        tkernel.flash_attention_fwd(q, k, v, out_dtype=bad)
    with pytest.raises(ValueError, match="out_dtype"):
        tkernel.flash_attention_plain(q, k, v, out_dtype=bad)
    assert tkernel.LIB.launches == 0


@pytest.mark.parametrize("case", ["bf16", "ragged_window", "hd80_bidir"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_float32_output_rounds_once_to_the_default_output(case, dtype):
    """``out_dtype=torch.float32`` is the same computation stored
    unrounded: rounded once, it is the default output bit for bit."""
    B, S, H, KV, hd, causal, window, qb, kb, _ = CASES[case]
    _, (tq, tk, tv) = _qkv(case, seed=4)
    tq, tk, tv = (t.to(dtype) for t in (tq, tk, tv))
    kw = dict(causal=causal, window=window, q_block=qb, kv_block=kb)
    got32 = tkernel.flash_attention_fwd(tq, tk, tv, out_dtype=torch.float32,
                                        **kw)
    assert got32.dtype == torch.float32 and got32.shape == (B, S, H, hd)
    default = tkernel.flash_attention_fwd(tq, tk, tv, **kw)
    same = tkernel.flash_attention_fwd(tq, tk, tv, out_dtype=dtype, **kw)
    assert default.dtype == dtype
    assert torch.equal(got32.to(dtype).view(torch.int16),
                       default.view(torch.int16))
    assert torch.equal(same.view(torch.int16), default.view(torch.int16))
    # and the float32 output agrees with the JAX package's oracle on the
    # same (converted) inputs within the float32 tolerance
    q, k, v = (jnp.asarray(t.float().numpy()) for t in (tq, tk, tv))
    want = jref(q, k, v, causal=causal, window=window)
    np.testing.assert_allclose(got32.numpy(), np.asarray(want, np.float32),
                               rtol=3e-5, atol=3e-5)


def test_alignment_check_of_the_tensor_core_route():
    """The tensor-core kernel copies 16-byte pieces of each row: a row
    stride or base that is not a multiple of 16 bytes makes the wrapper
    copy the tensor first."""
    q = torch.zeros((1, 8, 4, 64), dtype=torch.bfloat16)
    assert tkernel._aligned(q)
    wide = torch.zeros((1, 8, 4, 65), dtype=torch.bfloat16)
    assert not tkernel._aligned(wide[..., 1:])       # 2-byte offset
    assert not tkernel._aligned(wide[..., :64])      # 130-byte rows
    assert tkernel._aligned(torch.zeros((1, 8, 4, 72),
                                        dtype=torch.bfloat16)[..., 8:])
