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


def cu_constant(name: str) -> int:
    """A ``constexpr int`` of the kernels' source, stated once there."""
    return int(re.search(rf"constexpr int {name} = (\d+);",
                         (CSRC / "flash_attention.cu").read_text()).group(1))


# The tensor-core kernel's term count.
P_TERMS = cu_constant("kPTerms")


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


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
def test_misaligned_views_are_copied_before_launch(dtype):
    """Both kernels stage 16-byte pieces of each row by cp.async (the
    float32 route too, since its redesign): the wrapper hands them a
    contiguous copy of a view whose rows do not start 16-byte aligned,
    and an aligned tensor as it is."""
    per16 = 16 // torch.empty((), dtype=dtype).element_size()
    wide = torch.randn((1, 8, 4, 65)).to(dtype)
    for view in (wide[..., 1:], wide[..., :64]):   # offset; row pitch
        assert not tkernel._aligned(view)
        (staged,) = tkernel._staged(view)
        assert tkernel._aligned(staged) and staged.is_contiguous()
        assert staged.data_ptr() != view.data_ptr()
        assert torch.equal(staged, view)
    padded = torch.randn((1, 8, 4, 64 + per16)).to(dtype)[..., per16:]
    fresh = torch.zeros((1, 8, 4, 64), dtype=dtype)
    for t in (padded, fresh):
        assert tkernel._aligned(t)
        assert tkernel._staged(t)[0] is t


# --- The float32 kernel's walk and arithmetic (flash_fwd_kernel), in numpy
# float32. Its layout: up to hd kF32SmallHd, blocks of 256 query rows and
# row groups of 8 lanes; above, 128 rows and 16 lanes; 8 rows a row group,
# 32 lanes a warp. A block walks the kTile-key tiles from its first live
# key's to its last's; a warp skips a tile in which none of its rows has a
# live key and masks element by element only where the tile reaches past
# S, the diagonal or the window's edge for one of its rows, else takes
# every score. Scores are scaled by hd^-0.5 * log2(e) (every exponential
# an exp2), each row keeps its running max, and each of its lanes its own
# part of the running sum (keys tx, tx + lanes, ... of each tile), the
# parts summed by xor shuffles at the end. Small versions of
# chip_smoke.py's float32 ATTN_CASES: (B, S, H, KV, hd, causal, window).
F32_TILE = cu_constant("kTile")
F32_SMALL_HD = cu_constant("kF32SmallHd")


def f32_layout(hd: int) -> tuple:
    """(query rows a block, lanes a row group, query rows a warp)."""
    small = hd <= F32_SMALL_HD
    lanes = 8 if small else 16
    return (256 if small else 128), lanes, 8 * 32 // lanes


F32_CASES = {
    "ragged_group7": (1, 200, 7, 1, 80, True, None),
    "single_token": (2, 1, 16, 2, 128, True, None),
    "bidir_window40": (1, 150, 4, 2, 64, False, 40),
    "encoder_hd80": (1, 256, 2, 2, 80, False, None),
    "causal_window66_hd128": (1, 300, 4, 2, 128, True, 66),
    "ragged_hd112": (1, 170, 4, 2, 112, True, None),
    "causal_window34_hd16": (1, 290, 2, 1, 16, True, 34),
}


def f32_kernel_model(q, k, v, causal, window):
    """The float32 kernel's walk, its warps' skip and edge predicates and
    its per-tile order on numpy float32 ``(B, S, H, hd)`` q and ``(B, S,
    KV, hd)`` k, v (rows past S zero, as the kernel's copies fill them)."""
    f32 = np.float32
    B, S, H, hd = q.shape
    G = H // k.shape[2]
    rows, lanes, wrows = f32_layout(hd)
    w = window or 0
    scale_log2 = f32(hd ** -0.5) * f32(1.4426950408889634)
    neg = f32(-0.7) * np.finfo(f32).max
    n_tiles = -(-S // F32_TILE)
    pad_to = max(n_tiles * F32_TILE, -(-S // rows) * rows)
    qp, kp, vp = (np.pad(t, ((0, 0), (0, pad_to - S), (0, 0), (0, 0)))
                  for t in (q, k, v))
    out = np.full_like(q, np.nan)
    for b in range(B):
        for h in range(H):
            kh, vh = kp[b, :, h // G], vp[b, :, h // G]
            for q0 in range(0, S, rows):
                k_last = min(S - 1, q0 + rows - 1) if causal else S - 1
                k_first = max(0, q0 - w + 1) if w else 0
                for w0 in range(q0, min(q0 + rows, S), wrows):
                    qi = np.arange(w0, w0 + wrows)[:, None]
                    m = np.full(wrows, neg, f32)
                    l = np.zeros((wrows, lanes), f32)
                    acc = np.zeros((wrows, hd), f32)
                    for t in range(k_first // F32_TILE,
                                   k_last // F32_TILE + 1):
                        k0 = t * F32_TILE
                        if ((causal and k0 > w0 + wrows - 1) or
                                (w and k0 + F32_TILE - 1 <= w0 - w)):
                            continue
                        edge = (k0 + F32_TILE > S or
                                (causal and k0 + F32_TILE - 1 > w0) or
                                (w and k0 <= w0 + wrows - 1 - w))
                        keys = slice(k0, k0 + F32_TILE)
                        x = (qp[b, w0:w0 + wrows, h] @ kh[keys].T) \
                            * scale_log2
                        if edge:
                            j = k0 + np.arange(F32_TILE)[None, :]
                            live = j < S
                            if causal:
                                live = live & (j <= qi)
                            if w:
                                live = live & (j > qi - w)
                            x = np.where(live, x, neg)
                        m_new = np.maximum(m, x.max(1))
                        corr = np.exp2(m - m_new)
                        p = np.exp2(x - m_new[:, None]).astype(f32)
                        parts = p.reshape(wrows, -1, lanes)
                        psum = parts[:, 0]
                        for c in range(1, parts.shape[1]):
                            psum = psum + parts[:, c]
                        l = l * corr[:, None] + psum
                        acc = acc * corr[:, None] + p @ vh[keys]
                        m = m_new
                    off = lanes // 2
                    while off:
                        l = l + l[:, np.arange(lanes) ^ off]
                        off //= 2
                    n = min(wrows, S - w0)
                    out[b, w0:w0 + n, h] = (
                        acc / np.maximum(l[:, :1], f32(1e-37)))[:n]
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("case", sorted(F32_CASES))
def test_float32_kernel_order_stays_within_3e5_of_the_plain_version(
        case, seed):
    """The float32 kernel's walk, predicates and summation order (its
    numpy model) against
    ``flash_attention_plain`` and the JAX package's oracle on the same
    inputs, within the reference's float32 3e-5."""
    B, S, H, KV, hd, causal, window = F32_CASES[case]
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for shape in ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd)))
    got = f32_kernel_model(q, k, v, causal, window)
    assert got.dtype == np.float32 and np.isfinite(got).all()
    plain = tkernel.flash_attention_plain(
        *(torch.from_numpy(t) for t in (q, k, v)), causal=causal,
        window=window)
    np.testing.assert_allclose(got, plain.numpy(), rtol=3e-5, atol=3e-5)
    want = jref(*(jnp.asarray(t) for t in (q, k, v)), causal=causal,
                window=window)
    np.testing.assert_allclose(got, np.asarray(want), rtol=3e-5, atol=3e-5)
