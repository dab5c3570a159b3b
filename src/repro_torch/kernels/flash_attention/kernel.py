"""Flash attention — the DMA engine applied to KV streaming (B6).

``flash_attention_fwd(q, k, v, causal=..., window=..., out_dtype=...)`` is
GQA attention in the model layout ``(B, S, H, hd)``: float32 scores, a
running max and sum, float32 output accumulators, a causal, sliding-window
or bidirectional mask, and the output in q's dtype (or float32, unrounded,
with ``out_dtype=torch.float32``). On a CUDA tensor it launches a kernel of
``csrc/flash_attention.cu``, chosen by dtype: bf16 and f16 go to the
tensor-core kernel (wgmma, P split into ``kPTerms`` terms of the input
type; entry ``flash_attention_fwd_tc``), float32 to the
CUDA-core kernel (float32 FMAs on tiles staged by cp.async, one
instantiation per head dim; entry ``flash_attention_fwd``);
``LIB.entry_launches`` counts each route. On a CPU tensor it runs
``flash_attention_plain``, the
blocked online-softmax loop of the reference's XLA path
(``repro.models.layers.flash_attention``), whose result does not depend on
its block sizes beyond float32 summation order. The backward, on every
device, is autograd through that plain version (``FlashAttention``).
Counterpart of ``repro.kernels.flash_attention.kernel``; unlike that Pallas op, any S >= 1
is taken.
"""

from __future__ import annotations

import torch

from repro_torch.kernels._build import F32, I32, I64, P, CudaLibrary

LIB = CudaLibrary("flash_attention", {
    "flash_attention_fwd": (P, P, P, P, I32, I32, I32, I32, I32, I32, I32,
                            F32, I64, I64, I64, I64, I64, I64, I64, I64, I64,
                            P),
    "flash_attention_fwd_tc": (P, P, P, P, I32, I32, I32, I32, I32, I32, I32,
                               F32, I32, I32, I64, I64, I64, I64, I64, I64,
                               I64, I64, I64, P)})
# The C entry of each input dtype: the tensor cores for bf16 and f16, the
# CUDA cores for float32 (TF32 would round q and k far beyond 3e-5).
ROUTES = {torch.float32: "flash_attention_fwd",
          torch.bfloat16: "flash_attention_fwd_tc",
          torch.float16: "flash_attention_fwd_tc"}
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
MAX_HEAD_DIM = 128
Q_TILE = 64                       # query rows of one block of the kernel
MAX_Q_TILES = 65535               # the grid's y extent
# The finite mask of both reference paths: -inf - (-inf) would make the
# running-max correction NaN.
NEG = -0.7 * torch.finfo(torch.float32).max


def flash_attention_plain(q, k, v, *, causal: bool = True, window=None,
                          q_block: int = 512, kv_block: int = 1024,
                          out_dtype=None):
    """Blocked online-softmax attention in torch: q blocks outer, kv blocks
    inner, float32 throughout, so the score matrix never exists beyond one
    (q_block, kv_block) tile per (batch, head). KV blocks that the mask
    leaves no live key in are skipped (their only effect would be
    probabilities that a later live block's correction factor zeroes).
    The result is rounded once to ``out_dtype`` (None: q's dtype)."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = hd ** -0.5
    q_block, kv_block = min(q_block, S), min(kv_block, S)
    qg = q.reshape(B, S, KV, G, hd).permute(0, 2, 3, 1, 4)   # (B,KV,G,S,hd)
    kg = k.permute(0, 2, 1, 3)                                # (B,KV,S,hd)
    vg = v.permute(0, 2, 1, 3)
    out_dtype = _out_dtype(q, out_dtype)
    out = torch.empty((B, KV, G, S, hd), dtype=out_dtype, device=q.device)
    for q0 in range(0, S, q_block):
        q1 = min(q0 + q_block, S)
        qb = qg[:, :, :, q0:q1].float()
        q_pos = torch.arange(q0, q1, device=q.device)[:, None]
        o = torch.zeros((B, KV, G, q1 - q0, hd), dtype=torch.float32,
                        device=q.device)
        m = torch.full((B, KV, G, q1 - q0), float("-inf"),
                       dtype=torch.float32, device=q.device)
        l = torch.zeros_like(m)
        k_first = 0 if window is None else max(0, q0 - window + 1)
        k_end = min(S, q1) if causal else S
        for k0 in range(k_first // kv_block * kv_block, k_end, kv_block):
            k1 = min(k0 + kv_block, S)
            kb, vb = kg[:, :, k0:k1].float(), vg[:, :, k0:k1].float()
            s = torch.einsum("bkgqd,bkcd->bkgqc", qb, kb) * scale
            k_pos = torch.arange(k0, k1, device=q.device)[None, :]
            mask = torch.ones((q1 - q0, k1 - k0), dtype=torch.bool,
                              device=q.device)
            if causal:
                mask &= k_pos <= q_pos
            if window is not None:
                mask &= k_pos > q_pos - window
            s = torch.where(mask, s, NEG)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            o = o * corr[..., None] + torch.einsum("bkgqc,bkcd->bkgqd", p, vb)
            m = m_new
        out[:, :, :, q0:q1] = (o / l.clamp_min(1e-37)[..., None]).to(
            out_dtype)
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, hd)


def _out_dtype(q, out_dtype) -> torch.dtype:
    """None means q's dtype; q's dtype and float32 are taken."""
    if out_dtype is None:
        return q.dtype
    if out_dtype not in (q.dtype, torch.float32):
        raise ValueError(f"out_dtype {out_dtype!r}: need None, {q.dtype} or "
                         f"torch.float32")
    return out_dtype


def _aligned(t: torch.Tensor) -> bool:
    """Every row of t (hd elements, stride 1) starts 16-byte aligned."""
    size = t.element_size()
    return t.data_ptr() % 16 == 0 and all(
        (st * size) % 16 == 0 for st in t.stride()[:3])


def _staged(*ts: torch.Tensor) -> tuple:
    """Each tensor as the kernels take it: itself where every row starts
    16-byte aligned, else a contiguous copy. Both kernels stage rows by
    16-byte cp.async copies; a fresh tensor is aligned, a view at an odd
    offset or with an odd row pitch is not."""
    return tuple(t if _aligned(t) else t.clone(
        memory_format=torch.contiguous_format) for t in ts)


def _check(q, k, v, window) -> None:
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}: need (B,S,H,hd) and two "
                         f"(B,S,KV,hd)")
    B, S, H, hd = q.shape
    if k.shape[:2] != (B, S) or k.shape[3] != hd or H % k.shape[2]:
        raise ValueError(f"k and v {tuple(k.shape)} do not fit q "
                         f"{tuple(q.shape)} (H a multiple of KV)")
    if hd % 16 or not 16 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim {hd}: the kernel takes a multiple of 16 "
                         f"in [16, {MAX_HEAD_DIM}]")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v of {q.dtype}, {k.dtype}, {v.dtype}: need "
                         f"one of {sorted(map(str, DTYPES))}")
    if window is not None and window < 1:
        raise ValueError(f"window {window} must be None or >= 1")
    if not q.device == k.device == v.device:
        raise ValueError(f"q on {q.device}, k on {k.device}, v on {v.device}")
    if q.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"no kernel for device {q.device}")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window=None,
                        q_block: int = 512, kv_block: int = 1024,
                        out_dtype=None) -> torch.Tensor:
    """Attention of q ``(B,S,H,hd)`` over k, v ``(B,S,KV,hd)``; returns a new
    contiguous ``(B,S,H,hd)`` tensor in ``out_dtype`` (None: q's dtype;
    ``torch.float32`` stores the float32 result unrounded).

    The three share one float dtype (float32, bf16 or f16) and one device;
    H is a multiple of KV; hd a multiple of 16 up to 128; ``window`` None
    or >= 1. Any layout whose head_dim axis has stride 1 and whose rows
    start 16-byte aligned runs without a copy; any other is copied
    first. ``q_block`` and
    ``kv_block`` are the plain version's tiles (CPU tensors, and the
    backward on any device); the kernels' are fixed. Anything else raises
    ``ValueError``. Differentiable through ``FlashAttention``.
    """
    _check(q, k, v, window)
    return FlashAttention.apply(q, k, v, causal, window, q_block, kv_block,
                                _out_dtype(q, out_dtype))


class FlashAttention(torch.autograd.Function):
    """B6 under autograd. The forward launches the kernel (its plain
    version on a CPU tensor), which autograd cannot follow; the backward
    recomputes the attention through ``flash_attention_plain`` under
    autograd, from the saved q, k and v, on every device and for every
    dtype, and returns its gradients. The reference has no Pallas
    backward either: it trains through its XLA attention."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_block, kv_block, out_dtype):
        ctx.save_for_backward(q, k, v)
        ctx.opts = dict(causal=causal, window=window, q_block=q_block,
                        kv_block=kv_block, out_dtype=out_dtype)
        return _forward(q, k, v, **ctx.opts)

    @staticmethod
    def backward(ctx, grad):
        wanted = ctx.needs_input_grad[:3]
        qkv = [t.detach().requires_grad_(w)
               for t, w in zip(ctx.saved_tensors, wanted)]
        with torch.enable_grad():
            out = flash_attention_plain(*qkv, **ctx.opts)
        grads = iter(torch.autograd.grad(
            out, [t for t, w in zip(qkv, wanted) if w], grad))
        return (*(next(grads) if w else None for w in wanted),
                None, None, None, None, None)


def _forward(q, k, v, *, causal, window, q_block, kv_block,
             out_dtype) -> torch.Tensor:
    """The forward of checked inputs: the plain version for CPU and
    ``meta`` tensors, else the kernel of q's dtype."""
    if q.device.type in ("cpu", "meta"):
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     q_block=q_block, kv_block=kv_block,
                                     out_dtype=out_dtype)
    B, S, H, hd = q.shape
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("the head_dim axis of q, k and v must have stride 1")
    if B * H >= 1 << 31 or -(-S // Q_TILE) > MAX_Q_TILES:
        raise ValueError(f"B*H={B * H}, S={S} exceed the kernel's grid")
    out = torch.empty((B, S, H, hd), dtype=out_dtype, device=q.device)
    if out.numel() == 0:
        return out
    entry = ROUTES[q.dtype]
    q, k, v = _staged(q, k, v)
    route_args = ()
    if entry == "flash_attention_fwd_tc":
        route_args = (DTYPES[q.dtype], int(out_dtype == torch.float32))
    LIB.launch(entry, q.data_ptr(), k.data_ptr(), v.data_ptr(),
               out.data_ptr(), B, S, H, k.shape[2], hd, int(causal),
               0 if window is None else int(window), hd ** -0.5, *route_args,
               *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
               torch.cuda.current_stream(q.device).cuda_stream)
    return out
