"""Transformer block forwards (prefill and decode paths) for the dense family.

Counterpart of the attention and MLP parts of ``repro.models.blocks``;
MoE (``moe_ffn``) and Mamba (``mamba_forward`` / ``mamba_decode``) come
with their slices. The reference's ``shard`` calls are identities on one
device and are dropped. Caches are mutated in place by ``attn_decode``
(the KV append is a slot copy, ``layers.mc_kv_append``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers


class AttnCache(NamedTuple):
    k: torch.Tensor          # (B, C, KV, hd) — C = max_len or SWA window
    v: torch.Tensor


class QuantAttnCache(NamedTuple):
    """int8 KV cache with per-(position, head) scales (kv_cache_dtype)."""

    k: torch.Tensor          # (B, C, KV, hd) int8
    v: torch.Tensor          # (B, C, KV, hd) int8
    k_scale: torch.Tensor    # (B, C, KV) f32
    v_scale: torch.Tensor    # (B, C, KV) f32


def quantize_kv(x: torch.Tensor):
    """Symmetric per-(.., head) int8 over the head_dim axis."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1) / 127.0 + 1e-12
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127).to(
        torch.int8)
    return q, scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype):
    return (q.float() * scale[..., None]).to(dtype)


# ---------------------------------------------------------------------------
# Attention block
# ---------------------------------------------------------------------------

def attn_forward(p, x, cfg: ArchConfig, positions: torch.Tensor):
    """Full-sequence attention (train / prefill). Returns (out, kv)."""
    B, S, _ = x.shape
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    xn = layers.rms_norm(x, p["ln"])
    q = (xn @ p["wq"]).reshape(B, S, h, hd)
    k = (xn @ p["wk"]).reshape(B, S, kv, hd)
    v = (xn @ p["wv"]).reshape(B, S, kv, hd)
    q = layers.rope(q, positions, cfg.rope_theta)
    k = layers.rope(k, positions, cfg.rope_theta)
    out = layers.flash_attention(q, k, v, causal=cfg.causal,
                                 window=cfg.attn_window,
                                 q_block=cfg.attn_q_block,
                                 kv_block=cfg.attn_kv_block,
                                 use_kernels=cfg.use_kernels)
    return out.reshape(B, S, h * hd) @ p["wo"], AttnCache(k=k, v=v)


def attn_prefill_cache(kv: AttnCache, cfg: ArchConfig, seq_len: int,
                       max_len: int):
    """Convert prefill K/V into the serve cache layout (ring for SWA,
    int8 quantization when configured).

    Handles an optional leading stacked-layers axis (seq axis is -3).
    """
    w = cfg.attn_window
    if w is None or seq_len < w:
        pad = (0, 0, 0, 0, 0, (max_len if w is None else w) - seq_len)
        k, v = F.pad(kv.k, pad), F.pad(kv.v, pad)
    else:
        # ring buffer holding the last `w` tokens, slot = position % w
        shift = seq_len % w
        k = torch.roll(kv.k[..., -w:, :, :], shift, dims=-3)
        v = torch.roll(kv.v[..., -w:, :, :], shift, dims=-3)
    if cfg.kv_cache_dtype == "int8":
        kq, ks = quantize_kv(k)
        vq, vs = quantize_kv(v)
        return QuantAttnCache(kq, vq, ks, vs)
    return AttnCache(k, v)


def attn_decode(p, x, cache, cur_len: int, cfg: ArchConfig):
    """One-token attention against the cache; returns (out, cache).

    ``cur_len`` is the number of tokens already in the cache; the new token
    occupies position ``cur_len``. The new K/V row is written into
    ``cache`` in place, which is returned. Accepts either a plain
    ``AttnCache`` or a ``QuantAttnCache`` (int8 storage, dequantized at
    read).
    """
    B = x.shape[0]
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    C = cache.k.shape[1]
    w = cfg.attn_window
    xn = layers.rms_norm(x, p["ln"])
    pos = torch.full((B, 1), cur_len, dtype=torch.int32, device=x.device)
    q = layers.rope((xn @ p["wq"]).reshape(B, 1, h, hd), pos, cfg.rope_theta)
    k = layers.rope((xn @ p["wk"]).reshape(B, 1, kv, hd), pos, cfg.rope_theta)
    v = (xn @ p["wv"]).reshape(B, 1, kv, hd)

    slot = cur_len % C if w is not None else cur_len

    def append(buf, new):
        # KV append = the controller's bulk-write request class (fig7w).
        return layers.mc_kv_append(buf, new, slot, cfg.mc, axis=1)

    if isinstance(cache, QuantAttnCache):
        kq, ks = quantize_kv(k)
        vq, vs = quantize_kv(v)
        cache = QuantAttnCache(
            k=append(cache.k, kq), v=append(cache.v, vq),
            k_scale=append(cache.k_scale, ks),
            v_scale=append(cache.v_scale, vs))
        full_k = dequantize_kv(cache.k, cache.k_scale, x.dtype)
        full_v = dequantize_kv(cache.v, cache.v_scale, x.dtype)
    else:
        cache = AttnCache(append(cache.k, k), append(cache.v, v))
        full_k, full_v = cache.k, cache.v

    valid = (torch.arange(C, device=x.device) < min(cur_len + 1, C)).expand(
        B, C)
    out = layers.decode_attention(q[:, 0], full_k, full_v, valid)
    return out.reshape(B, h * hd) @ p["wo"], cache


# ---------------------------------------------------------------------------
# Dense MLP
# ---------------------------------------------------------------------------

def mlp_forward(p, x):
    xn = layers.rms_norm(x, p["ln"])
    return layers.swiglu(xn, p["w_gate"], p["w_up"], p["w_down"])
