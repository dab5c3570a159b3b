"""Shared NN layers: norms, RoPE, memory-efficient attention, embeddings.

Counterpart of ``repro.models.layers``. Attention comes in two forms:

* ``flash_attention`` — train/prefill path. With ``use_kernels`` (the
  config's default) it is kernel B6 for CUDA tensors
  (``repro_torch.kernels.flash_attention``) and its plain version, the
  blocked online-softmax loop of the reference's XLA path, for CPU
  tensors; with kernels off, the plain version on any device. Causal,
  bidirectional and sliding-window masks; the score matrix never
  materializes beyond one block.
* ``decode_attention`` — one-token serve path against a (possibly
  ring-buffered) KV cache, plain torch as in the reference (no kernel
  there).

Embedding traffic routes through the memory controller in both
directions: lookups via ``mc_embed`` (token ids stable-sorted per sequence
by the bitonic kernel B1 before the row gather B2) and table updates via
``mc_scatter`` (the embedding-gradient WRITE stream, batch-sorted and
coalesced per row by B3); ``mc_kv_append`` is the decode-step KV page write,
an in-place slot copy. The reference's trace-capture hooks
(``_capture_embed``, ``capture_mod``) come with ``core/capture.py``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core import scheduler
from repro_torch.core.config import MemoryControllerConfig
from repro_torch.core.controller import MemoryController
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.sorted_gather import kernel as sg_kernel

NEG = fa_kernel.NEG


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6):
    dtype = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * w.float()).to(dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """Rotary embedding. x: (..., S, H, hd); positions: (..., S)."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    angles = positions[..., None].float() * freqs            # (..., S, half)
    cos = torch.cos(angles)[..., None, :]                    # (..., S, 1, half)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def swiglu(x, w_gate, w_up, w_down):
    h = F.silu(x @ w_gate) * (x @ w_up)
    return h @ w_down


# ---------------------------------------------------------------------------
# Memory-efficient attention
# ---------------------------------------------------------------------------

def flash_attention(
    q: torch.Tensor,               # (B, S, H, hd)
    k: torch.Tensor,               # (B, S, KV, hd)
    v: torch.Tensor,               # (B, S, KV, hd)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    q_block: int = 512,
    kv_block: int = 1024,
    use_kernels: bool = True,
) -> torch.Tensor:
    """Online-softmax attention; O(S·block) memory instead of O(S²).

    ``q_block`` / ``kv_block`` tile the plain version; the result does not
    depend on them beyond float32 summation order."""
    if use_kernels:
        return fa_kernel.flash_attention_fwd(q, k, v, causal=causal,
                                             window=window, q_block=q_block,
                                             kv_block=kv_block)
    return fa_kernel.flash_attention_plain(q, k, v, causal=causal,
                                           window=window, q_block=q_block,
                                           kv_block=kv_block)


def decode_attention(
    q: torch.Tensor,               # (B, H, hd) — one new token per sequence
    cache_k: torch.Tensor,         # (B, Sc, KV, hd)
    cache_v: torch.Tensor,
    valid_mask: torch.Tensor,      # (B, Sc) bool — which cache slots attend
) -> torch.Tensor:
    B, H, hd = q.shape
    KV = cache_k.shape[2]
    G = H // KV
    scale = hd ** -0.5
    qg = q.reshape(B, KV, G, hd).float()
    s = torch.einsum("bkgd,bskd->bkgs", qg, cache_k.float()) * scale
    s = torch.where(valid_mask[:, None, None, :], s, NEG)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p, cache_v.float())
    return o.reshape(B, H, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# Controller-routed embedding
# ---------------------------------------------------------------------------

def mc_embed(table: torch.Tensor, tokens: torch.Tensor,
             mc: MemoryControllerConfig, *,
             use_kernels: bool = True) -> torch.Tensor:
    """Embedding gather through the memory controller's scheduler.

    Requests are stable-sorted *per sequence* (axis -1) — each sequence is
    one scheduler batch, matching the paper's bounded batch size. 1-D (and
    scalar) token streams — the decode-step path — are one sequence, so
    the whole stream forms a single scheduler batch instead of bypassing
    the controller. With ``use_kernels`` the sort is the bitonic network
    (B1) and the row gather the sorted-gather kernel (B2), their plain
    versions for CPU tensors. Value-identical to ``table[tokens]``.
    """
    d = table.shape[-1]
    if not mc.scheduler.enabled:
        return table.index_select(0, tokens.reshape(-1)).reshape(
            *tokens.shape, d)
    keys = tokens.reshape(-1) if tokens.ndim < 2 else \
        tokens.reshape(-1, tokens.shape[-1])
    sorted_tok, _, inv = scheduler.sort_requests(keys,
                                                 use_kernels=use_kernels)
    flat = sorted_tok.reshape(-1)
    gathered = sg_kernel.gather_rows(table, flat) if use_kernels \
        else table.index_select(0, flat)
    if keys.ndim == 2:   # unsort within each sequence's rows
        inv = inv + torch.arange(0, flat.shape[0], keys.shape[1],
                                 dtype=inv.dtype, device=inv.device)[:, None]
    return gathered.index_select(0, inv.reshape(-1)).reshape(*tokens.shape, d)


def mc_scatter(table: torch.Tensor, tokens: torch.Tensor,
               values: torch.Tensor, mc: MemoryControllerConfig,
               *, mode: str = "add", use_kernels: bool = True) -> torch.Tensor:
    """Embedding write through the memory controller's scheduler.

    The write-side twin of :func:`mc_embed`: the backward of an embedding
    lookup is an irregular scatter of per-token rows into the table
    (gradient accumulation, ``mode="add"``), the same WRITE stream the
    controller batch-sorts by row (B3). Value-identical to
    ``table.at[tokens].add(values)`` / last-writer-wins ``set``; returns a
    new table.
    """
    return MemoryController(mc, use_kernels=use_kernels,
                            device=table.device).scatter(
        table, tokens, values, mode=mode)


def mc_kv_append(buf: torch.Tensor, new: torch.Tensor, slot: int,
                 mc: MemoryControllerConfig, axis: int = 1) -> torch.Tensor:
    """One decode-step KV append — the controller's bulk-write request
    class: a cache row is a contiguous page, written whole.

    Copies ``new`` into ``buf`` at ``[slot, slot + new.shape[axis])``
    along ``axis`` *in place* and returns ``buf`` (the reference's
    ``dynamic_update_slice`` returns a new cache; copying a 2 GB cache per
    decode step is what the in-place write avoids). A slot range past the
    buffer raises, where the reference would clamp the slot. ``mc`` marks
    the request class for the capture hook, which comes with
    ``core/capture.py``; it never affects stored values.
    """
    buf.narrow(axis, slot, new.shape[axis]).copy_(new)
    return buf
