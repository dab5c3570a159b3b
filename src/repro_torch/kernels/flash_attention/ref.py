"""Plain-torch oracle: dense masked attention in the model's (B,S,H,hd)
layout. Counterpart of ``repro.kernels.flash_attention.ref``."""

import math

import torch


def attention_ref(q, k, v, *, causal=True, window=None):
    """q: (B,S,H,hd); k,v: (B,S,KV,hd). Returns (B,S,H,hd).

    Scores in the inputs' dtype, then float32 softmax over a ``-1e30``
    mask, as the reference; the whole (S, S) score matrix is built."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(B, S, KV, G, hd)
    s = torch.einsum("bqkgd,bckd->bkgqc", qg, k).float()
    s = s / math.sqrt(hd)
    pos_q = torch.arange(S, device=q.device)[:, None]
    pos_k = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= pos_k <= pos_q
    if window is not None:
        mask &= pos_k > pos_q - window
    s = torch.where(mask, s, -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqc,bckd->bqkgd", p, v.float())
    return o.reshape(B, S, H, hd).to(q.dtype)
