"""Block forwards (train, prefill and decode paths): attention, the dense
MLP, the MoE FFN and the Mamba-2 (SSD) mixer.

Counterpart of ``repro.models.blocks`` (the MoE blocks in the
token-choice "tp" strategy); the hybrid family interleaves these blocks.
Full-sequence attention and the MLP multiply through ``layers.mm``, which
promotes a float32 x bf16 product as ``jnp`` does (the audio frontend's
float32 stream). The MoE dispatch is a literal instance
of the paper's memory scheduler: token→expert assignments are the request
stream, the expert id is the "DRAM row", capacity buffers are the DMA
staging buffers, and the dispatch reorders requests so all traffic to one
expert is serviced as a bulk transfer (``moe_ffn``). On a device mesh
(DTensor inputs, ``rules`` and ``mesh`` given) each of the reference's
``shard`` calls is a ``redistribute`` at the same place, and the blocks
with no tensor-parallel layout of their own run on each rank's batch
rows (``on_batch_shards``); off a mesh they are identities. Caches are
mutated in place by ``attn_decode`` (the KV append is a slot copy,
``layers.mc_kv_append``); ``mamba_decode`` returns a new state, which the
LM copies into its cache.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils import _pytree as pytree

from repro_torch import compat
from repro_torch.configs.base import ArchConfig
from repro_torch.core import capture as capture_mod
from repro_torch.models import layers
from repro_torch.models.params import mamba_dims
from repro_torch.models.sharding import (Rules, Spec, is_dtensor, mesh_shape,
                                         shard)


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


class MambaCache(NamedTuple):
    conv_x: torch.Tensor     # (B, 3, d_in) last conv taps
    conv_b: torch.Tensor     # (B, 3, N)
    conv_c: torch.Tensor     # (B, 3, N)
    ssm: torch.Tensor        # (B, H, P, N) recurrent state, float32


# ---------------------------------------------------------------------------
# Attention block
# ---------------------------------------------------------------------------

def attn_forward(p, x, cfg: ArchConfig, positions: torch.Tensor,
                 rules: Rules = None, mesh=None):
    """Full-sequence attention (train / prefill). Returns (out, kv)."""
    B, S, _ = x.shape
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    xn = layers.rms_norm(x, p["ln"])

    def heads(w, n, name):
        # on a mesh the product's columns are split over ``model`` (w_tp)
        # whatever the head count; laid out by whole heads first (or
        # replicated, where they do not divide the axis), they reshape
        y = shard(layers.mm(xn, w), rules, "batch", "seq", name, mesh=mesh)
        return y.reshape(B, S, n, hd)

    q = heads(p["wq"], h, "heads")
    k = heads(p["wk"], kv, "kv_heads")
    v = heads(p["wv"], kv, "kv_heads")
    q = layers.rope(q, positions, cfg.rope_theta)
    k = layers.rope(k, positions, cfg.rope_theta)
    q = shard(q, rules, "batch", "seq", "heads", None, mesh=mesh)
    k = shard(k, rules, "batch", "seq", "kv_heads", None, mesh=mesh)
    v = shard(v, rules, "batch", "seq", "kv_heads", None, mesh=mesh)
    out = layers.flash_attention(q, k, v, causal=cfg.causal,
                                 window=cfg.attn_window,
                                 q_block=cfg.attn_q_block,
                                 kv_block=cfg.attn_kv_block,
                                 use_kernels=cfg.use_kernels,
                                 rules=rules, mesh=mesh)
    out = layers.mm(out.reshape(B, S, h * hd), p["wo"])
    return shard(out, rules, "batch", "seq", "embed", mesh=mesh), \
        AttnCache(k=k, v=v)


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


def attn_decode(p, x, cache, cur_len: int, cfg: ArchConfig,
                rules: Rules = None, mesh=None):
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
        full_k = shard(cache.k, rules, "batch", "kv_seq", None, None,
                       mesh=mesh)
        full_v = shard(cache.v, rules, "batch", "kv_seq", None, None,
                       mesh=mesh)

    valid = (torch.arange(C, device=x.device) < min(cur_len + 1, C)).expand(
        B, C)
    if mesh is not None and is_dtensor(full_k):
        # each rank attends over the whole cache of its batch rows: the
        # kv_seq shards are all-gathered, not a softmax split over them
        b = batch_entry(rules, mesh, B)
        out = compat.shard_map(
            layers.decode_attention, mesh=mesh,
            in_specs=(rules.spec(b, None, None),
                      rules.spec(b, None, None, None),
                      rules.spec(b, None, None, None), rules.spec(b, None)),
            out_specs=rules.spec(b, None, None))(q[:, 0], full_k, full_v,
                                                 valid)
    else:
        out = layers.decode_attention(q[:, 0], full_k, full_v, valid)
    return out.reshape(B, h * hd) @ p["wo"], cache




# ---------------------------------------------------------------------------
# Dense / shared MLP
# ---------------------------------------------------------------------------

def mlp_forward(p, x, rules: Rules = None, mesh=None):
    xn = layers.rms_norm(x, p["ln"])
    h = F.silu(layers.mm(xn, p["w_gate"])) * layers.mm(xn, p["w_up"])
    h = shard(h, rules, "batch", "seq", "heads", mesh=mesh)
    return shard(layers.mm(h, p["w_down"]), rules, "batch", "seq", "embed",
                 mesh=mesh)


# ---------------------------------------------------------------------------
# MoE — the memory-controller scheduler at cluster scale
# ---------------------------------------------------------------------------

def capture_moe_dispatch(top_e, n_tokens: int, d_model: int,
                         itemsize: int) -> None:
    """Report a routed MoE layer's traffic into the active TraceCapture.

    The genuine multi-port view of expert dispatch (paper Fig. 2 /
    Nguyen et al.): **the expert id is the port** (``pe_id`` = expert —
    experts are the PEs contending for the channels), the request row is
    the *token's* activation row in the dispatch buffer region, READ on
    dispatch and WRITE on combine. ``top_e`` is ``(T, k)``; a tensor
    without data (meta or fake) skips the record, counted by the
    recorder. A tensor on the card is copied to the host, and only while
    a capture is active.
    """
    cap = capture_mod.active_capture()
    if cap is None:
        return
    te = capture_mod.concrete(top_e)
    if te is None:
        cap.n_skipped_traced += 1
        return
    te = te.astype(np.int64)
    T, k = te.shape
    row_bytes = int(d_model) * int(itemsize)
    name = f"moe_tokens:{int(n_tokens)}x{row_bytes}"
    tok = np.repeat(np.arange(T, dtype=np.int64), k)
    pe = te.reshape(-1)
    cap.record("moe_dispatch", name, int(n_tokens), row_bytes, tok,
               rw=0, pe_id=pe)
    cap.record("moe_combine", name, int(n_tokens), row_bytes, tok,
               rw=1, pe_id=pe)


def top_k_lower_first(probs: torch.Tensor, k: int):
    """The ``k`` largest entries of each row and their indices, ties
    broken toward the lower index as ``jax.lax.top_k`` does
    (``torch.topk`` promises no order among ties on CUDA)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_route(p, x, cfg: ArchConfig):
    """The router: returns ``(flat, logits, probs, top_p, top_e)`` for
    ``x`` (B, S, D): the normed tokens (T, D), float32 router logits and
    softmax (T, E), and each token's top-k renormalized probabilities and
    experts (T, k). The product runs in the parameter dtype and is cast
    afterwards, as in the reference."""
    m = cfg.moe
    B, S, D = x.shape
    flat = layers.rms_norm(x, p["ln"]).reshape(B * S, D)
    logits = (flat @ p["router"]).float()                  # (T, E)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = top_k_lower_first(probs, m.top_k)       # (T, k)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    return flat, logits, probs, top_p, top_e


def moe_capacity(cfg: ArchConfig, tokens_per_group: int,
                 no_drop: bool = False) -> int:
    """Per-group expert capacity: ``ceil(TG·k/E·cf)``, rounded up to a
    multiple of 128 once it is at least 64, at most TG; ``no_drop`` (the
    serving path) gives TG, a strict upper bound since a token selects
    an expert at most once."""
    m = cfg.moe
    TG = tokens_per_group
    if no_drop:
        return TG
    capacity = int(math.ceil(TG * m.top_k / m.num_experts
                             * m.capacity_factor))
    if capacity >= 64:       # round for even layout
        capacity = -(-capacity // 128) * 128
    return min(capacity, TG)


def moe_slots(top_e: torch.Tensor, num_groups: int, num_experts: int,
              capacity: int, dispatch: str = "sort"):
    """Place each assignment into its expert's capacity slot.

    ``top_e`` (T, k) splits into ``num_groups`` scheduler batches of
    T·k/G assignments each. Returns ``(pos_in_e, keep, slot)``, each
    (G, n) int64/bool: the assignment's arrival rank within its expert
    and group, whether it fits, and its slot (``capacity`` for a drop).

    ``"sort"`` is the scheduler: a stable sort by row id (expert), the
    slot the offset in the expert's run (its start from ``searchsorted``);
    stability keeps arrival order within an expert, so the slots equal the
    sequential-arrival semantics of ``"cumsum"``, the naive GShard one-hot
    prefix scan. Both give the same integers.
    """
    G = num_groups
    e_grp = top_e.reshape(G, -1)                           # (G, n)
    na = e_grp.shape[1]
    if dispatch == "sort":
        order = torch.argsort(e_grp, dim=-1, stable=True)
        e_sorted = torch.gather(e_grp, -1, order)
        experts = torch.arange(num_experts, device=top_e.device,
                               dtype=e_sorted.dtype).expand(G, num_experts)
        run_start = torch.searchsorted(e_sorted, experts.contiguous())
        pos_sorted = (torch.arange(na, device=top_e.device)[None, :]
                      - torch.gather(run_start, -1, e_sorted))
        pos_in_e = torch.empty_like(pos_sorted).scatter_(-1, order,
                                                          pos_sorted)
    elif dispatch == "cumsum":
        onehot = F.one_hot(e_grp, num_experts)
        pos_in_e = (torch.cumsum(onehot, dim=1) * onehot).sum(-1) - 1
    else:
        raise ValueError(f"unknown MoE dispatch {dispatch!r}")
    keep = pos_in_e < capacity
    slot = torch.where(keep, pos_in_e, capacity)           # drop slot = C
    return pos_in_e, keep, slot


def moe_aux(logits, probs, top_e, cfg: ArchConfig, mean=None):
    """Switch/ST-MoE auxiliary losses: load balance (E·Σ mean prob ·
    assignment share) and router z. The per-expert assignment counts are
    an integer sum (float atomics would change the bits from call to call
    on CUDA, and ``bincount`` there syncs with the host). ``mean`` turns
    a shard's means into the global batch's (the ``pmean`` over the data
    shards of equal size; None on one device)."""
    m = cfg.moe
    mean = mean or (lambda t: t)
    T = probs.shape[0]
    me = mean(probs.mean(0))                               # (E,)
    e = top_e.reshape(-1)
    counts = torch.zeros(m.num_experts, dtype=torch.int64,
                         device=e.device).scatter_add_(0, e,
                                                       torch.ones_like(e))
    ce = mean(counts.float() / (T * m.top_k))
    return {"load_balance": m.num_experts * torch.sum(me * ce),
            "router_z": m.router_z_coef * mean(torch.mean(
                torch.logsumexp(logits, dim=-1) ** 2))}


def moe_ffn(p, x, cfg: ArchConfig, *, no_drop: bool = False,
            dispatch: str = "sort", num_groups: int = 1,
            rules: Rules = None, mesh=None):
    """Token-choice top-k MoE with capacity buffers.

    Scheduler mapping (paper Fig. 2):
      requests   = (token, expert) assignments,
      row index  = expert id (the device memory region owning that
                   expert),
      batch      = one *group's* assignment set,
      reorder    = stable sort by row id; capacity slot = offset in the
                   expert's run (``dispatch="sort"``) — vs the naive
                   GShard one-hot prefix scan (``dispatch="cumsum"``),
      bulk xfer  = the buffer products against expert weights,
      writeback  = combine weighted by router prob, arrival order restored.

    ``num_groups`` partitions tokens into independent scheduler instances
    (GShard local groups); capacity and drops are per group, and
    ``num_groups=1`` is the global scheduler. A group count that does not
    divide the tokens falls back to 1. Returns (out, aux).

    On a ``mesh`` with ``num_groups`` the batch's data shards (the LM's
    ``_moe_groups``), group ``g`` is the rows of data shard ``g``, so each
    rank dispatches its own rows as one group, against whole expert
    weights, with the aux losses' means taken over the data shards; with
    one group every rank dispatches the whole batch (``on_batch_shards``).
    The reference's layout constraints on the dispatch buffers have no
    counterpart: each rank's buffers are its own tensors.
    """
    if mesh is not None and is_dtensor(x):
        batch = "batch" if num_groups > 1 else None

        def local(p, x):
            mean = (None if batch is None else functools.partial(
                compat.pmean, axes=_batch_axes(rules), mesh=mesh))
            return _moe_ffn_local(p, x, cfg, no_drop, dispatch, 1, mean)

        return on_batch_shards(local, p, x, rules=rules, mesh=mesh,
                               batch=batch, out_ndims=(3, 0, 0))
    return _moe_ffn_local(p, x, cfg, no_drop, dispatch, num_groups)


def _moe_ffn_local(p, x, cfg: ArchConfig, no_drop: bool, dispatch: str,
                   num_groups: int, mean=None):
    B, S, D = x.shape
    flat, logits, probs, top_p, top_e = moe_route(p, x, cfg)
    capture_moe_dispatch(top_e, B * S, D, x.element_size())
    y = moe_experts(p, flat, top_p, top_e, cfg, no_drop=no_drop,
                    dispatch=dispatch, num_groups=num_groups)
    return y.reshape(B, S, D), moe_aux(logits, probs, top_e, cfg, mean)


def _batch_axes(rules: Rules) -> tuple:
    b = rules.batch
    return () if b is None else ((b,) if isinstance(b, str) else tuple(b))


def batch_entry(rules: Rules, mesh, n: int):
    """``"batch"`` where ``n`` rows split evenly over the batch axes, else
    None (every rank takes the whole batch)."""
    shape = mesh_shape(mesh)
    dp = math.prod(shape[a] for a in _batch_axes(rules))
    return "batch" if n % dp == 0 else None


def on_batch_shards(fn, p, *xs, rules: Rules, mesh, batch="batch",
                    out_ndims=()):
    """``fn(p, *xs)`` on each rank's batch rows (``batch`` None: the
    whole batch) against whole weights ``p``, gathered at use (ZeRO-3).
    The blocks with no kernel and no tensor-parallel layout of their own
    (Mamba, the MoE's token-choice dispatch) run so on a mesh. ``xs`` and
    the outputs (a flat tree, one entry per ``out_ndims``: the dims of
    each; 0 for a replicated scalar) lead with their batch dim."""
    def spec(nd):
        return rules.spec(batch, *(None,) * (nd - 1)) if nd else Spec()

    x_specs = tuple(pytree.tree_map(lambda t: spec(t.ndim), x) for x in xs)
    outs = [spec(n) for n in out_ndims]
    return compat.shard_map(fn, mesh=mesh, in_specs=(Spec(),) + x_specs,
                            out_specs=outs)(p, *xs)


def dispatch_rows(flat: torch.Tensor, num_groups: int,
                  top_k: int) -> torch.Tensor:
    """Each token row of ``flat`` (T, D) repeated ``top_k`` times in
    arrival order, per group: (G, T·k/G, D), row ``j`` of group ``g``
    token ``j // top_k`` of that group. Built by expanding a new axis, so
    the backward sums each token's ``top_k`` row gradients in a fixed
    order (a reduction over that axis), where an index with repeats
    would accumulate them by ``index_put_`` in no fixed order on CUDA
    (ROADMAP C23)."""
    T, D = flat.shape
    TG = T // num_groups
    return flat.reshape(num_groups, TG, 1, D).expand(
        num_groups, TG, top_k, D).reshape(num_groups, TG * top_k, D)


def moe_experts(p, flat, top_p, top_e, cfg: ArchConfig, *,
                no_drop: bool = False, dispatch: str = "sort",
                num_groups: int = 1):
    """Dispatch, expert FFNs and combine for routed tokens: ``flat`` (T,
    D) normed tokens, ``top_p`` / ``top_e`` (T, k) their weights and
    experts (``moe_route``). Adds the shared experts. Returns (T, D).

    Dispatch writes each assignment's token row into slot ``slot`` of its
    expert's ``(C + 1)``-slot buffer; every dropped assignment goes to
    slot C, which is sliced off before the expert products, so no value
    depends on which of its duplicate writes lands.
    """
    m = cfg.moe
    T, D = flat.shape
    E = m.num_experts
    G = num_groups if T % max(1, num_groups) == 0 else 1
    TG = T // G
    capacity = moe_capacity(cfg, TG, no_drop)
    _, _, slot = moe_slots(top_e, G, E, capacity, dispatch)
    na = TG * m.top_k
    dest = top_e.reshape(G, na) * (capacity + 1) + slot    # (G, n)

    # dispatch: (G, E, C+1, D) buffers, one row per assignment
    upd = dispatch_rows(flat, G, m.top_k)                  # (G, n, D)
    buf = torch.zeros((G, E * (capacity + 1), D), dtype=flat.dtype,
                      device=flat.device)
    buf.scatter_(1, dest[..., None].expand(G, na, D), upd)
    buf = buf.view(G, E, capacity + 1, D)[:, :, :capacity]

    # bulk transfer: batched expert FFN (SwiGLU)
    hmid = F.silu(torch.einsum("gecd,edf->gecf", buf, p["w_gate"])) \
        * torch.einsum("gecd,edf->gecf", buf, p["w_up"])
    eout = torch.einsum("gecf,efd->gecd", hmid, p["w_down"])
    eout = F.pad(eout, (0, 0, 0, 1))                       # drop slot: 0

    # writeback: gather each assignment's result, weight, combine per token
    y = torch.gather(eout.reshape(G, E * (capacity + 1), D), 1,
                     dest[..., None].expand(G, na, D))
    y = y * top_p.reshape(G, na)[..., None].to(flat.dtype)
    y = y.reshape(G, TG, m.top_k, D).sum(2).reshape(T, D)

    if m.num_shared_experts:
        y = y + layers.swiglu(flat, p["shared_gate"], p["shared_up"],
                              p["shared_down"])
    return y


# ---------------------------------------------------------------------------
# Mamba2 (SSD) block
# ---------------------------------------------------------------------------

def _causal_conv(u, w, cache=None):
    """Depthwise causal conv, kernel 4. u: (B, S, C), w: (4, C).

    With ``cache`` (B, 3, C) the first taps come from previous context
    (decode path handles S=1)."""
    if cache is None:
        pad = torch.zeros((u.shape[0], 3, u.shape[2]), dtype=u.dtype,
                          device=u.device)
    else:
        pad = cache.to(u.dtype)
    full = torch.cat([pad, u], dim=1)                      # (B, S+3, C)
    S = u.shape[1]
    out = sum(full[:, i:i + S] * w[i] for i in range(4))
    return F.silu(out), full[:, -3:]


def _mamba_project(p, x, cfg: ArchConfig):
    d_in, nh, hp, n = mamba_dims(cfg)
    xn = layers.rms_norm(x, p["ln"])
    zx = xn @ p["w_zx"]
    z, xin = zx[..., :d_in], zx[..., d_in:]
    bc = xn @ p["w_bc"]
    b, c = bc[..., :n], bc[..., n:]
    dt = F.softplus((xn @ p["w_dt"]).float() + p["dt_bias"])  # (B, S, H)
    return z, xin, b, c, dt


def _mamba_out(p, y, z, dtype):
    """Gate, norm and project the SSD output y (B, S, d_in) float32."""
    y = y * F.silu(z.float())
    return layers.rms_norm(y.to(dtype), p["gated_ln"]) @ p["wo"]


def mamba_forward(p, x, cfg: ArchConfig, rules: Rules = None, mesh=None):
    """Chunked SSD forward (Mamba-2, arXiv:2405.21060 §6).

    Intra-chunk terms are computed with dense (quadratic-in-chunk)
    products, while inter-chunk terms flow through a loop over chunks
    carrying the (B, H, P, N) float32 state (the reference's ``lax.scan``).
    Returns (out, MambaCache) with the final state and conv taps. On a
    ``mesh`` each rank runs its batch rows (``on_batch_shards``).
    """
    if mesh is not None and is_dtensor(x):
        return on_batch_shards(
            lambda p, x: mamba_forward(p, x, cfg), p, x, rules=rules,
            mesh=mesh, batch=batch_entry(rules, mesh, x.shape[0]),
            out_ndims=(3, 3, 3, 3, 4))
    B, S, D = x.shape
    d_in, H, P, N = mamba_dims(cfg)
    L = min(cfg.ssm.chunk, S)

    z, xin, b, c, dt = _mamba_project(p, x, cfg)
    xin, conv_x = _causal_conv(xin, p["conv_x"])
    b, conv_b = _causal_conv(b, p["conv_b"])
    c, conv_c = _causal_conv(c, p["conv_c"])
    a = -torch.exp(p["a_log"])                             # (H,) negative

    # Pad to a chunk multiple. Padded positions get dt=0, which makes them
    # exactly transparent: zero state contribution, unchanged decay.
    Sp = -(-S // L) * L
    if Sp != S:
        xin, b, c, dt = (F.pad(t, (0, 0, 0, Sp - S)) for t in (xin, b, c, dt))
    nc = Sp // L

    xh = xin.reshape(B, nc, L, H, P).float()
    dtc = dt.reshape(B, nc, L, H)
    bc_ = b.reshape(B, nc, L, N).float()
    cc_ = c.reshape(B, nc, L, N).float()
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device))

    h = torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device)
    ys = []
    for i in range(nc):
        xc, dt_c, b_c, c_c = xh[:, i], dtc[:, i], bc_[:, i], cc_[:, i]
        cum = torch.cumsum(dt_c * a, dim=1)                # (B, L, H)
        # intra-chunk: M[l,m,h] = exp(cum_l - cum_m) * (c_l·b_m) * dt_m, l>=m
        scores = torch.einsum("bln,bmn->blm", c_c, b_c)
        # the exponent is masked before exp: above the diagonal cum_l -
        # cum_m > 0 overflows exp to inf at a full-width chunk, and the
        # mask's backward would then multiply 0 by inf (ROADMAP C30); the
        # kept entries are the same bits
        decay = torch.exp(torch.where(
            mask[None, :, :, None], cum[:, :, None, :] - cum[:, None, :, :],
            -math.inf))
        mmat = torch.where(mask[None, :, :, None],
                           scores[..., None] * decay * dt_c[:, None, :, :],
                           0.0)                            # (B, L, M, H)
        y = torch.einsum("blmh,bmhp->blhp", mmat, xc)
        # inter-chunk: contribution of the carried state
        y = y + torch.exp(cum)[..., None] * torch.einsum(
            "bln,bhpn->blhp", c_c, h)
        # state update for the next chunk
        tail = torch.exp(cum[:, -1:, :] - cum)             # (B, L, H)
        s_chunk = torch.einsum("blh,bln,blhp->bhpn", tail * dt_c, b_c, xc)
        h = h * torch.exp(cum[:, -1])[:, :, None, None] + s_chunk
        ys.append(y)
    y = torch.stack(ys, dim=1).reshape(B, Sp, H, P)[:, :S]
    y = y + xh.reshape(B, Sp, H, P)[:, :S] * p["d_skip"][None, None, :, None]
    out = _mamba_out(p, y.reshape(B, S, d_in), z, x.dtype)
    return out, MambaCache(conv_x=conv_x, conv_b=conv_b, conv_c=conv_c,
                           ssm=h)


def mamba_decode(p, x, cache: MambaCache, cfg: ArchConfig,
                 rules: Rules = None, mesh=None):
    """O(1) recurrent step. x: (B, D). Returns (out, new MambaCache). On
    a ``mesh`` each rank steps its batch rows (``on_batch_shards``)."""
    if mesh is not None and is_dtensor(x):
        return on_batch_shards(
            lambda p, x, c: mamba_decode(p, x, c, cfg), p, x, cache,
            rules=rules, mesh=mesh,
            batch=batch_entry(rules, mesh, x.shape[0]),
            out_ndims=(2, 3, 3, 3, 4))
    B, D = x.shape
    d_in, H, P, N = mamba_dims(cfg)
    cap = capture_mod.active_capture()
    if cap is not None and capture_mod.is_concrete(x):
        # SSM family signature: every decode step rewrites the whole
        # (H, P, N) recurrent state — a wide sequential page-write burst
        # per sequence (port = sequence), nothing like KV's single-slot
        # append.
        page_bytes = P * N * 4                      # f32 state rows
        cap.record("ssm_state_update", f"ssm:{H}x{page_bytes}", H,
                   page_bytes, np.tile(np.arange(H, dtype=np.int64), B),
                   rw=1, pe_id=np.repeat(np.arange(B, dtype=np.int64), H))
    z, xin, b, c, dt = _mamba_project(p, x[:, None, :], cfg)
    xin, conv_x = _causal_conv(xin, p["conv_x"], cache.conv_x)
    b, conv_b = _causal_conv(b, p["conv_b"], cache.conv_b)
    c, conv_c = _causal_conv(c, p["conv_c"], cache.conv_c)

    xh = xin[:, 0].reshape(B, H, P).float()
    dt1 = dt[:, 0]                                         # (B, H)
    b1 = b[:, 0].float()                                   # (B, N)
    c1 = c[:, 0].float()
    a = -torch.exp(p["a_log"])

    da = torch.exp(dt1 * a)                                # (B, H)
    h_new = (cache.ssm * da[:, :, None, None]
             + (dt1[:, :, None] * xh)[..., None] * b1[:, None, None, :])
    y = torch.einsum("bhpn,bn->bhp", h_new, c1)
    y = y + xh * p["d_skip"][None, :, None]
    out = _mamba_out(p, y.reshape(B, 1, d_in), z, x.dtype)[:, 0]
    return out, MambaCache(conv_x, conv_b, conv_c, h_new)
