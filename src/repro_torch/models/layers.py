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
an in-place slot copy. Each of the three reports its request batch into an
active ``core.capture.TraceCapture`` (the model trace zoo,
``data/model_traces.py``); with none active a hook returns at once, and
only a hook that records copies ids from the card to the host.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import compat
from repro_torch.core import capture as capture_mod
from repro_torch.core import scheduler
from repro_torch.core.config import MemoryControllerConfig
from repro_torch.core.controller import MemoryController
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.sorted_gather import kernel as sg_kernel
from repro_torch.kernels.sorted_scatter import ops as ss_ops
from repro_torch.models.sharding import Rules, is_dtensor

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


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with the reference's dtype promotion: ``jnp`` promotes a
    float32 x bf16 product to float32 (the audio frontend's float32
    frames keep hubert's residual stream float32), where ``torch.matmul``
    of mixed dtypes raises. Same-dtype operands multiply as they are."""
    if a.dtype != b.dtype:
        t = torch.promote_types(a.dtype, b.dtype)
        a, b = a.to(t), b.to(t)
    return a @ b


def swiglu(x, w_gate, w_up, w_down):
    h = F.silu(mm(x, w_gate)) * mm(x, w_up)
    return mm(h, w_down)


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
    rules: Rules | None = None,
    mesh=None,
) -> torch.Tensor:
    """Online-softmax attention; O(S·block) memory instead of O(S²).

    ``q_block`` / ``kv_block`` tile the plain version; the result does not
    depend on them beyond float32 summation order. On a ``mesh`` (DTensor
    inputs) each rank runs the kernel on its local shard: its batch rows
    and, where ``rules.heads`` shards heads over ``model``, its heads,
    with the KV heads those heads read (``_local_attention``)."""
    if mesh is not None and is_dtensor(q):
        qs = rules.spec("batch", "seq", "heads", None)
        kvs = rules.spec("batch", "seq", "kv_heads", None)
        fn = functools.partial(
            _local_attention, causal=causal, window=window, q_block=q_block,
            kv_block=kv_block, use_kernels=use_kernels,
            n_heads=q.shape[2], mesh=mesh, rules=rules)
        return compat.shard_map(fn, mesh=mesh, in_specs=(qs, kvs, kvs),
                                out_specs=qs)(q, k, v)
    if use_kernels:
        return fa_kernel.flash_attention_fwd(q, k, v, causal=causal,
                                             window=window, q_block=q_block,
                                             kv_block=kv_block)
    return fa_kernel.flash_attention_plain(q, k, v, causal=causal,
                                           window=window, q_block=q_block,
                                           kv_block=kv_block)


def _local_attention(q, k, v, *, n_heads: int, mesh, rules: Rules,
                     **kw) -> torch.Tensor:
    """One rank's attention on local shards. With heads sharded over
    ``model`` and KV heads replicated (KV does not divide the axis), the
    rank's heads ``[h0, h1)`` read KV heads ``[h0 // G, ceil(h1 / G))``
    of the G-head groups: those are sliced out, so the kernel's own GQA
    grouping of the local heads is the global one."""
    H_loc = q.shape[2]
    if H_loc < n_heads and rules.kv_heads is None:
        G = n_heads // k.shape[2]
        if (G % H_loc if H_loc <= G else H_loc % G):
            raise ValueError(f"{H_loc} local heads of {n_heads} do not "
                             f"split {k.shape[2]} KV heads into whole "
                             f"groups")
        h0 = compat.axis_index("model", mesh) * H_loc
        k0, k1 = h0 // G, -(-(h0 + H_loc) // G)
        k, v = k[:, :, k0:k1], v[:, :, k0:k1]
    return flash_attention(q, k, v, **kw)


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

def _embed_region(table: torch.Tensor) -> tuple:
    """(region_name, n_rows, row_bytes) of an embedding table — shared by
    ``mc_embed`` (READ) and ``mc_scatter`` (WRITE) so both directions of
    embedding traffic land on the same captured rows."""
    n_rows = int(table.shape[0])
    row_bytes = int(table.shape[-1]) * int(table.element_size())
    return f"embed:{n_rows}x{row_bytes}", n_rows, row_bytes


def _capture_embed(op: str, table, tokens, rw: int) -> None:
    cap = capture_mod.active_capture()
    if cap is None:
        return
    name, n_rows, row_bytes = _embed_region(table)
    shape = tuple(tokens.shape)
    if len(shape) >= 2:
        # one port per sequence (leading dims flattened): the multi-PE
        # front end sees each sequence's token stream on its own port
        lead = int(np.prod(shape[:-1]))
        pe = np.repeat(np.arange(lead, dtype=np.int64), shape[-1])
    else:
        pe = 0          # single-sequence / decode stream — one port
    cap.record(op, name, n_rows, row_bytes, tokens, rw=rw, pe_id=pe)


def mc_embed(table: torch.Tensor, tokens: torch.Tensor,
             mc: MemoryControllerConfig, *,
             use_kernels: bool = True, rules: Rules | None = None,
             mesh=None) -> torch.Tensor:
    """Embedding gather through the memory controller's scheduler.

    Requests are stable-sorted *per sequence* (axis -1) — each sequence is
    one scheduler batch, matching the paper's bounded batch size. 1-D (and
    scalar) token streams — the decode-step path — are one sequence, so
    the whole stream forms a single scheduler batch instead of bypassing
    the controller. With ``use_kernels`` the sort is the bitonic network
    (B1) and the row gather the sorted-gather kernel (B2), their plain
    versions for CPU tensors, and the lookup's backward is the
    controller's embedding-gradient write (``EmbedLookup``): B1 and B3
    with ``use_kernels`` and the scheduler on, else their plain versions.
    Value-identical to ``table[tokens]``.

    On a ``mesh`` (a DTensor table, laid out ``(None, "w_tp")``: the
    vocabulary replicated, ``d_model`` split over ``model``) each rank
    sorts its own batch rows' ids and gathers whole rows of its own
    columns; the result is laid out ``("batch", "seq", "w_tp")``, and
    the table's gradient is summed over the batch shards.
    """
    if mesh is not None and is_dtensor(table):
        lead = ("batch", "seq")[:tokens.ndim]
        fn = functools.partial(mc_embed, mc=mc, use_kernels=use_kernels)
        return compat.shard_map(
            fn, mesh=mesh,
            in_specs=(rules.spec(None, "w_tp"), rules.spec(*lead)),
            out_specs=rules.spec(*lead, "w_tp"))(table, tokens)
    _capture_embed("embed_gather", table, tokens, rw=0)
    return EmbedLookup.apply(table, tokens, use_kernels,
                             mc.scheduler.enabled)


def _scheduled_lookup(table: torch.Tensor, tokens: torch.Tensor, *,
                      use_kernels: bool) -> torch.Tensor:
    """Sort each scheduler batch (B1), gather its rows in sorted order
    (B2) and unsort them into arrival order."""
    d = table.shape[-1]
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


class EmbedLookup(torch.autograd.Function):
    """``mc_embed`` under autograd. The forward is the scheduled lookup
    (the sort, the row gather in sorted order, the unsort): B1 and B2 with
    ``use_kernels``, whose launches autograd cannot follow, else their
    plain versions; with ``scheduled`` false, one ``index_select``. The
    backward is the embedding-gradient WRITE batch of the controller's
    scheduler: the whole batch's token ids stable-sorted and each token's
    gradient row added into a zero table (``sorted_scatter`` with
    ``mode="add"``), by B1 and B3 on the kernel route (``use_kernels``
    and ``scheduled``; its write reported to an active capture as
    ``mc_scatter``'s write is), by B3's plain ``add``
    (``coalesce_add_runs``) on the others, on every device. Either way
    each row's addends are summed in at least float32 in an order the
    batch fixes and rounded once, so the table's gradient has the same
    bits on every call (``index_select``'s own backward is an
    ``index_add_``, which on CUDA adds duplicates with atomics). CPU
    tensors take the kernels' plain versions."""

    @staticmethod
    def forward(ctx, table, tokens, use_kernels=True, scheduled=True):
        ctx.save_for_backward(tokens)
        ctx.table_shape = table.shape
        ctx.kernels = use_kernels and scheduled
        if scheduled:
            return _scheduled_lookup(table, tokens, use_kernels=use_kernels)
        return table.index_select(0, tokens.reshape(-1)).reshape(
            *tokens.shape, table.shape[-1])

    @staticmethod
    def backward(ctx, grad):
        if not ctx.needs_input_grad[0]:
            return None, None, None, None
        (tokens,) = ctx.saved_tensors
        zero = grad.new_zeros(ctx.table_shape)
        if ctx.kernels:
            _capture_embed("embed_scatter", zero, tokens, rw=1)
            route = dict(use_bitonic=True)
        else:
            route = dict(backend="torch")
        return ss_ops.sorted_scatter(zero, tokens, grad, mode="add",
                                     **route), None, None, None


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
    _capture_embed("embed_scatter", table, tokens, rw=1)
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
    the request class, which the capture hook reports as ``kv_append``
    bulk-write records (``kv_append_dma`` when the config's DMA engine
    owns the stream); it never affects stored values.
    """
    if is_dtensor(buf):
        return _kv_append_on_mesh(buf, new, slot, axis)
    cap = capture_mod.active_capture()
    if cap is not None:
        pages = int(buf.shape[axis])
        n_new = int(new.shape[axis])
        page_bytes = (new.numel() // max(1, n_new)
                      * int(new.element_size()))
        op = "kv_append_dma" if mc.dma.enabled else "kv_append"
        cap.record_slice(op, f"kv:{pages}x{page_bytes}", pages, page_bytes,
                         slot, n_new, rw=1)
    buf.narrow(axis, slot, new.shape[axis]).copy_(new)
    return buf


def _kv_append_on_mesh(buf, new, slot: int, axis: int):
    """``mc_kv_append`` into a DTensor cache (no capture record). A
    ``redistribute`` returns a new tensor, so a write into a resharded
    view would be lost: instead each rank writes, in place, the part of
    ``[slot, slot + n)`` that its own shard of ``axis`` holds (none,
    where another rank owns it), with ``new`` laid out as ``buf`` but
    replicated along ``axis``. Shards of ``axis`` must be even. Returns
    ``buf``, which holds the write."""
    from torch.distributed.tensor import Replicate, Shard
    axis %= buf.ndim
    place = tuple(buf.placements)
    over = [i for i, p in enumerate(place)
            if isinstance(p, Shard) and p.dim == axis]
    new_place = tuple(Replicate() if i in over else p
                      for i, p in enumerate(place))
    parts = 1
    index = 0
    for i in over:                # major first, as DTensor shards a dim
        index = index * buf.device_mesh.shape[i] + \
            buf.device_mesh.get_local_rank(i)
        parts *= buf.device_mesh.shape[i]
    size = buf.shape[axis]
    if size % parts:
        raise ValueError(f"{size} slots do not split evenly over {parts} "
                         f"shards")
    lo = index * (size // parts)

    def write(b, n):
        a0, a1 = max(slot, lo), min(slot + n.shape[axis], lo + b.shape[axis])
        if a0 < a1:
            b.narrow(axis, a0 - lo, a1 - a0).copy_(
                n.narrow(axis, a0 - slot, a1 - a0))
        return b

    from torch.distributed.tensor.experimental import local_map
    if slot < 0 or slot + new.shape[axis] > size:
        raise ValueError(f"slots [{slot}, {slot + new.shape[axis]}) past "
                         f"the buffer's {size}")
    local_map(write, out_placements=(place,), in_placements=(place, new_place),
              device_mesh=buf.device_mesh, redistribute_inputs=True)(
        buf, new)
    return buf
