"""Expert-parallel MoE dispatch via shard_map all-to-all.

Counterpart of ``repro.models.moe_ep``. The paper's DMA engine, at
cluster scale: each model shard owns ``E / tp`` experts; token requests
are *sorted by destination shard* (the scheduler's row = the expert's
owner), packed into per-destination staging buffers (the DMA buffers),
and moved with one all-to-all bulk transfer instead of scattered traffic.
Everything inside the ``compat.shard_map`` body (DTensor's
``local_map``) is rank-local, with the collectives named by mesh axis.

Token layout: activations arrive model-replicated (Megatron convention);
the body first claims a 1/tp slice of its tokens per model shard (2D
data x model token sharding for the MoE block), dispatches with one
all-to-all each way (``all_to_all_single``: gloo has no list form), and
all-gathers the combined outputs back to the replicated layout.

Scope: requires ``num_experts % tp == 0`` and no shared experts (jamba:
16e on the 16-way model axis → one expert per shard, Switch-style).
Capacity: per-(source, destination) send capacity — the paper's bounded
per-controller batches; dropped requests contribute zero, as in the TP
path. The local expert products group the received rows by local expert
(a stable sort, then one product per expert over its contiguous rows);
the reference's one-hot ``einsum("nd,ne,edf->nf")`` could be contracted
weights-first into an (n, D, F) tensor by torch, so it is not used.
"""

from __future__ import annotations

import math
from functools import partial

import torch
import torch.nn.functional as F

from repro_torch import compat
from repro_torch.compat import P
from repro_torch.configs.base import ArchConfig
from repro_torch.core import capture as capture_mod
from repro_torch.models import layers
from repro_torch.models.blocks import (capture_moe_dispatch, dispatch_rows,
                                       top_k_lower_first)
from repro_torch.models.sharding import full, mesh_shape


def moe_ffn_ep(p, x, cfg: ArchConfig, mesh, *, no_drop: bool = False):
    """EP replacement for the routed part of ``blocks.moe_ffn``.

    ``p`` and ``x`` are DTensors (or plain tensors, placed as replicated).
    Returns (out, aux). Value-matches the TP dispatch at ample capacity;
    drop behaviour differs (per-destination send capacity vs per-expert
    capacity), inherent to EP.
    """
    m = cfg.moe
    assert m.num_shared_experts == 0, "EP path: no shared experts"
    shape = mesh_shape(mesh)
    tp = shape["model"]
    assert m.num_experts % tp == 0, "EP needs E % tp == 0"
    e_loc = m.num_experts // tp
    batch_axes = tuple(a for a in ("pod", "data") if a in shape)
    all_axes = batch_axes + ("model",)

    B, S, D = x.shape

    # Trace capture happens out here, on the whole batch: the router is
    # evaluated again (capture-only — it never feeds the data plane) to
    # report the global dispatch.
    if capture_mod.active_capture() is not None:
        xn_g = full(layers.rms_norm(x, p["ln"])).reshape(B * S, D)
        probs_g = torch.softmax((xn_g @ full(p["router"])).float(), dim=-1)
        _, top_e_g = top_k_lower_first(probs_g, m.top_k)
        capture_moe_dispatch(top_e_g, B * S, D, x.element_size())

    @partial(
        compat.shard_map,
        mesh=mesh,
        in_specs=(
            {"ln": P(), "router": P(),
             "w_gate": P("model", None, None),
             "w_up": P("model", None, None),
             "w_down": P("model", None, None)},
            P(batch_axes, None, None),
        ),
        out_specs=(P(batch_axes, None, None), {"load_balance": P(),
                                               "router_z": P()}),
    )
    def body(pl, xl):
        Bl, Sl, _ = xl.shape
        T = Bl * Sl
        assert T % tp == 0, "tokens per data shard must divide the TP axis"
        t_loc = T // tp
        my = compat.axis_index("model", mesh)
        dev = xl.device

        xn = layers.rms_norm(xl, pl["ln"])
        # claim this model shard's token slice (2D token sharding)
        flat = xn.reshape(T, D)[my * t_loc:(my + 1) * t_loc]

        logits = (flat @ pl["router"]).float()
        probs = torch.softmax(logits, dim=-1)
        top_p, top_e = top_k_lower_first(probs, m.top_k)
        top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)

        # aux losses over the global batch (mean over every shard's slice)
        me = compat.pmean(probs.mean(0), all_axes, mesh)
        e_all = top_e.reshape(-1)
        counts = torch.zeros(m.num_experts, dtype=torch.int64,
                             device=dev).scatter_add_(
            0, e_all, torch.ones_like(e_all))
        ce = compat.pmean(counts.float() / (t_loc * m.top_k), all_axes,
                          mesh)
        aux = {
            "load_balance": m.num_experts * torch.sum(me * ce),
            "router_z": m.router_z_coef * compat.pmean(
                torch.mean(torch.logsumexp(logits, dim=-1) ** 2),
                all_axes, mesh),
        }

        # ---- scheduler: sort requests by destination shard (row owner) ---
        n = t_loc * m.top_k
        e_flat = top_e.reshape(-1)
        if no_drop:
            c_send = n
        else:
            c_send = int(math.ceil(n / tp * m.capacity_factor))
            if c_send >= 64:
                c_send = -(-c_send // 128) * 128
            c_send = min(n, c_send)
        owner = e_flat // e_loc                       # destination shard
        order = torch.argsort(owner, stable=True)     # bitonic analogue
        owner_s = owner[order]
        run_start = torch.searchsorted(
            owner_s, torch.arange(tp, device=dev, dtype=owner_s.dtype))
        pos = torch.arange(n, device=dev) - run_start[owner_s]
        slot = torch.where(pos < c_send, pos, c_send)  # drop slot

        eid_of = (e_flat % e_loc)[order]              # local expert id

        # every drop writes slot c_send, which is cut off before sending;
        # each token's k rows come from one expand, so its gradient is a
        # fixed-order sum (ROADMAP C23)
        send_tok = torch.zeros((tp, c_send + 1, D), dtype=xl.dtype,
                               device=dev).index_put(
            (owner_s, slot), dispatch_rows(flat, 1, m.top_k)[0][order])
        send_eid = torch.full((tp, c_send + 1), e_loc, dtype=torch.int64,
                              device=dev).index_put((owner_s, slot), eid_of)

        # ---- bulk transfer: one all-to-all instead of scattered traffic --
        recv_tok = compat.all_to_all(send_tok[:, :c_send], "model", mesh)
        recv_eid = compat.all_to_all(send_eid[:, :c_send], "model", mesh)
        rt = recv_tok.reshape(tp * c_send, D)
        re = recv_eid.reshape(tp * c_send)

        # ---- local expert compute (everything rank-local) ----------------
        out_tok = _local_experts(rt, re, pl["w_gate"], pl["w_up"],
                                 pl["w_down"], e_loc).to(xl.dtype)

        # ---- reverse bulk transfer + writeback in arrival order ----------
        back = compat.all_to_all(out_tok.reshape(tp, c_send, D), "model",
                                 mesh)
        back = F.pad(back, (0, 0, 0, 1))              # re-add drop slot: 0
        y_sorted = back[owner_s, slot]                # (n, D)
        y = y_sorted[torch.argsort(order)]
        y = y * top_p.reshape(-1)[:, None].to(xl.dtype)
        y = y.reshape(t_loc, m.top_k, D).sum(1)       # my token slice

        # restore the model-replicated activation layout
        y_full = compat.all_gather(y, "model", mesh, dim=0)
        return y_full.reshape(Bl, Sl, D), aux

    return body(p, x)


def _local_experts(rows, eid, w_gate, w_up, w_down, e_loc: int):
    """SwiGLU of each row through its local expert ``eid`` (``e_loc``: an
    empty send slot, output 0): the rows are stably sorted by expert, each
    expert multiplies its contiguous run, and the results are unsorted.
    The run lengths are read on the host (one sync); on ``meta`` tensors,
    which hold no ids, the rows are split evenly for the count."""
    order = torch.argsort(eid, stable=True)
    if rows.device.type == "meta":
        n = rows.shape[0]
        sizes = [n // e_loc + (i < n % e_loc) for i in range(e_loc)] + [0]
    else:
        sizes = torch.bincount(eid, minlength=e_loc + 1).tolist()
    parts = torch.split(rows[order], sizes)
    outs = [F.silu(parts[e] @ w_gate[e]) * (parts[e] @ w_up[e]) @ w_down[e]
            for e in range(e_loc)]
    outs.append(torch.zeros_like(parts[e_loc]))
    return torch.cat(outs)[torch.argsort(order)]
