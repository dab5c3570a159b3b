"""LM assembly for every family of the model zoo.

Counterpart of ``repro.models.lm``: the dense transformers (yi-34b,
granite-34b, h2o-danube-1.8b, internlm2-20b), the MoE transformers
(qwen2-moe-a2.7b, mixtral-8x7b; the token-choice "tp" strategy), Mamba-2
(mamba2-2.7b), the hybrid jamba-v0.1-52b (period 8: attention at one
position, Mamba elsewhere, MoE at the odd ones), the audio encoder
hubert-xlarge and the VLM internvl2-76b (frontends stubbed: precomputed
frames or patches enter through the connector). The reference scans
stacked layer groups with ``lax.scan``; here the layer walk is a Python
loop over the same stacked leaves: layer ``l`` is period position
``l % P`` of group ``l // P``, a view.

On a device mesh (``build_lm(cfg, mesh)``) parameters, caches and
batches are DTensors laid out by ``param_specs``, ``cache_specs`` and
``data.synthetic.batch_specs``; each of the reference's ``shard`` calls
is a ``redistribute`` at the same place, the entry points run under
``implicit_replication`` (a plain tensor made inside, such as positions
or a mask, counts as replicated), and every kernel runs on each rank's
local shard (``layers.mc_embed``, ``layers.flash_attention``). The loss
gathers the vocab-sharded logits over ``model`` by an explicit
redistribution before the cross-entropy. ``moe_strategy="ep"`` routes the
MoE layers through ``models.moe_ep``.

Entry points (the shape cells map onto these):
  ``loss``        → train_4k        (fwd+CE, plus the MoE aux losses)
  ``prefill``     → prefill_32k     (full forward, returns serve cache)
  ``decode_step`` → decode_32k      (one token, cache updated in place)
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.core import capture as capture_mod
from repro_torch.models import blocks, layers
from repro_torch.models.blocks import AttnCache, MambaCache
from repro_torch.models.params import (abstract_params, init_params,
                                       mamba_dims, map_tree, param_specs)
from repro_torch.models.sharding import (Rules, distribute, is_dtensor,
                                         make_rules, mesh_shape, placements,
                                         shard)


@dataclasses.dataclass
class LM:
    cfg: ArchConfig
    device: str | torch.device = "cuda"
    rules: Rules = dataclasses.field(default_factory=lambda: make_rules(None))
    mesh: Any = None
    moe_strategy: str = "tp"

    # ---------------- params ------------------------------------------------
    def init(self, generator: torch.Generator):
        """Seeded parameters; on a mesh the same values as on one device,
        each rank keeping its shards (``params.init_params``)."""
        return init_params(self.cfg, generator, self.device, mesh=self.mesh,
                           rules=self.rules)

    def abstract_params(self):
        return abstract_params(self.cfg)

    def param_specs(self):
        return param_specs(self.cfg, self.rules)

    def _on_mesh(self):
        """The context of a computation on the mesh (a no-op off one)."""
        if self.mesh is None:
            return contextlib.nullcontext()
        from torch.distributed.tensor.experimental import \
            implicit_replication
        return implicit_replication()

    def place_batch(self, batch):
        """A batch of plain tensors as DTensors laid out by the rules
        (``batch_specs``: the batch dim over the data axes; every other
        dim replicated). Off a mesh, and for DTensors, ``batch`` itself."""
        if self.mesh is None:
            return batch

        def place(t):
            if is_dtensor(t):
                return t
            return distribute(t, self.mesh, self.rules.spec(
                "batch", *(None,) * (t.ndim - 1)))
        return {k: place(v) for k, v in batch.items()}

    # ---------------- input embedding --------------------------------------
    @staticmethod
    def _capture_frontend(op: str, frames) -> None:
        """Report an audio/vision frontend's (B, S, F) embedding stream as
        sequential bulk reads — one page per frame/patch, one port per
        sequence. Purely observational (the data plane is the product
        below); the row ids come from the shape, so nothing is copied
        from the card."""
        cap = capture_mod.active_capture()
        if cap is None:
            return
        if not capture_mod.is_concrete(frames):
            cap.n_skipped_traced += 1
            return
        B, S, F_ = frames.shape
        page_bytes = int(F_) * int(frames.element_size())
        cap.record(op, f"{op}:{B * S}x{page_bytes}", B * S, page_bytes,
                   np.arange(B * S, dtype=np.int64), rw=0,
                   pe_id=np.repeat(np.arange(B, dtype=np.int64), S))

    def _embed_inputs(self, params, batch) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
        """Returns (x (B,S,D), loss_mask (B,S)). Audio: the connector's
        projection of ``frames`` (dtype by ``layers.mm``: float32 frames
        keep x float32). Vision: the projected patches, cast to the text
        dtype, ahead of the text rows, masked out of the loss."""
        cfg = self.cfg
        if cfg.modality == "audio":
            frames = batch["frames"]
            self._capture_frontend("audio_frames", frames)
            x = layers.mm(frames, params["connector"]["w"])
            x = layers.rms_norm(x, params["connector"]["ln"])
            mask = torch.ones(x.shape[:2], dtype=torch.float32,
                              device=x.device)
        elif cfg.modality == "vision_text":
            self._capture_frontend("vision_patches", batch["vision_embeds"])
            vis = layers.mm(batch["vision_embeds"], params["connector"]["w"])
            vis = layers.rms_norm(vis, params["connector"]["ln"])
            txt = layers.mc_embed(params["embed"]["table"], batch["tokens"],
                                  cfg.mc, use_kernels=cfg.use_kernels,
                                  rules=self.rules, mesh=self.mesh)
            x = torch.cat([vis.to(txt.dtype), txt], dim=1)
            mask = torch.cat(
                [torch.zeros(vis.shape[:2], dtype=torch.float32,
                             device=x.device),
                 torch.ones(txt.shape[:2], dtype=torch.float32,
                            device=x.device)], dim=1)
        else:
            x = layers.mc_embed(params["embed"]["table"], batch["tokens"],
                                cfg.mc, use_kernels=cfg.use_kernels,
                                rules=self.rules, mesh=self.mesh)
            mask = torch.ones(x.shape[:2], dtype=torch.float32,
                              device=x.device)
        if "loss_mask" in batch:
            pad = mask.shape[1] - batch["loss_mask"].shape[1]
            mask = mask * F.pad(batch["loss_mask"].float(), (pad, 0))
        x = shard(x, self.rules, "batch", "seq", "embed", mesh=self.mesh)
        return x, mask

    def embedding_grad_update(self, params, tokens: torch.Tensor,
                              grad_rows: torch.Tensor, lr: float = 1.0):
        """Apply a sparse embedding update through the controller write path.

        ``grad_rows`` holds one gradient row per token occurrence (the
        backward of ``mc_embed``); rows for repeated tokens accumulate —
        the controller's scheduler stable-sorts the WRITE batch by row and
        coalesces duplicates before touching memory (``mc_scatter``,
        mode="add", kernel B3). Value-identical to
        ``table.at[tokens].add(-lr * grad_rows)``. Returns params with the
        updated table; every other leaf is shared, not copied.
        """
        table = params["embed"]["table"]
        new_table = layers.mc_scatter(
            table, tokens, (-lr * grad_rows).to(table.dtype), self.cfg.mc,
            mode="add", use_kernels=self.cfg.use_kernels)
        return {**params, "embed": {**params["embed"], "table": new_table}}

    def _full_labels(self, batch, S: int) -> torch.Tensor:
        """``labels`` left-padded with 0 to S (the vision prefix, which
        the loss mask excludes)."""
        labels = batch["labels"]
        pad = S - labels.shape[1]
        if pad:
            labels = F.pad(labels, (pad, 0))
        return labels

    def _moe_groups(self, x) -> int:
        """Scheduler instances for MoE dispatch = data-parallel shards of
        the token batch (per-controller bounded batches, paper §II). Falls
        back to 1 (global scheduler) off-mesh or when batch doesn't
        divide. This changes capacities and drops, not only the layout."""
        if self.mesh is None or self.rules.batch is None:
            return 1
        axes = self.rules.batch
        axes = (axes,) if isinstance(axes, str) else axes
        shape = mesh_shape(self.mesh)
        g = 1
        for a in axes:
            g *= shape[a]
        return g if g > 0 and x.shape[0] % g == 0 else 1

    # ---------------- block walker ------------------------------------------
    def _run_block(self, bp, x, positions, mode: str, cache=None,
                   cur_len=None):
        """One (mixer, ffn) sub-block with residuals.

        Returns (x, aux_losses or None, new_cache)."""
        cfg = self.cfg
        on = dict(rules=self.rules, mesh=self.mesh)
        decode = mode == "decode"
        aux, new_cache = None, {}
        if "attn" in bp:
            if decode:
                out, kv = blocks.attn_decode(bp["attn"], x, cache["attn"],
                                             cur_len, cfg, **on)
            else:
                out, kv = blocks.attn_forward(bp["attn"], x, cfg, positions,
                                              **on)
            x = x + out
            new_cache["attn"] = kv
        elif "mamba" in bp:
            if decode:
                out, mc = blocks.mamba_decode(bp["mamba"], x,
                                              cache["mamba"], cfg, **on)
            else:
                out, mc = blocks.mamba_forward(bp["mamba"], x, cfg, **on)
            x = x + out
            new_cache["mamba"] = mc
        if "mlp" in bp:
            if decode:
                x = x + blocks.mlp_forward(bp["mlp"], x[:, None, :],
                                           **on)[:, 0]
            else:
                x = x + blocks.mlp_forward(bp["mlp"], x, **on)
        elif "moe" in bp:
            xin = x[:, None, :] if decode else x
            if self.moe_strategy == "ep":
                from repro_torch.models.moe_ep import moe_ffn_ep
                out, aux = moe_ffn_ep(bp["moe"], xin, cfg, self.mesh,
                                      no_drop=decode)
            else:
                out, aux = blocks.moe_ffn(
                    bp["moe"], xin, cfg, no_drop=decode,
                    dispatch=cfg.moe_dispatch,
                    num_groups=self._moe_groups(xin), **on)
            x = x + (out[:, 0] if decode else out)
        return x, aux, new_cache

    def _layers(self, params, x, positions, mode: str, cache=None,
                cur_len=None, on_cache=None):
        """Walk the layers in order: layer ``l`` is period position
        ``pos = l % P`` of stacked group ``g = l // P`` (``P`` the scan
        period; 1 but for the hybrid family), its parameters
        ``params["layers"][f"pos{pos}"]`` at ``[g]`` and its cache entry
        ``cache[f"pos{pos}"][kind]`` at ``[g]``. ``on_cache(pos, g, c)``
        receives each layer's new cache entries (``{"attn": kv}`` or
        ``{"mamba": state}``). With ``cfg.remat``, a train walk under
        autograd checkpoints each layer (``_train_block``): backward
        recomputes it from its input. Returns (x, aux summed over
        layers)."""
        P = self.cfg.scan_period
        aux = _zero_aux(x.device)
        remat = mode == "train" and self.cfg.remat and torch.is_grad_enabled()
        remat_kw = _remat_kwargs(self.cfg.remat_policy) if remat else None
        # each stacked leaf split into its groups once: the backward then
        # stacks the groups' gradients in one op, where a slice per layer
        # would add a whole stacked-leaf gradient per layer (traffic
        # quadratic in depth)
        groups = {pos: map_tree(lambda t: t.unbind(0), sub)
                  for pos, sub in params["layers"].items()}
        for l in range(self.cfg.num_layers):
            pos, g = f"pos{l % P}", l // P
            bp = map_tree(lambda t: t[g], groups[pos])
            if remat:
                x, a = checkpoint(self._train_block, bp, x, positions,
                                  **remat_kw)
                nc = {}
            else:
                c = None
                if cache is not None:
                    c = {k: type(v)(*(t[g] for t in v))
                         for k, v in cache[pos].items()}
                x, a, nc = self._run_block(bp, x, positions, mode, cache=c,
                                           cur_len=cur_len)
            if a is not None:
                aux = {k: aux[k] + a[k] for k in aux}
            if on_cache is not None:
                on_cache(pos, g, nc)
        return x, aux

    def _train_block(self, bp, x, positions):
        """One layer of the train walk without its cache: the function
        that ``cfg.remat`` checkpoints (its recompute in backward runs on
        the mesh too). Returns (x, aux or None)."""
        with self._on_mesh():
            x, aux, _ = self._run_block(bp, x, positions, "train")
        return x, aux

    # ---------------- public entry points -----------------------------------
    def _positions(self, x):
        B, S, _ = x.shape
        return torch.arange(S, dtype=torch.int32, device=x.device).expand(B, S)

    def _backbone(self, params, batch):
        """Embed → layers → final norm. Returns (hidden, aux, mask)."""
        x, mask = self._embed_inputs(params, batch)
        x, aux = self._layers(params, x, self._positions(x), "train")
        return layers.rms_norm(x, params["final_norm"]), aux, mask

    def _logits(self, x, params):
        logits = layers.mm(x, params["lm_head"])
        return shard(logits, self.rules, "batch", "seq", "vocab",
                     mesh=self.mesh)

    def forward(self, params, batch) -> Tuple[torch.Tensor, Dict]:
        with self._on_mesh():
            x, aux, _ = self._backbone(params, self.place_batch(batch))
            return self._logits(x, params), aux

    def _ce_terms(self, logits, labels, mask):
        """(Σ masked CE, Σ masked logz², Σ mask) in fp32, padding masked."""
        cfg = self.cfg
        # the vocab-sharded logits gathered over ``model``: the reductions
        # over the vocabulary then run on each rank's batch rows
        lg = shard(logits, self.rules, "batch", "seq", None,
                   mesh=self.mesh).float()
        if cfg.padded_vocab != cfg.vocab_size:
            col = torch.arange(cfg.padded_vocab, device=lg.device)
            lg = torch.where(col < cfg.vocab_size, lg, -1e30)
        logz = torch.logsumexp(lg, dim=-1)
        gold = torch.take_along_dim(lg, labels[..., None].long(),
                                    dim=-1)[..., 0]
        return (((logz - gold) * mask).sum(),
                ((logz * mask) ** 2).sum(), mask.sum())

    def loss(self, params, batch) -> Tuple[torch.Tensor, Dict]:
        """Mean next-token CE plus the 1e-4 z-loss, and for MoE and
        hybrid models ``1e-2 * load_balance + router_z``. Labels are
        left-padded over a vision prefix (``_full_labels``). With
        ``loss_chunks`` the LM head and CE run one sequence chunk at a
        time, each checkpointed under autograd (the (B,S,V) logits never
        exist at once); the value is the same."""
        with self._on_mesh():
            return self._loss(params, self.place_batch(batch))

    def _loss(self, params, batch):
        cfg = self.cfg
        x, aux, x_mask = self._backbone(params, batch)
        S = x.shape[1]
        labels = self._full_labels(batch, S)
        n = cfg.loss_chunks or 1
        C = -(-S // n)
        def terms(xc, lc, mc):
            with self._on_mesh():
                return self._ce_terms(self._logits(xc, params), lc, mc)

        if cfg.loss_chunks and torch.is_grad_enabled():
            # each chunk's logits are recomputed in backward, as the
            # reference's jax.checkpoint does
            terms = functools.partial(checkpoint, terms, use_reentrant=False)
        ce_sum = z_sum = m_sum = 0.0
        for s in range(0, S, C):
            c, z, m = terms(x[:, s:s + C], labels[:, s:s + C],
                            x_mask[:, s:s + C])
            ce_sum, z_sum, m_sum = ce_sum + c, z_sum + z, m_sum + m
        denom = torch.clamp(m_sum, min=1.0)
        loss = ce_sum / denom
        z_loss = 1e-4 * z_sum / denom
        total = loss + z_loss
        if cfg.moe is not None or cfg.family == "hybrid":
            total = total + 1e-2 * aux["load_balance"] + aux["router_z"]
        return total, {"ce_loss": loss, "z_loss": z_loss, **aux}

    # ---------------- serving -----------------------------------------------
    def _cache_len(self, max_len: int) -> int:
        w = self.cfg.attn_window
        return min(w, max_len) if w is not None else max_len

    def cache_specs(self):
        """Specs congruent with ``init_cache``'s output."""
        r = self.rules
        specs = {}
        for pos in range(self.cfg.scan_period):
            mixer, _ = self.cfg.layer_kinds(pos)
            if mixer == "attn":
                kv_spec = r.spec("layers", "batch", "kv_seq", None, None)
                if self.cfg.kv_cache_dtype == "int8":
                    sc = r.spec("layers", "batch", "kv_seq", None)
                    specs[f"pos{pos}"] = {"attn": blocks.QuantAttnCache(
                        k=kv_spec, v=kv_spec, k_scale=sc, v_scale=sc)}
                    continue
                specs[f"pos{pos}"] = {"attn": AttnCache(k=kv_spec,
                                                        v=kv_spec)}
            else:
                specs[f"pos{pos}"] = {"mamba": MambaCache(
                    conv_x=r.spec("layers", "batch", None, "heads"),
                    conv_b=r.spec("layers", "batch", None, None),
                    conv_c=r.spec("layers", "batch", None, None),
                    ssm=r.spec("layers", "batch", "heads", None, None))}
        return specs

    def _zero_cache(self, batch_size: int, C: int, abstract: bool = False):
        """Zero serve cache matching the layer pattern: per period
        position an ``AttnCache`` / ``QuantAttnCache`` of (groups, B, C,
        KV, hd) leaves, or a ``MambaCache`` of (groups, B, 3, d_in),
        (groups, B, 3, N) twice and the (groups, B, H, P, N) float32
        state; ``groups`` is ``num_layers // scan_period``."""
        cfg = self.cfg
        n = cfg.num_layers // cfg.scan_period
        # on a mesh only the shapes are used: each rank allocates its shard
        kw = dict(device="meta" if abstract or self.mesh is not None
                  else self.device)
        dt = getattr(torch, cfg.param_dtype)
        cache = {}
        for pos in range(cfg.scan_period):
            mixer, _ = cfg.layer_kinds(pos)
            if mixer == "mamba":
                d_in, H, P, N = mamba_dims(cfg)
                cache[f"pos{pos}"] = {"mamba": MambaCache(
                    conv_x=torch.zeros((n, batch_size, 3, d_in), dtype=dt,
                                       **kw),
                    conv_b=torch.zeros((n, batch_size, 3, N), dtype=dt,
                                       **kw),
                    conv_c=torch.zeros((n, batch_size, 3, N), dtype=dt,
                                       **kw),
                    ssm=torch.zeros((n, batch_size, H, P, N),
                                    dtype=torch.float32, **kw))}
                continue
            shape = (n, batch_size, C, cfg.num_kv_heads, cfg.head_dim)
            if cfg.kv_cache_dtype == "int8":
                i8 = dict(dtype=torch.int8, **kw)
                f32 = dict(dtype=torch.float32, **kw)
                cache[f"pos{pos}"] = {"attn": blocks.QuantAttnCache(
                    k=torch.zeros(shape, **i8), v=torch.zeros(shape, **i8),
                    k_scale=torch.zeros(shape[:-1], **f32),
                    v_scale=torch.zeros(shape[:-1], **f32))}
                continue
            cache[f"pos{pos}"] = {"attn": AttnCache(
                k=torch.zeros(shape, dtype=dt, **kw),
                v=torch.zeros(shape, dtype=dt, **kw))}
        if self.mesh is not None and not abstract:
            cache = self._cache_on_mesh(cache)
        return cache

    def _cache_on_mesh(self, cache):
        """The zero cache as DTensors laid out by ``cache_specs``."""
        from torch.distributed.tensor import zeros
        specs = self.cache_specs()

        def place(t, spec):
            return zeros(t.shape, dtype=t.dtype, device_mesh=self.mesh,
                         placements=placements(spec, self.mesh))
        return {pos: {kind: type(entry)(*(place(t, sp) for t, sp in zip(
            entry, specs[pos][kind]))) for kind, entry in sub.items()}
            for pos, sub in cache.items()}

    def init_cache(self, batch_size: int, max_len: int,
                   abstract: bool = False):
        """Zero serve cache (see ``_zero_cache``); attention leaves hold
        ``max_len`` positions, or the SWA window. ``abstract``: ``meta``
        stand-ins of the whole leaves, on no mesh (the dry run's state
        bytes)."""
        return self._zero_cache(batch_size, self._cache_len(max_len),
                                abstract)

    def prefill(self, params, batch, max_len: int):
        """Full-context forward; returns (last_logits, cache, cur_len).

        Each layer's cache entry goes into the serve cache (K/V as a ring
        for SWA, int8 when configured; the Mamba conv taps and SSD state
        as they are) as soon as the layer has run, so no stack of raw
        K/V exists beside the cache."""
        with self._on_mesh():
            return self._prefill(params, self.place_batch(batch), max_len)

    def _prefill(self, params, batch, max_len: int):
        cfg = self.cfg
        x, _ = self._embed_inputs(params, batch)
        B, S, _ = x.shape
        # attn_prefill_cache's length: the whole context, or the window
        C = max_len if cfg.attn_window is None else cfg.attn_window
        cache = self._zero_cache(B, C)

        def store(pos, g, new):
            for kind, entry in new.items():
                if kind == "attn":
                    entry = blocks.attn_prefill_cache(entry, cfg, S, max_len)
                for buf, t in zip(cache[pos][kind], entry):
                    buf[g].copy_(t)

        x, _ = self._layers(params, x, self._positions(x), "prefill",
                            on_cache=store)
        xn = layers.rms_norm(x[:, -1], params["final_norm"])
        logits = layers.mm(xn, params["lm_head"])[:, :cfg.vocab_size]
        return logits, cache, S

    def decode_step(self, params, token: torch.Tensor, cache, cur_len: int):
        """One serve step: embed token (B,), walk layers, update ``cache``
        in place (each layer's K/V appended, or its Mamba state
        replaced). Returns (logits, cache)."""
        with self._on_mesh():
            return self._decode_step(params, self.place_batch(
                {"token": token})["token"], cache, cur_len)

    def _decode_step(self, params, token, cache, cur_len: int):
        cfg = self.cfg
        # The 1-D decode token stream is controller traffic too: one
        # scheduler batch through mc_embed, not a raw bypassing gather.
        x = layers.mc_embed(params["embed"]["table"], token, cfg.mc,
                            use_kernels=cfg.use_kernels, rules=self.rules,
                            mesh=self.mesh)
        x = shard(x, self.rules, "batch", "embed", mesh=self.mesh)

        def store(pos, g, new):
            # attn_decode appended in place; a Mamba step's state is new
            if "mamba" in new:
                for buf, t in zip(cache[pos]["mamba"], new["mamba"]):
                    buf[g].copy_(t)

        x, _ = self._layers(params, x, None, "decode", cache=cache,
                            cur_len=cur_len, on_cache=store)
        xn = layers.rms_norm(x, params["final_norm"])
        logits = shard(layers.mm(xn, params["lm_head"]), self.rules,
                       "batch", "vocab", mesh=self.mesh)
        return logits[:, :cfg.vocab_size], cache


def _remat_kwargs(policy: str) -> dict:
    """``checkpoint``'s arguments for ``cfg.remat_policy``: "nothing" keeps
    only the layer's inputs and recomputes the whole layer in backward
    (``jax.checkpoint_policies.nothing_saveable``); "dots" also keeps the
    outputs of its matrix products (``dots_saveable``)."""
    if policy == "nothing":
        return dict(use_reentrant=False)
    if policy != "dots":
        raise ValueError(f"remat_policy {policy!r}: need 'nothing' or "
                         f"'dots'")
    from torch.utils.checkpoint import (CheckpointPolicy,
                                        create_selective_checkpoint_contexts)
    dots = {torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
            torch.ops.aten.addmm.default}

    def keep_dots(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in dots
                else CheckpointPolicy.PREFER_RECOMPUTE)

    return dict(use_reentrant=False, context_fn=functools.partial(
        create_selective_checkpoint_contexts, keep_dots))


def _zero_aux(device) -> Dict[str, torch.Tensor]:
    """The MoE auxiliary losses of the reference's metrics, zero for a
    model without MoE layers."""
    return {"load_balance": torch.zeros((), device=device),
            "router_z": torch.zeros((), device=device)}


def build_lm(cfg: ArchConfig, mesh=None, *, global_batch: int = 0,
             moe_strategy: str = "tp",
             device: str | torch.device = "cuda") -> LM:
    """An ``LM`` for ``cfg`` (any registry architecture) on ``device``, or
    on ``mesh`` (a ``DeviceMesh`` with named dims ``("data", "model")`` or
    ``("pod", "data", "model")``) with the rules ``make_rules`` adapts to
    it. ``moe_strategy="ep"`` needs a mesh and an MoE architecture whose
    experts divide the model axis, with no shared experts."""
    if moe_strategy == "ep":
        if mesh is None or cfg.moe is None:
            raise ValueError("moe_strategy='ep' needs a mesh and an MoE "
                             "architecture")
        tp = mesh_shape(mesh)["model"]
        if cfg.moe.num_experts % tp or cfg.moe.num_shared_experts:
            raise ValueError(
                f"EP dispatch needs num_experts % {tp} == 0 and no shared "
                f"experts (got {cfg.moe.num_experts}e/"
                f"{cfg.moe.num_shared_experts}shared); use 'tp'")
    rules = make_rules(mesh, global_batch=global_batch,
                       moe_strategy=moe_strategy,
                       num_kv_heads=cfg.num_kv_heads,
                       num_heads=cfg.num_heads)
    if mesh is not None:
        device = torch.device(mesh.device_type)
    return LM(cfg=cfg, device=device, rules=rules, mesh=mesh,
              moe_strategy=moe_strategy)
