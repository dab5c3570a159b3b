"""LM assembly for the dense family with text modality.

Counterpart of ``repro.models.lm`` for the families this slice ports: the
dense transformers (yi-34b, granite-34b, h2o-danube-1.8b, internlm2-20b).
The other families, the MoE expert-parallel strategy and a device mesh
raise ``NotImplementedError`` naming their ROADMAP item. The reference
scans stacked layer groups with ``lax.scan``; here the layer walk is a
Python loop over the same stacked leaves, ``w[l]`` a view.

Entry points (the shape cells map onto these):
  ``loss``        → train_4k        (fwd+CE)
  ``prefill``     → prefill_32k     (full forward, returns serve cache)
  ``decode_step`` → decode_32k      (one token, cache updated in place)
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models import blocks, layers
from repro_torch.models.blocks import AttnCache
from repro_torch.models.params import init_params, map_tree


@dataclasses.dataclass
class LM:
    cfg: ArchConfig
    device: str | torch.device = "cuda"

    # ---------------- params ------------------------------------------------
    def init(self, generator: torch.Generator):
        return init_params(self.cfg, generator, self.device)

    # ---------------- input embedding --------------------------------------
    def _embed_inputs(self, params, batch) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
        """Returns (x (B,S,D), loss_mask (B,S))."""
        cfg = self.cfg
        x = layers.mc_embed(params["embed"]["table"], batch["tokens"], cfg.mc,
                            use_kernels=cfg.use_kernels)
        mask = torch.ones(x.shape[:2], dtype=torch.float32, device=x.device)
        if "loss_mask" in batch:
            pad = mask.shape[1] - batch["loss_mask"].shape[1]
            mask = mask * F.pad(batch["loss_mask"].float(), (pad, 0))
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

    # ---------------- block walker ------------------------------------------
    def _run_block(self, bp, x, positions, mode: str, cache=None,
                   cur_len=None):
        """One (attn, mlp) block with residuals. Returns (x, kv)."""
        if mode == "decode":
            out, kv = blocks.attn_decode(bp["attn"], x, cache["attn"],
                                         cur_len, self.cfg)
            x = x + out
            return x + blocks.mlp_forward(bp["mlp"], x[:, None, :])[:, 0], \
                {"attn": kv}
        out, kv = blocks.attn_forward(bp["attn"], x, self.cfg, positions)
        x = x + out
        return x + blocks.mlp_forward(bp["mlp"], x), {"attn": kv}

    def _layers(self, params, x, positions, mode: str, cache=None,
                cur_len=None, on_kv=None):
        """Walk the stacked layers in order; ``on_kv(l, kv)`` receives each
        layer's K/V in prefill mode. Returns x."""
        stacked = params["layers"]["pos0"]
        for l in range(self.cfg.num_layers):
            bp = map_tree(lambda t: t[l], stacked)
            c = None
            if cache is not None:
                kv = cache["pos0"]["attn"]
                c = {"attn": type(kv)(*(t[l] for t in kv))}
            x, kv = self._run_block(bp, x, positions, mode, cache=c,
                                    cur_len=cur_len)
            if on_kv is not None:
                on_kv(l, kv["attn"])
        return x

    # ---------------- public entry points -----------------------------------
    def _positions(self, x):
        B, S, _ = x.shape
        return torch.arange(S, dtype=torch.int32, device=x.device).expand(B, S)

    def _backbone(self, params, batch):
        """Embed → layers → final norm. Returns (hidden, mask)."""
        x, mask = self._embed_inputs(params, batch)
        x = self._layers(params, x, self._positions(x), "train")
        return layers.rms_norm(x, params["final_norm"]), mask

    def forward(self, params, batch) -> Tuple[torch.Tensor, Dict]:
        x, _ = self._backbone(params, batch)
        return x @ params["lm_head"], _zero_aux(x.device)

    def _ce_terms(self, logits, labels, mask):
        """(Σ masked CE, Σ masked logz², Σ mask) in fp32, padding masked."""
        cfg = self.cfg
        lg = logits.float()
        if cfg.padded_vocab != cfg.vocab_size:
            col = torch.arange(cfg.padded_vocab, device=lg.device)
            lg = torch.where(col < cfg.vocab_size, lg, -1e30)
        logz = torch.logsumexp(lg, dim=-1)
        gold = torch.take_along_dim(lg, labels[..., None].long(),
                                    dim=-1)[..., 0]
        return (((logz - gold) * mask).sum(),
                ((logz * mask) ** 2).sum(), mask.sum())

    def loss(self, params, batch) -> Tuple[torch.Tensor, Dict]:
        """Mean next-token CE plus the 1e-4 z-loss. With ``loss_chunks``
        the LM head and CE run one sequence chunk at a time (the
        (B,S,V) logits never exist at once); the value is the same."""
        cfg = self.cfg
        x, x_mask = self._backbone(params, batch)
        S = x.shape[1]
        labels = batch["labels"]
        n = cfg.loss_chunks or 1
        C = -(-S // n)
        ce_sum = z_sum = m_sum = 0.0
        for s in range(0, S, C):
            c, z, m = self._ce_terms(x[:, s:s + C] @ params["lm_head"],
                                     labels[:, s:s + C], x_mask[:, s:s + C])
            ce_sum, z_sum, m_sum = ce_sum + c, z_sum + z, m_sum + m
        denom = torch.clamp(m_sum, min=1.0)
        loss = ce_sum / denom
        z_loss = 1e-4 * z_sum / denom
        return loss + z_loss, {"ce_loss": loss, "z_loss": z_loss,
                               **_zero_aux(x.device)}

    # ---------------- serving -----------------------------------------------
    def _cache_len(self, max_len: int) -> int:
        w = self.cfg.attn_window
        return min(w, max_len) if w is not None else max_len

    def _zero_cache(self, batch_size: int, C: int):
        cfg = self.cfg
        shape = (cfg.num_layers, batch_size, C, cfg.num_kv_heads,
                 cfg.head_dim)
        kw = dict(device=self.device)
        if cfg.kv_cache_dtype == "int8":
            i8 = dict(dtype=torch.int8, **kw)
            f32 = dict(dtype=torch.float32, **kw)
            return {"pos0": {"attn": blocks.QuantAttnCache(
                k=torch.zeros(shape, **i8), v=torch.zeros(shape, **i8),
                k_scale=torch.zeros(shape[:-1], **f32),
                v_scale=torch.zeros(shape[:-1], **f32))}}
        dt = getattr(torch, cfg.param_dtype)
        return {"pos0": {"attn": AttnCache(
            k=torch.zeros(shape, dtype=dt, **kw),
            v=torch.zeros(shape, dtype=dt, **kw))}}

    def init_cache(self, batch_size: int, max_len: int):
        """Zero serve cache: per leaf, (layers, B, C, KV, hd)."""
        return self._zero_cache(batch_size, self._cache_len(max_len))

    def prefill(self, params, batch, max_len: int):
        """Full-context forward; returns (last_logits, cache, cur_len).

        Each layer's K/V goes into the serve cache (ring for SWA, int8 when
        configured) as soon as the layer has run, so no stack of raw K/V
        exists beside the cache."""
        cfg = self.cfg
        x, _ = self._embed_inputs(params, batch)
        B, S, _ = x.shape
        # attn_prefill_cache's length: the whole context, or the window
        C = max_len if cfg.attn_window is None else cfg.attn_window
        cache = self._zero_cache(B, C)
        dst = cache["pos0"]["attn"]

        def store(l, kv):
            for buf, new in zip(dst, blocks.attn_prefill_cache(
                    kv, cfg, S, max_len)):
                buf[l].copy_(new)

        x = self._layers(params, x, self._positions(x), "prefill",
                         on_kv=store)
        xn = layers.rms_norm(x[:, -1], params["final_norm"])
        logits = (xn @ params["lm_head"])[:, :cfg.vocab_size]
        return logits, cache, S

    def decode_step(self, params, token: torch.Tensor, cache, cur_len: int):
        """One serve step: embed token (B,), walk layers, append each
        layer's K/V to ``cache`` in place. Returns (logits, cache)."""
        cfg = self.cfg
        # The 1-D decode token stream is controller traffic too: one
        # scheduler batch through mc_embed, not a raw bypassing gather.
        x = layers.mc_embed(params["embed"]["table"], token, cfg.mc,
                            use_kernels=cfg.use_kernels)
        x = self._layers(params, x, None, "decode", cache=cache,
                         cur_len=cur_len)
        xn = layers.rms_norm(x, params["final_norm"])
        return (xn @ params["lm_head"])[:, :cfg.vocab_size], cache


def _zero_aux(device) -> Dict[str, torch.Tensor]:
    """The MoE auxiliary losses of the reference's metrics, zero for a
    dense model."""
    return {"load_balance": torch.zeros((), device=device),
            "router_z": torch.zeros((), device=device)}


def build_lm(cfg: ArchConfig, mesh=None, *, moe_strategy: str = "tp",
             device: str | torch.device = "cuda") -> LM:
    """An ``LM`` for ``cfg`` on ``device``."""
    if mesh is not None:
        raise NotImplementedError("a device mesh (sharding) waits for "
                                  "ROADMAP A9")
    if moe_strategy == "ep":
        raise NotImplementedError("moe_strategy='ep' (models/moe_ep.py) "
                                  "waits for ROADMAP A7 (MoE)")
    if cfg.family != "dense" or cfg.modality != "text":
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} with {cfg.modality!r} "
            f"modality waits for ROADMAP A7 (the port runs the dense "
            f"family with text modality)")
    return LM(cfg=cfg, device=device)
