"""Parameter declarations: one tree drives init and the parameter count.

Counterpart of ``repro.models.params``. Every parameter is declared once
as a ``ParamDecl`` (shape + logical axes + initializer), for every family;
``init_params`` materializes the tree as a nested dict of tensors on a
device, or as DTensors on a device mesh; ``param_specs`` maps logical
axes through the active ``Rules``, and ``abstract_params`` produces
allocation-free stand-ins (``meta`` tensors) — tree-congruent because
they traverse the same declarations.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.sharding import Rules, distribute

# Elements drawn at a time by ``init_params``: a float32 draw of a whole
# stacked leaf would need 4 bytes per element (35 GB for yi-34b's w_gate).
INIT_CHUNK = 1 << 26


@dataclasses.dataclass(frozen=True)
class ParamDecl:
    shape: Tuple[int, ...]
    logical: Tuple[Optional[str], ...]
    init: str = "normal"          # normal | zeros | ones | ssm_a | dt_bias
    fan_in: Optional[int] = None  # scale 1/sqrt(fan_in); default shape[0]


def _d(shape, logical, init="normal", fan_in=None):
    return ParamDecl(tuple(shape), tuple(logical), init, fan_in)


def _attn_decls(cfg: ArchConfig):
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return {
        "ln": _d((d,), (None,), "ones"),
        "wq": _d((d, h * hd), ("w_fsdp", "w_tp")),
        "wk": _d((d, kv * hd), ("w_fsdp", "w_tp")),
        "wv": _d((d, kv * hd), ("w_fsdp", "w_tp")),
        "wo": _d((h * hd, d), ("w_tp", "w_fsdp")),
    }


def _mlp_decls(cfg: ArchConfig, d_ff: Optional[int] = None):
    d, f = cfg.d_model, d_ff or cfg.d_ff
    return {
        "ln": _d((d,), (None,), "ones"),
        "w_gate": _d((d, f), ("w_fsdp", "w_tp")),
        "w_up": _d((d, f), ("w_fsdp", "w_tp")),
        "w_down": _d((f, d), ("w_tp", "w_fsdp")),
    }


def _moe_decls(cfg: ArchConfig):
    m = cfg.moe
    d = cfg.d_model
    decls = {
        "ln": _d((d,), (None,), "ones"),
        "router": _d((d, m.num_experts), ("w_fsdp", None)),
        "w_gate": _d((m.num_experts, d, m.d_expert),
                     ("expert", "expert_in", "expert_out")),
        "w_up": _d((m.num_experts, d, m.d_expert),
                   ("expert", "expert_in", "expert_out")),
        "w_down": _d((m.num_experts, m.d_expert, d),
                     ("expert", "expert_out", "expert_in")),
    }
    if m.num_shared_experts:
        fs = m.num_shared_experts * m.shared_d_expert
        decls.update({
            "shared_gate": _d((d, fs), ("w_fsdp", "w_tp")),
            "shared_up": _d((d, fs), ("w_fsdp", "w_tp")),
            "shared_down": _d((fs, d), ("w_tp", "w_fsdp")),
        })
    return decls


def mamba_dims(cfg: ArchConfig):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    nheads = d_in // s.head_dim
    return d_in, nheads, s.head_dim, s.d_state


def _mamba_decls(cfg: ArchConfig):
    d = cfg.d_model
    d_in, nh, _, n = mamba_dims(cfg)
    return {
        "ln": _d((d,), (None,), "ones"),
        "w_zx": _d((d, 2 * d_in), ("w_fsdp", "w_tp")),
        "w_bc": _d((d, 2 * n), ("w_fsdp", None)),
        "w_dt": _d((d, nh), ("w_fsdp", "w_tp")),
        "dt_bias": _d((nh,), ("w_tp",), "dt_bias"),
        "a_log": _d((nh,), ("w_tp",), "ssm_a"),
        "d_skip": _d((nh,), ("w_tp",), "ones"),
        "conv_x": _d((4, d_in), (None, "w_tp"), "normal", 4),
        "conv_b": _d((4, n), (None, None), "normal", 4),
        "conv_c": _d((4, n), (None, None), "normal", 4),
        "gated_ln": _d((d_in,), ("w_tp",), "ones"),
        "wo": _d((d_in, d), ("w_tp", "w_fsdp")),
    }


def block_decls(cfg: ArchConfig, layer_in_period: int):
    """Declarations for one (mixer, ffn) sub-block at a period position."""
    mixer, ffn = cfg.layer_kinds(layer_in_period)
    decls = {}
    if mixer == "attn":
        decls["attn"] = _attn_decls(cfg)
    elif mixer == "mamba":
        decls["mamba"] = _mamba_decls(cfg)
    if ffn == "mlp":
        decls["mlp"] = _mlp_decls(cfg)
    elif ffn == "moe":
        decls["moe"] = _moe_decls(cfg)
    return decls


def map_tree(fn, tree):
    """``fn`` over the leaves of a nested dict, keeping its structure;
    leaves are visited with keys in sorted order at every level (the order
    of ``jax.tree.leaves``)."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, tree[k]) for k in sorted(tree)}
    return fn(tree)


def leaves(tree) -> list:
    """The leaves of a nested dict, in ``map_tree``'s order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    return [tree]


def model_decls(cfg: ArchConfig):
    """Full declaration tree. Per-layer decls get a leading stacked 'layers'
    axis (num_groups = num_layers / scan period)."""
    period = cfg.scan_period
    assert cfg.num_layers % period == 0
    groups = cfg.num_layers // period

    def stack(decl: ParamDecl) -> ParamDecl:
        # Pin fan-in to the *unstacked* input dim so the layer axis never
        # changes init scale.
        fan_in = decl.fan_in
        if decl.init == "normal" and fan_in is None:
            fan_in = decl.shape[-2] if len(decl.shape) >= 2 else decl.shape[-1]
        return ParamDecl((groups,) + decl.shape, ("layers",) + decl.logical,
                         decl.init, fan_in)

    layers = {f"pos{pos}": map_tree(stack, block_decls(cfg, pos))
              for pos in range(period)}
    tree = {
        "embed": {"table": _d((cfg.padded_vocab, cfg.d_model),
                              (None, "w_tp"), "normal", cfg.d_model)},
        "layers": layers,
        "final_norm": _d((cfg.d_model,), (None,), "ones"),
        "lm_head": _d((cfg.d_model, cfg.padded_vocab),
                      ("w_fsdp", "w_vocab_tp")),
    }
    if cfg.modality in ("audio", "vision_text"):
        tree["connector"] = {
            "w": _d((cfg.frontend_dim, cfg.d_model), ("w_fsdp", None)),
            "ln": _d((cfg.d_model,), (None,), "ones"),
        }
    return tree


# ---------------------------------------------------------------------------
# Materialization
# ---------------------------------------------------------------------------

def _init_leaf(decl: ParamDecl, gen: torch.Generator, dtype, device):
    if decl.init == "zeros":
        return torch.zeros(decl.shape, dtype=dtype, device=device)
    if decl.init == "ones":
        return torch.ones(decl.shape, dtype=dtype, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    if decl.init == "ssm_a":
        # A in [1, 16], stored as log (mamba2 default init); kept in float32
        u = torch.empty(decl.shape, **f32).uniform_(1.0, 16.0, generator=gen)
        return torch.log(u)
    if decl.init == "dt_bias":
        # inverse-softplus of dt ~ LogUniform[1e-3, 1e-1]; float32
        dt = torch.exp(torch.empty(decl.shape, **f32).uniform_(
            math.log(1e-3), math.log(1e-1), generator=gen))
        return dt + torch.log(-torch.expm1(-dt))
    fan_in = decl.fan_in or (decl.shape[-2] if len(decl.shape) >= 2
                             else decl.shape[-1])
    scale = 1.0 / math.sqrt(max(1, fan_in))
    out = torch.empty(decl.shape, dtype=dtype, device=device)
    flat = out.view(-1)
    for s in range(0, flat.numel(), INIT_CHUNK):
        n = min(INIT_CHUNK, flat.numel() - s)
        flat[s:s + n] = torch.randn(n, generator=gen, **f32) * scale
    return out


def _leaf_dtype(decl: ParamDecl, dtype):
    return torch.float32 if decl.init in ("ssm_a", "dt_bias") else dtype


def init_params(cfg: ArchConfig, generator: torch.Generator,
                device: str | torch.device = "cuda", *, mesh=None,
                rules: Rules | None = None):
    """Normal(0, 1/fan_in) weights, ones/zeros norms, float32 ``ssm_a`` /
    ``dt_bias``, drawn from ``generator`` (a generator of ``device``) leaf
    by leaf in sorted-key order. The numbers differ from the reference's
    ``jax.random`` draws; ``repro_torch.convert.lm_params`` carries those
    across. On a ``mesh`` every rank draws each whole leaf as one device
    would and keeps its shard of it by ``param_specs(cfg, rules)``, one
    leaf at a time, so the values equal the single-device init bit for
    bit."""
    dtype = getattr(torch, cfg.param_dtype)
    if mesh is None:
        return map_tree(lambda d: _init_leaf(d, generator, dtype, device),
                        model_decls(cfg))
    return map_tree(lambda d: distribute(
        _init_leaf(d, generator, dtype, device), mesh,
        rules.spec(*d.logical)), model_decls(cfg))


def abstract_params(cfg: ArchConfig):
    """``meta`` tensors of every leaf's shape and dtype (float32 for
    ``ssm_a`` and ``dt_bias``, as ``init_params`` makes them)."""
    dtype = getattr(torch, cfg.param_dtype)
    return map_tree(lambda d: torch.empty(d.shape, device="meta",
                                          dtype=_leaf_dtype(d, dtype)),
                    model_decls(cfg))


def param_specs(cfg: ArchConfig, rules: Rules):
    """The spec of every leaf: its logical axes through ``rules``."""
    return map_tree(lambda d: rules.spec(*d.logical), model_decls(cfg))


def param_count_tree(cfg: ArchConfig) -> int:
    return sum(math.prod(d.shape) for d in leaves(model_decls(cfg)))
