"""AdamW with float32 moments over bf16 params.

Counterpart of ``repro.optim.adamw``, expression for expression in torch:
linear warmup then cosine decay, global-norm clipping, bias-corrected
moments, and decoupled weight decay on matrices only (``ndim >= 2``). The
update math runs in float32 whatever the parameter dtype, and each new
parameter is rounded to its dtype once. Trees are nested dicts of tensors
(a parameter tree, its gradients, the moments), walked in sorted key
order (``models.params.map_tree``). The update is functional: it returns
new trees and writes none of its arguments' tensors (with ``donate`` it
replaces the leaves in its arguments' dicts, as the reference's jitted
step donates its state). On a device mesh the leaves
are DTensors and each moment keeps its parameter's layout
(``opt_state_specs``); the update then runs on each rank's shards, and
the global norm sums over all of them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch

from repro_torch.models.params import leaves, map_tree
from repro_torch.models.sharding import Spec


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    peak_lr: float = 3e-4
    min_lr_ratio: float = 0.1
    warmup_steps: int = 200
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def lr_schedule(step, cfg: OptimizerConfig) -> torch.Tensor:
    """Linear warmup → cosine decay to min_lr_ratio·peak, as a float32
    tensor (on ``step``'s device when it is a tensor)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(1.0, cfg.warmup_steps)
    t = (step - cfg.warmup_steps) / max(1.0,
                                        cfg.total_steps - cfg.warmup_steps)
    t = torch.clamp(t, 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return cfg.peak_lr * torch.where(step < cfg.warmup_steps, warm, cos)


def init_opt_state(params) -> Dict[str, Any]:
    """Zero float32 moments beside each parameter (a DTensor parameter's
    in its layout) and step 0 (int32, on the first parameter's device)."""
    device = leaves(params)[0].device
    f32_like = lambda p: torch.zeros_like(p, dtype=torch.float32)
    return {"m": map_tree(f32_like, params),
            "v": map_tree(f32_like, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def abstract_opt_state(abstract_params) -> Dict[str, Any]:
    """``meta`` stand-ins of ``init_opt_state``'s tree."""
    f32_like = lambda p: torch.empty(p.shape, dtype=torch.float32,
                                     device="meta")
    return {"m": map_tree(f32_like, abstract_params),
            "v": map_tree(f32_like, abstract_params),
            "step": torch.empty((), dtype=torch.int32, device="meta")}


def opt_state_specs(param_specs):
    """Moments take their parameter's spec (ZeRO: optimizer memory
    shrinks with both the data and the model axes); the step is
    replicated."""
    return {"m": param_specs, "v": param_specs, "step": Spec()}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in leaves(tree)))


def _slots(tree) -> list:
    """(dict, key) of each leaf of a nested dict, in ``leaves``' order."""
    out = []
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            out.extend(_slots(tree[k]))
        else:
            out.append((tree, k))
    return out


@torch.no_grad()
def adamw_update(grads, opt_state, params, cfg: OptimizerConfig, *,
                 donate: bool = False
                 ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step (with global-norm clipping). Returns
    (new_params, new_opt_state, metrics).

    ``donate`` hands the old state over, as the reference's jitted step
    donates its parameters and moments: each leaf of ``params``,
    ``opt_state["m"]`` and ``opt_state["v"]`` is replaced in its dict by
    its new value as soon as that exists, and each gradient leaf by None,
    so a step holds one copy of the state, not two. The returned trees
    are then those dicts; the old tensors are not written."""
    step = opt_state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    lr = lr_schedule(step, cfg)
    b1c = 1 - torch.pow(cfg.b1, step.float())
    b2c = 1 - torch.pow(cfg.b2, step.float())

    def upd(p, g, m, v):
        # g·scale; m_new = b1·m + (1 - b1)·g; v_new = b2·v + (1 - b2)·g·g;
        # delta = (m_new / b1c) / (sqrt(v_new / b2c) + eps), plus wd·p on
        # matrices only (ndim >= 2); p_new = p - lr·delta, rounded to
        # p's dtype once. Each operation is the one of that formula on the
        # same operands, written in place into this leaf's own float32
        # temporaries, so at most four of them live at a time.
        g = g.to(torch.float32, copy=True).mul_(scale)
        m_new = (m * cfg.b1).add_(g * (1 - cfg.b1))
        t = (g * (1 - cfg.b2)).mul_(g)
        del g
        v_new = (v * cfg.b2).add_(t)
        del t
        vh = (v_new / b2c).sqrt_().add_(cfg.eps)
        delta = (m_new / b1c).div_(vh)
        del vh
        if p.ndim >= 2:
            delta.add_(p.to(torch.float32, copy=True).mul_(
                cfg.weight_decay))
        p_new = p.to(torch.float32, copy=True).sub_(delta.mul_(lr))
        return p_new.to(p.dtype), m_new, v_new

    slots = zip(*(_slots(t) for t in (params, grads, opt_state["m"],
                                      opt_state["v"])))
    out = []
    for (pt, pk), (gt, gk), (mt, mk), (vt, vk) in slots:
        new = upd(pt[pk], gt[gk], mt[mk], vt[vk])
        if donate:
            pt[pk], mt[mk], vt[vk] = new
            gt[gk] = None
        else:
            out.append(new)
    metrics = {"grad_norm": gnorm, "lr": lr}
    if donate:
        return params, {"m": opt_state["m"], "v": opt_state["v"],
                        "step": step}, metrics

    def tree(i):
        it = iter(o[i] for o in out)
        return map_tree(lambda _: next(it), params)
    return tree(0), {"m": tree(1), "v": tree(2), "step": step}, metrics
