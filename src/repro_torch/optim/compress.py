"""Gradient compression for the cross-pod all-reduce.

Counterpart of ``repro.optim.compress``. The pod axis is pure data
parallelism over the slowest links, so its gradient all-reduce is the
most bandwidth-exposed collective of a multi-pod step.
``compressed_psum`` halves (bf16) or quarters (int8, per-tensor scale
plus error feedback) its bytes.

Error feedback keeps a residual buffer per tensor: the quantization error
of step t is added back into the gradient at step t+1, making the
compression unbiased over time (SGD-EF; Karimireddy et al. 2019).
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.models.params import leaves, map_tree


def compress_int8(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8 quantization. Returns (q, scale)."""
    g32 = g.float()
    scale = torch.max(torch.abs(g32)) / 127.0 + 1e-30
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def init_residuals(params):
    """A zero float32 residual beside each parameter."""
    return map_tree(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def compressed_psum(grads, residuals, axis_name: str, *, mesh,
                    mode: str = "int8"):
    """All-reduce a gradient tree over mesh axis ``axis_name`` with
    compression: each rank's leaves are its own (plain) tensors, as in
    the reference's ``shard_map`` body. ``mode`` "int8" sums each rank's
    dequantized int8 payload (its own scale), "bf16" sums bf16 copies
    (the sum itself in bf16, as the reference's ``psum`` of a bf16 array
    is), anything else sums float32. Returns (mean_grads,
    new_residuals): the mean in each gradient's dtype, and the float32
    error each rank's quantization left (zeros uncompressed)."""
    import torch.distributed._functional_collectives as funcol
    group = mesh.get_group(axis_name)
    n = mesh.size(mesh.mesh_dim_names.index(axis_name))

    def psum(x):
        return funcol.wait_tensor(funcol.all_reduce(x, "sum", group))

    def reduce_leaf(g, r):
        g32 = g.float() + r
        if mode == "int8":
            q, scale = compress_int8(g32)
            approx = psum(q.to(torch.int32).float() * scale) / n
            new_r = g32 - decompress_int8(q, scale)
        elif mode == "bf16":
            approx = psum(g32.to(torch.bfloat16)).float() / n
            new_r = g32 - g32.to(torch.bfloat16).float()
        else:
            approx = psum(g32) / n
            new_r = torch.zeros_like(g32)
        return approx.to(g.dtype), new_r

    out = [reduce_leaf(g, r) for g, r in zip(leaves(grads),
                                             leaves(residuals))]
    it0, it1 = iter(o[0] for o in out), iter(o[1] for o in out)
    return (map_tree(lambda _: next(it0), grads),
            map_tree(lambda _: next(it1), grads))
