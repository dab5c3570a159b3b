"""Gradient compression: per-tensor symmetric int8 with error feedback.

Counterpart of ``repro.optim.compress``: the quantizer and the residual
buffers. ``compressed_psum``, the all-reduce over the pod axis that uses
them, comes with the device mesh (ROADMAP A9).
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.models.params import map_tree


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
