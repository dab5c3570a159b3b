"""mixtral-8x7b — 8-expert top-2 MoE with sliding-window attention.

[moe] 32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000,
MoE 8e top-2, SWA [arXiv:2401.04088; hf]
"""

import dataclasses

from repro_torch.configs.base import ArchConfig, MoESpec

CONFIG = ArchConfig(
    name="mixtral-8x7b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    head_dim=128,
    attn_window=4096,        # SWA ⇒ sub-quadratic, runs long_500k
    moe=MoESpec(num_experts=8, top_k=2, d_expert=14336),
    source="arXiv:2401.04088",
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG, num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=128, vocab_size=256, head_dim=16, attn_window=8,
    moe=MoESpec(num_experts=4, top_k=2, d_expert=128))
