"""jamba-v0.1-52b — hybrid Mamba + attention (1:7) with MoE every 2nd layer.

[hybrid] 32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536,
MoE 16e top-2 [arXiv:2403.19887; hf]

Layer pattern (period 8, matching the published 1:7 attn:mamba interleave):
mixer = attention at l % 8 == 4, Mamba elsewhere; FFN = MoE on odd layers,
dense SwiGLU on even layers.
"""

import dataclasses

from repro_torch.configs.base import ArchConfig, MoESpec, SSMSpec

CONFIG = ArchConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    head_dim=128,
    attn_every=8,
    attn_offset=4,
    moe_every=2,
    moe=MoESpec(num_experts=16, top_k=2, d_expert=14336),
    ssm=SSMSpec(d_state=16, expand=2, head_dim=64, chunk=256),
    source="arXiv:2403.19887",
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG, num_layers=8, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=128, vocab_size=256, head_dim=16,
    moe=MoESpec(num_experts=4, top_k=2, d_expert=128),
    ssm=SSMSpec(d_state=8, expand=2, head_dim=16, chunk=16))
