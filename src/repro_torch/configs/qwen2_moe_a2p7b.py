"""qwen2-moe-a2.7b — fine-grained MoE: 60 routed experts top-4 + 4 shared.

[moe] 24L d_model=2048 16H (GQA kv=16) d_ff=1408 vocab=151936,
MoE 60e top-4 [hf:Qwen/Qwen1.5-MoE-A2.7B; hf]

The 4 shared (always-on) experts are the cache-engine analogue: their
weights are the hot working set every token reuses, while the 60 routed
experts are scheduled bulk traffic.
"""

import dataclasses

from repro_torch.configs.base import ArchConfig, MoESpec

CONFIG = ArchConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,               # routed-expert hidden size
    vocab_size=151936,
    head_dim=128,
    moe=MoESpec(num_experts=60, top_k=4, d_expert=1408,
                num_shared_experts=4, shared_d_expert=1408),
    source="hf:Qwen/Qwen1.5-MoE-A2.7B",
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG, num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=32, vocab_size=256, head_dim=16,
    moe=MoESpec(num_experts=8, top_k=4, d_expert=32,
                num_shared_experts=2, shared_d_expert=32))
