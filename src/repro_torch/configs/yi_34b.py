"""yi-34b — llama-architecture dense transformer with GQA.

[dense] 60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000
[arXiv:2403.04652; hf]
"""

import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="yi-34b",
    family="dense",
    num_layers=60,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=20480,
    vocab_size=64000,
    head_dim=128,
    source="arXiv:2403.04652",
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG, num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=128, vocab_size=256, head_dim=16)
