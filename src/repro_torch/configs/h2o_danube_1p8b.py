"""h2o-danube-1.8b — llama+mistral mix with sliding-window attention.

[dense] 24L d_model=2560 32H (GQA kv=8) d_ff=6912 vocab=32000
[arXiv:2401.16818; hf]
"""

import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="h2o-danube-1.8b",
    family="dense",
    num_layers=24,
    d_model=2560,
    num_heads=32,
    num_kv_heads=8,
    d_ff=6912,
    vocab_size=32000,
    head_dim=80,
    attn_window=4096,        # mistral-style SWA ⇒ sub-quadratic, runs long_500k
    source="arXiv:2401.16818",
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG, num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=128, vocab_size=256, head_dim=16, attn_window=8)
