"""granite-34b — llama-architecture code model with MQA (kv=1).

[dense] 88L d_model=6144 48H (GQA kv=1) d_ff=24576 vocab=49152
[arXiv:2405.04324; hf]
"""

import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-34b",
    family="dense",
    num_layers=88,
    d_model=6144,
    num_heads=48,
    num_kv_heads=1,          # multi-query attention
    d_ff=24576,
    vocab_size=49152,
    head_dim=128,
    source="arXiv:2405.04324",
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG, num_layers=2, d_model=64, num_heads=4, num_kv_heads=1,
    d_ff=128, vocab_size=256, head_dim=16)
