"""mamba2-2.7b — SSD (state-space duality), attention-free.

[ssm] 64L d_model=2560 d_ff=0 vocab=50280, ssm_state=128
[arXiv:2405.21060; unverified]
"""

import dataclasses

from repro_torch.configs.base import ArchConfig, SSMSpec

CONFIG = ArchConfig(
    name="mamba2-2.7b",
    family="ssm",
    num_layers=64,
    d_model=2560,
    num_heads=80,            # d_inner / ssm head_dim = 5120/64
    num_kv_heads=80,
    d_ff=0,
    vocab_size=50280,
    head_dim=64,
    ssm=SSMSpec(d_state=128, expand=2, head_dim=64, chunk=256),
    source="arXiv:2405.21060",
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG,
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    vocab_size=256,
    head_dim=32,
    ssm=SSMSpec(d_state=16, expand=2, head_dim=32, chunk=16),
)
