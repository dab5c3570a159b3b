"""internvl2-76b — VLM: InternViT frontend + llama-arch 70B-class backbone.

[vlm] 80L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256
[arXiv:2404.16821; unverified]

Per the assignment, only the transformer BACKBONE is modeled; the InternViT
frontend is a STUB — ``input_specs()`` provides precomputed patch embeddings
(B, num_vision_tokens, frontend_dim) which the connector MLP projects into
the token stream ahead of the text tokens. Loss is masked to text positions.
"""

import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-76b",
    family="vlm",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    head_dim=128,
    modality="vision_text",
    frontend_dim=3200,       # InternViT-6B output width (stubbed)
    num_vision_tokens=256,
    source="arXiv:2404.16821",
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG, num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=128, vocab_size=256, head_dim=16, frontend_dim=48,
    num_vision_tokens=8)
