"""hubert-xlarge — encoder-only audio transformer (wav2vec2 architecture).

[audio] 48L d_model=1280 16H (GQA kv=16) d_ff=5120 vocab=504
[arXiv:2106.07447; unverified]

The convolutional waveform frontend is a STUB per the assignment:
``input_specs()`` supplies precomputed frame embeddings (B, S, frontend_dim)
and the model starts at the connector projection. Encoder-only ⇒ no decode
shapes; trained with masked-frame cluster prediction (HuBERT objective) on
the 504-way cluster vocabulary.
"""

import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="hubert-xlarge",
    family="encoder",
    num_layers=48,
    d_model=1280,
    num_heads=16,
    num_kv_heads=16,
    d_ff=5120,
    vocab_size=504,
    head_dim=80,
    causal=False,            # bidirectional encoder
    modality="audio",
    frontend_dim=512,        # conv feature extractor output size (stub)
    source="arXiv:2106.07447",
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG, num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=128, vocab_size=64, head_dim=16, frontend_dim=32)
