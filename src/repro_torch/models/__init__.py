"""Model zoo: the LM assembly for every family of the registry (dense,
MoE, SSM, hybrid, audio encoder, VLM).

Counterpart of ``repro.models``.
"""

from repro_torch.models.lm import LM, build_lm

__all__ = ["LM", "build_lm"]
