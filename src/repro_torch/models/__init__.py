"""Model zoo: the LM assembly (the dense, MoE and SSM families with text
modality so far).

Counterpart of ``repro.models``.
"""

from repro_torch.models.lm import LM, build_lm

__all__ = ["LM", "build_lm"]
