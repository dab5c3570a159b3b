"""Architecture registry: ``get_arch(name)`` / ``--arch <id>`` resolution.

Each assigned architecture lives in its own module defining ``CONFIG``
(the exact assigned configuration) and ``SMOKE_CONFIG`` (a reduced
same-family configuration for CPU smoke tests).
"""

from __future__ import annotations

import importlib

ARCH_IDS = [
    "mamba2_2p7b",
    "yi_34b",
    "granite_34b",
    "h2o_danube_1p8b",
    "internlm2_20b",
    "hubert_xlarge",
    "jamba_v0p1_52b",
    "qwen2_moe_a2p7b",
    "mixtral_8x7b",
    "internvl2_76b",
]

# accept dashed/official ids too
_ALIASES = {
    "mamba2-2.7b": "mamba2_2p7b",
    "yi-34b": "yi_34b",
    "granite-34b": "granite_34b",
    "h2o-danube-1.8b": "h2o_danube_1p8b",
    "internlm2-20b": "internlm2_20b",
    "hubert-xlarge": "hubert_xlarge",
    "jamba-v0.1-52b": "jamba_v0p1_52b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2p7b",
    "mixtral-8x7b": "mixtral_8x7b",
    "internvl2-76b": "internvl2_76b",
}


def canonical(name: str) -> str:
    name = name.strip()
    return _ALIASES.get(name, name)


def get_arch(name: str, smoke: bool = False):
    cname = canonical(name)
    if cname not in ARCH_IDS:
        raise KeyError(f"unknown arch '{name}'; known: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{cname}")
    return mod.SMOKE_CONFIG if smoke else mod.CONFIG


def all_archs(smoke: bool = False):
    return {a: get_arch(a, smoke) for a in ARCH_IDS}
