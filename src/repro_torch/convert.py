"""Carry state across from the JAX reference package.

Arrays arrive as numpy arrays (``np.asarray`` of a JAX array): tables,
index streams, a ``HotRowCache``'s ``hot_ids`` / ``hot_data``, a
``CacheState``'s six arrays, an LM's parameter tree (``jax.tree.map(
np.asarray, params)``). Configs arrive as the nested dict of
``dataclasses.asdict`` of a reference ``MemoryControllerConfig`` or
``ArchConfig``. Nothing here imports JAX or ``repro``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs import base as arch
from repro_torch.core import config as cfg
from repro_torch.core.cache_engine import CacheState
from repro_torch.core.controller import HotRowCache


def to_tensor(array, device: str | torch.device) -> torch.Tensor:
    """A copy of ``array`` as a tensor on ``device``.

    numpy's bfloat16 (the ``ml_dtypes`` type a JAX bf16 array converts
    to) is refused by ``torch.from_numpy``; its bits travel as uint16 and
    are reinterpreted as ``torch.bfloat16``.
    """
    a = np.array(array)          # a writable copy, whatever came in
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def hot_row_cache(hot_ids, hot_data,
                  device: str | torch.device) -> HotRowCache:
    """A reference ``HotRowCache``'s arrays as the port's, on ``device``."""
    return HotRowCache(hot_ids=to_tensor(hot_ids, device).to(torch.int32),
                       hot_data=to_tensor(hot_data, device))


def cache_state(tags, valid, age, data, clock, dirty,
                device: str | torch.device) -> CacheState:
    """A reference ``CacheState``'s six arrays (in its field order) as the
    port's, on ``device``: int32 tags and ages, bool valid and dirty bits,
    a 0-d int32 clock; the Data RAM keeps its dtype."""
    def i32(a):
        return to_tensor(a, device).to(torch.int32)

    def flag(a):
        return to_tensor(a, device).to(torch.bool)

    return CacheState(tags=i32(tags), valid=flag(valid), age=i32(age),
                      data=to_tensor(data, device),
                      clock=i32(clock).reshape(()), dirty=flag(dirty))


_SUB_CONFIGS = {"scheduler": cfg.SchedulerConfig, "cache": cfg.CacheConfig,
                "dma": cfg.DMAConfig, "channels": cfg.ChannelConfig,
                "dram_sched": cfg.DRAMSchedConfig}


def config_from_dict(d: dict) -> cfg.MemoryControllerConfig:
    """``dataclasses.asdict`` of a reference ``MemoryControllerConfig`` (or
    the same dict after a JSON round trip) as the port's config; the
    constructors validate it as the reference does."""
    kw = dict(d)
    for name, klass in _SUB_CONFIGS.items():
        if name in kw:
            kw[name] = klass(**kw[name])
    if kw.get("faults") is not None:
        f = dict(kw["faults"])
        f["failed_channels"] = tuple(f.get("failed_channels", ()))
        f["outage_windows"] = tuple(tuple(w)
                                    for w in f.get("outage_windows", ()))
        kw["faults"] = cfg.FaultConfig(**f)
    return cfg.MemoryControllerConfig(**kw)


def lm_params(tree, device: str | torch.device):
    """A reference LM's parameter tree (nested dicts, numpy leaves) as the
    port's nested dict of tensors on ``device``, leaf for leaf; bf16
    leaves keep their bits."""
    if isinstance(tree, dict):
        return {k: lm_params(v, device) for k, v in tree.items()}
    return to_tensor(tree, device)


def arch_config_from_dict(d: dict) -> arch.ArchConfig:
    """``dataclasses.asdict`` of a reference ``ArchConfig`` as the port's.
    The reference's ``use_pallas`` is dropped: no reference model reads
    it, and the port's ``use_kernels`` keeps its default (on)."""
    kw = {k: v for k, v in d.items() if k != "use_pallas"}
    if kw.get("moe") is not None:
        kw["moe"] = arch.MoESpec(**kw["moe"])
    if kw.get("ssm") is not None:
        kw["ssm"] = arch.SSMSpec(**kw["ssm"])
    kw["mc"] = config_from_dict(kw["mc"])
    return arch.ArchConfig(**kw)
