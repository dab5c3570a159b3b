"""Roofline terms of one step from counted work, with H100 constants.

Counterpart of ``repro.launch.roofline``. The reference reads XLA's cost
analysis and the collectives of the compiled, partitioned HLO; the port
has no HLO, so ``dryrun.count_step`` runs the step once on ``meta``
DTensors and counts, per device:

  * FLOPs — ``LocalFlops``: ``torch.utils.flop_counter.FlopCounterMode``'s
    formulas over the ops each rank runs on its local shards (matrix
    products, attention);
  * memory bytes — every op's operand and result bytes (``OpBytesMode``;
    eager ops, no fusion, where XLA's "bytes accessed" is after fusion);
  * collective bytes — ``CollectiveBytes``, a ``CommDebugMode`` that also
    sizes each collective by the reference's operand rules
    (``collective_bytes_from_hlo``): all-gather, all-reduce and
    all-to-all their result, reduce-scatter its result times the group.

Hardware constants (NVIDIA H100 SXM, per GPU): 989 TFLOP/s bf16 dense on
the tensor cores, 3.35 TB/s HBM3, and 450 GB/s for collectives — one
direction of NVLink 4's 900 GB/s. A mesh axis wider than the 8 GPUs of
one node crosses the inter-node network, which this constant does not
model; the reference's single ICI figure ignores topology too.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
from torch.distributed.tensor.debug import CommDebugMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
COLLECTIVE_BW = 450e9

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
# functional-collective op names -> the reference's HLO kind
_KIND = {"all_gather_into_tensor": "all-gather",
         "all_gather_into_tensor_coalesced": "all-gather",
         "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
         "reduce_scatter_tensor": "reduce-scatter",
         "reduce_scatter_tensor_coalesced": "reduce-scatter",
         "all_to_all_single": "all-to-all"}
# ops that move no bytes of their own
_FREE = {"view", "_unsafe_view", "reshape", "expand", "permute", "t",
         "transpose", "select", "slice", "squeeze", "unsqueeze", "as_strided",
         "alias", "detach", "empty", "empty_like", "empty_strided",
         "new_empty", "new_empty_strided", "split", "split_with_sizes",
         "unbind", "chunk", "narrow", "view_as", "lift_fresh", "wait_tensor",
         "unfold", "diagonal"}


def _tensor_bytes(xs) -> int:
    return sum(t.numel() * t.element_size()
               for t in tree_flatten(xs)[0] if isinstance(t, torch.Tensor))


def _op_name(func) -> str:
    return func._overloadpacket.__name__


def _defer(func, args, kwargs) -> bool:
    """Whether a counter must not count this op: a DTensor op (DTensor
    runs it as local ops and collectives, which the counter then sees)
    or a higher-order operator. The ``FakeTensor`` ops that DTensor's
    sharding propagation runs at global shapes are filtered by
    ``_propagation``."""
    from torch.distributed.tensor import DTensor
    return isinstance(func, torch._ops.HigherOrderOperator) or any(
        isinstance(t, DTensor) for t in tree_flatten((args, kwargs))[0])


def _propagation(args, kwargs) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor
    return any(isinstance(t, FakeTensor)
               for t in tree_flatten((args, kwargs))[0])


class LocalFlops(TorchDispatchMode):
    """FLOPs of the ops each rank runs on its local shards, by
    ``FlopCounterMode``'s formulas (matrix products, attention,
    convolutions). A ``FlopCounterMode`` entered around DTensor code
    counts each DTensor op at its global shape (and, on recent torch, the
    local op again); this mode hands DTensor ops back to DTensor and
    counts only what reaches the ranks' tensors."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import FlopCounterMode
        self.registry = FlopCounterMode(display=False).flop_registry
        self.flops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _defer(func, args, kwargs):
            return NotImplemented
        out = func(*args, **kwargs)
        count = self.registry.get(func._overloadpacket)
        if count is not None and not _propagation(args, kwargs):
            self.flops += count(*args, **kwargs, out_val=out)
        return out


class CollectiveBytes(CommDebugMode):
    """``CommDebugMode`` that also sums each collective's bytes by kind,
    by the reference's operand rules (``detail``)."""

    def __init__(self):
        super().__init__()
        self.detail = {k: 0 for k in COLLECTIVES}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if out is NotImplemented or isinstance(
                func, torch._ops.HigherOrderOperator):
            return out
        kind = _KIND.get(_op_name(func))
        if kind == "reduce-scatter":
            self.detail[kind] += _tensor_bytes(args[0])
        elif kind is not None:
            self.detail[kind] += _tensor_bytes(out)
        return out


class OpBytesMode(TorchDispatchMode):
    """Sums the operand and result bytes of every op that computes on a
    rank's tensors (views and allocations move nothing)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _defer(func, args, kwargs):
            return NotImplemented
        out = func(*args, **kwargs)
        if _op_name(func) not in _FREE and _op_name(func) not in _KIND \
                and not _propagation(args, kwargs):
            self.bytes += _tensor_bytes((args, kwargs)) + _tensor_bytes(out)
        return out


@dataclasses.dataclass
class RooflineReport:
    name: str
    chips: int
    hlo_flops: float              # per-device FLOPs x chips = global
    hbm_bytes: float              # per-device bytes x chips = global
    collective_bytes: float       # per-device summed operand bytes
    collectives_detail: Dict[str, int]
    model_flops: float            # 6·N·D analytic
    bytes_per_device: Optional[float] = None

    @property
    def compute_s(self) -> float:
        return self.hlo_flops / (self.chips * PEAK_FLOPS)

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes / (self.chips * HBM_BW)

    @property
    def collective_s(self) -> float:
        # collective_bytes is already per device; each GPU drives its own
        # NVLink ports
        return self.collective_bytes / COLLECTIVE_BW

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=lambda k: terms[k])

    @property
    def useful_flops_ratio(self) -> float:
        return self.model_flops / max(self.hlo_flops, 1.0)

    @property
    def roofline_fraction(self) -> float:
        """model-FLOPs time at peak / achievable bound time — the score."""
        ideal_s = self.model_flops / (self.chips * PEAK_FLOPS)
        return ideal_s / max(self.bound_s, 1e-30)

    def row(self) -> str:
        return (f"| {self.name} | {self.hlo_flops:.3e} | "
                f"{self.compute_s * 1e3:.2f} | {self.memory_s * 1e3:.2f} | "
                f"{self.collective_s * 1e3:.2f} | {self.bottleneck} | "
                f"{self.useful_flops_ratio:.2f} | "
                f"{self.roofline_fraction:.2f} |")


@dataclasses.dataclass
class StepCounts:
    """Per-device work of one step (``dryrun.count_step``)."""

    flops: float
    hbm_bytes: float
    collectives_detail: Dict[str, int]


def analyze(name: str, counts: StepCounts, *, chips: int, model_flops: float,
            bytes_per_device: Optional[float] = None) -> RooflineReport:
    return RooflineReport(
        name=name, chips=chips,
        hlo_flops=counts.flops * chips,
        hbm_bytes=counts.hbm_bytes * chips,
        collective_bytes=float(sum(counts.collectives_detail.values())),
        collectives_detail=dict(counts.collectives_detail),
        model_flops=model_flops, bytes_per_device=bytes_per_device)


def model_flops_for(cfg, shape, n_params_active: int) -> float:
    """6·N_active·D for training, 2·N_active·D for inference."""
    mult = 6.0 if shape.kind == "train" else 2.0
    tokens = shape.tokens if shape.kind != "decode" else shape.global_batch
    return mult * n_params_active * tokens
