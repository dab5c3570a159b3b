"""Elastic mesh planning: recompute the mesh when the fleet changes.

Policy: the model (TP) axis is topology-locked — its size is preserved
across rescales so weight shardings and compiled kernels stay aligned with
ICI neighborhoods. Capacity changes are absorbed by the data axis (and the
pod axis in multi-pod jobs): lose a host → data axis shrinks to the largest
multiple that fits, global batch per step is preserved by increasing the
per-device batch or (if not divisible) by gradient accumulation. Restore
is handled by the checkpoint layer (``load_checkpoint(..., mesh=,
specs=)`` re-shards each leaf).

Counterpart of ``repro.runtime.elastic``: the planner in plain Python,
and ``make_mesh_from_plan`` over ``init_device_mesh``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class RescalePlan:
    old_shape: Tuple[int, ...]
    new_shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    grad_accum: int           # extra accumulation to preserve global batch
    dropped_devices: int

    def describe(self) -> str:
        return (f"mesh {dict(zip(self.axis_names, self.old_shape))} -> "
                f"{dict(zip(self.axis_names, self.new_shape))}, "
                f"grad_accum x{self.grad_accum}, "
                f"dropped {self.dropped_devices} devices")


def elastic_mesh_shape(num_devices: int, model_parallel: int,
                       *, pods: int = 1) -> Tuple[int, ...]:
    """Largest (pod, data, model) mesh fitting ``num_devices``."""
    if model_parallel > num_devices:
        raise ValueError("not enough devices for the model axis; "
                         "elastic policy cannot shrink TP")
    per_pod = num_devices // pods
    data = per_pod // model_parallel
    if data < 1:
        raise ValueError("not enough devices per pod for one data shard")
    return (pods, data, model_parallel) if pods > 1 else (
        data, model_parallel)


def plan_rescale(old_shape: Tuple[int, ...], axis_names: Tuple[str, ...],
                 available_devices: int,
                 global_batch: int) -> RescalePlan:
    """Plan the post-failure mesh. Preserves TP; shrinks pods first (a
    dead pod's chips are gone wholesale), then the data axis."""
    sizes = dict(zip(axis_names, old_shape))
    model = sizes.get("model", 1)
    pods = sizes.get("pod", 1)
    full_pod = sizes.get("data", 1) * model
    # a pod is only kept if its full chip complement survives
    pods = max(1, min(pods, available_devices // max(1, full_pod)))
    new_shape = elastic_mesh_shape(available_devices, model, pods=pods)
    new_sizes = dict(zip(("pod", "data", "model") if pods > 1
                         else ("data", "model"), new_shape))
    old_dp = sizes.get("pod", 1) * sizes.get("data", 1)
    new_dp = new_sizes.get("pod", 1) * new_sizes.get("data", 1)
    # keep the global batch: accumulate if the new DP doesn't divide it
    grad_accum = max(1, -(-old_dp // new_dp))
    used = new_sizes.get("pod", 1) * new_sizes.get("data", 1) * model
    names = ("pod", "data", "model") if pods > 1 else ("data", "model")
    return RescalePlan(old_shape=old_shape, new_shape=new_shape,
                       axis_names=names, grad_accum=grad_accum,
                       dropped_devices=available_devices - used)



def make_mesh_from_plan(plan: RescalePlan, device_type: str = "cuda"):
    """The ``DeviceMesh`` of ``plan``'s new shape and axis names over the
    process group's first ranks (the group must be initialized)."""
    from repro_torch.launch.mesh import make_test_mesh
    return make_test_mesh(plan.new_shape, plan.axis_names,
                          device_type=device_type)
