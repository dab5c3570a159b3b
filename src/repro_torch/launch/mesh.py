"""Mesh construction.

Counterpart of ``repro.launch.mesh``. Defined as functions (never
module-level constants), so importing this module touches no process
group. The shapes are the reference's layout — one v5e pod's 16x16
``(data, model)`` mesh, and 2x16x16 with a pure-DP ``pod`` axis prepended
for multi-pod — kept so that the dry run's cells and rules (8 KV heads
on a 16-way axis stay replicated, for one) are the reference's; they are
not an H100 cluster plan. The process group must be initialized with the
mesh's number of ranks (the dry run uses the ``fake`` backend).
"""

from __future__ import annotations

import math


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_test_mesh(shape, axes, device_type=device_type)


def make_test_mesh(shape=(2, 2), axes=("data", "model"),
                   device_type: str = "cuda"):
    """A mesh of ``shape`` named ``axes`` over the process group's first
    ranks (gloo processes on the CPU in the tests); a rank beyond them
    holds no shard."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
    need = math.prod(shape)
    have = dist.get_world_size()
    if have < need:
        raise RuntimeError(f"mesh {shape} needs {need} ranks, have {have}")
    if have == need:
        return init_device_mesh(device_type, tuple(shape),
                                mesh_dim_names=tuple(axes))
    return DeviceMesh(device_type, torch.arange(need).reshape(shape),
                      mesh_dim_names=tuple(axes))
