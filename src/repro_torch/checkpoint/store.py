"""Atomic, async checkpointing of tensor trees.

Counterpart of ``repro.checkpoint.store``, on its on-disk layout, so that
a checkpoint written by either package loads in the other bit for bit:

* **Layout** — one ``.npy`` per leaf under ``<dir>/step_<N>.tmp/``, named
  by the leaf's tree path (``params/embed/table`` →
  ``params__embed__table.npy``), plus ``manifest.json`` (paths, shapes,
  dtypes, step). numpy has no bfloat16 or float8, so such a leaf is stored
  as a same-width unsigned view and its logical dtype is recorded in the
  manifest. The directory is renamed to ``step_<N>/`` after every leaf
  and the manifest are written, so a crash mid-save never leaves a
  directory that ``latest_step`` would pick up.
* **Async** — ``save_checkpoint`` copies the leaves to host memory before
  it returns, then writes them on a daemon thread; ``wait()`` joins it.
* **Retention** — ``CheckpointManager`` keeps the last ``keep``
  checkpoints.

Trees are nested dicts, lists and tuples of tensors. ``load_checkpoint``
places each leaf on the device of the target tree's leaf, or, with
``mesh`` and ``specs``, as a DTensor laid out by its spec: loading onto
another mesh than the one that saved re-shards each leaf (elastic
restart). A tree of DTensors is saved as its global values, gathered on
every rank and written by rank 0 of the process group, so the files are
the same whatever mesh wrote them.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

_STEP_RE = re.compile(r"^step_(\d+)$")

# The dtypes numpy cannot hold, by the reference's names: the torch dtype,
# the unsigned numpy carrier of the same width that the file holds, and
# the integer type (torch, numpy) that both libraries read those bits as
# (torch.from_numpy takes no uint16).
_EXOTIC = {"bfloat16": (torch.bfloat16, np.uint16, torch.int16, np.int16),
           "float8_e4m3fn": (torch.float8_e4m3fn, np.uint8, torch.uint8,
                             np.uint8),
           "float8_e5m2": (torch.float8_e5m2, np.uint8, torch.uint8,
                           np.uint8)}


def _encode(t: torch.Tensor):
    """(numpy array, dtype name) of a CPU tensor."""
    for name, (logical, carrier, bits, _) in _EXOTIC.items():
        if t.dtype == logical:
            return t.view(bits).numpy().view(carrier), name
    arr = t.numpy()
    return arr, str(arr.dtype)


def _decode(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name in _EXOTIC:
        logical, _, _, bits = _EXOTIC[dtype_name]
        return torch.from_numpy(arr.view(bits)).view(logical)
    return torch.from_numpy(arr)


def _flatten_with_paths(tree, prefix: str = "") -> dict:
    """{path: leaf} in ``jax.tree_util``'s order and naming: dict keys
    sorted, sequence positions as indices, named-tuple fields by name."""
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = list(zip(tree._fields, tree))
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), x) for i, x in enumerate(tree)]
    else:
        return {prefix: tree}
    out = {}
    for key, sub in items:
        out.update(_flatten_with_paths(sub, f"{prefix}/{key}" if prefix
                                       else key))
    return out


def _unflatten(tree, values):
    """``tree``'s structure with its leaves replaced, in
    ``_flatten_with_paths``'s order, by ``values`` (an iterator)."""
    if isinstance(tree, dict):
        return {k: _unflatten(tree[k], values) for k in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_unflatten(x, values) for x in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(x, values) for x in tree)
    return next(values)


def _rank() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


def _host_copy(v) -> torch.Tensor:
    """A leaf's global value on the host (a DTensor gathered first)."""
    from repro_torch.models.sharding import full
    return full(torch.as_tensor(v).detach()).to("cpu", copy=True)


def save_checkpoint(directory: str, step: int, tree: Any,
                    *, blocking: bool = True) -> threading.Thread:
    """Write ``tree`` under ``directory/step_<step>``; atomic via rename.
    The leaves are copied to host memory before this returns, so the
    caller may change them at once; with ``blocking=False`` the files are
    written on the returned thread."""
    leaves = {k: _host_copy(v) for k, v in _flatten_with_paths(tree).items()}
    if _rank() != 0:
        t = threading.Thread(target=lambda: None)
        t.start()
        if blocking:
            _barrier()
        return t
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, f"step_{step}.tmp")
    final = os.path.join(directory, f"step_{step}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)

    def write():
        os.makedirs(tmp, exist_ok=True)
        manifest = {"step": step, "leaves": {}}
        for key, t in leaves.items():
            fname = key.replace("/", "__") + ".npy"
            carrier, dtype_name = _encode(t)
            np.save(os.path.join(tmp, fname), carrier)
            manifest["leaves"][key] = {
                "file": fname, "shape": list(t.shape), "dtype": dtype_name}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)

    t = threading.Thread(target=write, daemon=True)
    t.start()
    if blocking:
        t.join()
        _barrier()
    return t


def _barrier() -> None:
    """Every rank waits until rank 0 has written (nothing off a process
    group)."""
    import torch.distributed as dist
    if dist.is_initialized():
        dist.barrier()


def latest_step(directory: str) -> Optional[int]:
    """The largest step with a complete checkpoint (its manifest written
    and its directory renamed), or None."""
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        m = _STEP_RE.match(name)
        if m and os.path.exists(os.path.join(directory, name,
                                             "manifest.json")):
            steps.append(int(m.group(1)))
    return max(steps) if steps else None


def load_checkpoint(directory: str, step: int, target_tree: Any, *,
                    mesh=None, specs=None) -> Any:
    """Restore into the structure of ``target_tree``: each leaf in the
    dtype the manifest records, on the device of the target's leaf (the
    CPU where the target's leaf is no tensor). With ``mesh`` and
    ``specs`` (a tree of specs like the target's) each leaf is read whole
    by every rank and kept as its shard of a DTensor laid out by its spec.
    Raises ``ValueError`` if a leaf of the target is missing."""
    path = os.path.join(directory, f"step_{step}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)

    targets = _flatten_with_paths(target_tree)
    missing = [k for k in targets if k not in manifest["leaves"]]
    if missing:
        raise ValueError(f"checkpoint missing leaves: {missing[:5]} ...")

    spec_leaves = {}
    if mesh is not None and specs is not None:
        from repro_torch.models.sharding import Spec
        spec_leaves = _flatten_with_paths(_specs_as_leaves(specs, Spec))

    def load(key, target):
        meta = manifest["leaves"][key]
        t = _decode(np.load(os.path.join(path, meta["file"])), meta["dtype"])
        if key in spec_leaves:
            from repro_torch.models.sharding import distribute
            return distribute(t.to(mesh.device_type), mesh,
                              spec_leaves[key].spec)
        device = target.device if isinstance(target, torch.Tensor) else "cpu"
        return t.to(device)

    return _unflatten(target_tree, iter([load(k, t)
                                         for k, t in targets.items()]))


@dataclasses.dataclass(frozen=True)
class _SpecLeaf:
    spec: tuple


def _specs_as_leaves(specs, spec_type):
    """``specs`` with each spec wrapped, so that ``_flatten_with_paths``
    stops at it (a spec is itself a tuple)."""
    if isinstance(specs, spec_type):
        return _SpecLeaf(specs)
    if isinstance(specs, dict):
        return {k: _specs_as_leaves(v, spec_type) for k, v in specs.items()}
    if isinstance(specs, tuple) and hasattr(specs, "_fields"):
        return type(specs)(*(_specs_as_leaves(v, spec_type) for v in specs))
    if isinstance(specs, (list, tuple)):
        return type(specs)(_specs_as_leaves(v, spec_type) for v in specs)
    return specs


@dataclasses.dataclass
class CheckpointManager:
    """Save-every-K orchestration with retention and async writes."""

    directory: str
    save_every: int = 100
    keep: int = 3
    _pending: Optional[threading.Thread] = None

    def maybe_save(self, step: int, tree: Any) -> bool:
        if step % self.save_every:
            return False
        self.wait()
        self._pending = save_checkpoint(self.directory, step, tree,
                                        blocking=False)
        return True

    def wait(self) -> None:
        """Join the pending write, then drop all but the last ``keep``
        checkpoints."""
        if self._pending is not None:
            self._pending.join()
            self._pending = None
            _barrier()
        self._gc()

    def _gc(self) -> None:
        if not os.path.isdir(self.directory):
            return
        steps = sorted(
            int(m.group(1)) for m in
            (_STEP_RE.match(n) for n in os.listdir(self.directory)) if m)
        for s in steps[:-self.keep] if len(steps) > self.keep else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s}"),
                          ignore_errors=True)

    def restore_latest(self, target_tree: Any, *, mesh=None, specs=None):
        """(step, tree) of the latest complete checkpoint, or (None,
        None); onto ``mesh`` laid out by ``specs`` when given."""
        step = latest_step(self.directory)
        if step is None:
            return None, None
        return step, load_checkpoint(self.directory, step, target_tree,
                                     mesh=mesh, specs=specs)
