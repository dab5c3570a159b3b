"""Logical-axis sharding rules (t5x/MaxText style, minimal).

Counterpart of ``repro.models.sharding``. Arrays are annotated with
*logical* axis names; ``Rules`` maps them onto mesh axes. One place to
retarget the whole framework when the mesh changes (single-pod ``(data,
model)`` vs multi-pod ``(pod, data, model)``), when a shape degenerates
(``long_500k`` has batch=1 — batch can't shard), or when a layout wants
expert-parallel MoE.

Conventions:
  activations: batch/seq/embed/heads/kv_seq
  weights:     w_fsdp (ZeRO-3 shard dim), w_tp (tensor-parallel dim),
               w_vocab_tp (vocab-sharded head), expert (MoE expert dim)

A ``Spec`` is the reference's ``PartitionSpec``, a tuple: one entry per
tensor dim, ``None`` (replicated), a mesh axis name, or a tuple of names
that shard one dim across several mesh axes, major first.
``placements(spec, mesh)`` turns it into DTensor placements on a
``DeviceMesh`` built with named dims, and ``shard`` is a
``redistribute`` to them that holds the gradient to them too (an
identity off-mesh and on plain tensors).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch

Axis = Union[None, str, Tuple[str, ...]]


class Spec(tuple):
    """The reference's ``PartitionSpec``: a tuple of per-dim entries
    (``Spec("data", None)``), a type of its own so that a tree of specs
    tells its leaves from its tuples."""

    def __new__(cls, *entries: Axis):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"Spec{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class Rules:
    batch: Axis = ("pod", "data")
    seq: Axis = None
    embed: Axis = None          # activation d_model: replicated (Megatron)
    heads: Axis = "model"
    kv_heads: Axis = None       # only sharded when divisible by the TP axis
    kv_seq: Axis = "model"      # decode KV cache: flash-decoding split
    vocab: Axis = "model"
    expert_capacity: Axis = "data"
    w_fsdp: Axis = "data"       # ZeRO-3: shard weights, all-gather at use
    w_tp: Axis = "model"        # Megatron TP dim
    w_vocab_tp: Axis = "model"
    expert: Axis = None         # MoE expert dim ("model" under EP)
    expert_in: Axis = "data"    # expert-weight d_model dim (FSDP under TP)
    expert_out: Axis = "model"  # expert-weight FFN dim (TP); None under EP
    layers: Axis = None         # stacked-layer leading dim

    def spec(self, *logical: Optional[str]) -> Spec:
        return Spec(*(None if name is None else getattr(self, name)
                      for name in logical))


def mesh_shape(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh`` with named dims (or an
    ``AbstractMesh``)."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh's axis names and sizes with no devices and no process
    group (``jax.sharding.AbstractMesh``): enough for ``make_rules``,
    ``build_lm``'s rules and specs, and the dry run's per-device state
    bytes. Its tensors would live on ``meta``."""

    shape: Tuple[int, ...]
    mesh_dim_names: Tuple[str, ...]
    device_type: str = "meta"


def make_rules(mesh, *, global_batch: int = 0, moe_strategy: str = "tp",
               num_kv_heads: int = 0, num_heads: int = 0) -> Rules:
    """Build rules adapted to the mesh topology and workload shape.

    Head dims are only mapped to the TP axis when they divide it (8 KV
    heads on a 16-way axis stay replicated), as in the reference, where a
    non-divisible constraint makes GSPMD invent split layouts.
    """
    if mesh is None:
        # Single-device: everything replicated.
        return Rules(batch=None, heads=None, kv_seq=None, vocab=None,
                     w_fsdp=None, w_tp=None, w_vocab_tp=None,
                     expert_capacity=None, expert_in=None, expert_out=None)
    shape = mesh_shape(mesh)
    names = tuple(shape)
    batch_axes = tuple(a for a in ("pod", "data") if a in names)
    batch: Axis = batch_axes if len(batch_axes) > 1 else (
        batch_axes[0] if batch_axes else None)
    batch_size_on_mesh = 1
    for a in batch_axes:
        batch_size_on_mesh *= shape[a]
    kv_seq: Axis = "model"
    cap: Axis = "data" if "data" in names else None
    if global_batch and global_batch < batch_size_on_mesh:
        # Degenerate batch (long_500k B=1): free the batch axes and use them
        # for the KV/state sequence dim instead.
        batch = None
        kv_seq = tuple(a for a in ("data", "model") if a in names)
        cap = None
    expert: Axis = None
    expert_in: Axis = "data"
    expert_out: Axis = "model"
    if moe_strategy == "ep":
        # all-to-all dispatch (models/moe_ep.py): experts live whole on
        # their owner shard, replicated over data
        expert, expert_in, expert_out = "model", None, None
    tp = shape.get("model", 1)
    heads_ax: Axis = "model" if (num_heads == 0 or num_heads % tp == 0) \
        else None
    kv_ax: Axis = "model" if (num_kv_heads and num_kv_heads % tp == 0) \
        else None
    return Rules(batch=batch, kv_seq=kv_seq, expert=expert,
                 expert_in=expert_in, expert_out=expert_out,
                 expert_capacity=cap, heads=heads_ax, kv_heads=kv_ax)


def serving_weight_overrides(cfg, global_batch: int, mesh) -> dict:
    """Rule overrides for the serve path.

    Batched *dense* decode replicates weights across the data axis — the
    per-step ZeRO-3 all-gathers cost more than the extra weight reads.
    Batch-1 long-context decode and MoE serving keep 2D (FSDP x TP)
    weight sharding: with tiny activations the sharded products read far
    less weight per device, and MoE expert weights are too large to
    replicate profitably.
    """
    if mesh is None or cfg.moe is not None:
        return {}
    shape = mesh_shape(mesh)
    dp = 1
    for a in ("pod", "data"):
        dp *= shape.get(a, 1)
    return {"w_fsdp": None} if global_batch >= dp else {}


def _axes(entry: Axis) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements(spec: Spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(i)`` on each
    mesh dim that tensor dim ``i`` maps to, ``Replicate()`` on every
    other. A tuple entry shards one tensor dim over several mesh dims;
    they must come in the mesh's order (DTensor shards a dim over mesh
    dims major first, left to right). Raises ``ValueError`` for an axis
    the mesh lacks, one used twice, or a tuple out of the mesh's order."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    used = set()
    for i, entry in enumerate(spec):
        axes = _axes(entry)
        idx = []
        for a in axes:
            if a not in names:
                raise ValueError(f"spec {spec}: mesh {names} has no axis "
                                 f"{a!r}")
            if a in used:
                raise ValueError(f"spec {spec}: axis {a!r} used twice")
            used.add(a)
            idx.append(names.index(a))
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: entry {entry} is not in the "
                             f"mesh's axis order {names}")
        for j in idx:
            out[j] = Shard(i)
    return tuple(out)


def spec_of(place, mesh, ndim: int) -> Spec:
    """The spec of DTensor placements ``place`` on ``mesh`` for a tensor
    of ``ndim`` dims: the inverse of ``placements``. Only ``Shard`` and
    ``Replicate`` have a spec."""
    from torch.distributed.tensor import Replicate, Shard
    per_dim = [[] for _ in range(ndim)]
    for name, p in zip(mesh.mesh_dim_names, place):
        if isinstance(p, Shard):
            per_dim[p.dim % ndim].append(name)
        elif not isinstance(p, Replicate):
            raise ValueError(f"placement {p} has no spec")
    return Spec(*(None if not a else (a[0] if len(a) == 1 else tuple(a))
                  for a in per_dim))


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


class _GradTo(torch.autograd.Function):
    """The identity, whose backward redistributes the gradient to
    ``want``: the transpose of a sharding constraint is the same
    constraint, as in the reference. Without it DTensor keeps a gradient
    ``Partial`` where the forward summed partial products (``wo``,
    ``w_down``), and the next product's backward then runs on whole,
    gathered weights on every rank."""

    @staticmethod
    def forward(ctx, x, want):
        ctx.want = want
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) != ctx.want:
            g = g.redistribute(g.device_mesh, ctx.want)
        return g, None


def shard(x, rules: Rules, *logical, mesh=None):
    """``x`` redistributed to the placements of ``rules.spec(*logical)``,
    its gradient held to the same placements (the reference's
    ``with_sharding_constraint``); ``x`` itself off a mesh or when it is
    a plain tensor."""
    if mesh is None or not is_dtensor(x):
        return x
    want = placements(rules.spec(*logical), mesh)
    if tuple(x.placements) != want:
        x = x.redistribute(mesh, want)
    if x.requires_grad and torch.is_grad_enabled():
        x = _GradTo.apply(x, want)
    return x


def distribute(t: torch.Tensor, mesh, spec: Spec):
    """A DTensor on ``mesh`` of ``t``'s global value, laid out by
    ``spec``. Every rank must hold the same ``t`` (the same seeded draw);
    each keeps its own shard of it, with no communication."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(t, mesh, placements(spec, mesh),
                             src_data_rank=None)


def full(x) -> torch.Tensor:
    """The global value of ``x`` as a plain tensor (gathered on every
    rank); ``x`` itself when it is plain."""
    return x.full_tensor() if is_dtensor(x) else x
