"""``shard_map`` in the reference's spelling, over DTensor's ``local_map``.

Counterpart of ``repro.compat``. The reference shims ``jax.shard_map``
across jax versions; here the same call — a function of per-device
shards, with ``in_specs`` / ``out_specs`` in the reference's spec form —
runs on a ``DeviceMesh`` through
``torch.distributed.tensor.experimental.local_map``, so that
``models/moe_ep.py`` reads like the reference's. torch has no
``PartitionSpec``: ``P`` is ``models.sharding.Spec``.

Gradients follow ``jax.shard_map``'s unchecked transpose: an output
replicated over mesh axes passes each rank its cotangent divided by those
axes' size, and an input replicated over mesh axes sums its ranks'
cotangents over them (a ``Partial`` gradient). The collectives a body
calls (``psum``, ``pmean``, ``all_gather``, ``all_to_all``) differentiate
as jax's do.
"""

from __future__ import annotations

import math

import torch
from torch.utils import _pytree as pytree

from repro_torch.models.sharding import Spec, mesh_shape, placements


# torch has no PartitionSpec; ``Spec`` stands in for it.
P = Spec


def _is_spec(x) -> bool:
    return isinstance(x, Spec)


def _specs_like(specs, tree) -> list:
    """One spec per leaf of ``tree``, in ``torch.utils._pytree``'s leaf
    order (dicts in their own key order): ``specs`` is a tree of specs
    shaped like ``tree``, or one spec for the whole subtree."""
    if _is_spec(specs):
        return [specs] * len(pytree.tree_flatten(tree)[0])
    if isinstance(tree, dict):
        return [s for k in tree for s in _specs_like(specs[k], tree[k])]
    if isinstance(tree, (list, tuple)):
        return [s for sp, t in zip(specs, tree) for s in _specs_like(sp, t)]
    raise ValueError(f"no spec for leaf {type(tree).__name__}")


def _sorted_flatten(tree, is_leaf=lambda x: False):
    """(leaves, rebuild) of a tree of dicts, lists and tuples, dict keys
    in sorted order: outputs and their specs flatten alike whatever order
    each dict was built in."""
    if not is_leaf(tree):
        if isinstance(tree, dict):
            keys = sorted(tree)
            parts = [_sorted_flatten(tree[k], is_leaf) for k in keys]
            return _join(parts, lambda xs: dict(zip(keys, xs)))
        if isinstance(tree, (list, tuple)):
            parts = [_sorted_flatten(t, is_leaf) for t in tree]
            make = (type(tree)._make if hasattr(tree, "_fields")
                    else type(tree))
            return _join(parts, make)
    return [tree], lambda it: next(it)


def _join(parts, make):
    leaves = [x for p in parts for x in p[0]]
    return leaves, lambda it: make([p[1](it) for p in parts])


def _replicated(t, mesh):
    """A plain tensor as a DTensor replicated on ``mesh`` (every rank must
    hold the same value); a DTensor as it is."""
    from torch.distributed.tensor import DTensor, Replicate
    if isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def _replicated_size(place, mesh) -> int:
    from torch.distributed.tensor import Replicate
    return math.prod(n for p, n in zip(place, mesh.shape)
                     if isinstance(p, Replicate))


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


def shard_map(f, *, mesh, in_specs, out_specs):
    """``f`` applied to each rank's local shards of DTensor arguments laid
    out by ``in_specs`` (one spec tree per positional argument; inputs in
    another layout are redistributed first), its outputs wrapped as
    DTensors laid out by ``out_specs`` (a tree shaped like ``f``'s
    output). Shards must be even: ``local_map`` rebuilds global shapes
    from local ones."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    out_flat = _sorted_flatten(out_specs, _is_spec)[0]
    out_place = tuple(placements(s, mesh) for s in out_flat)
    rebuild = {}

    def body(*args):
        leaves, rebuild["out"] = _sorted_flatten(f(*args))
        if len(leaves) != len(out_place):
            raise ValueError(f"{len(leaves)} outputs, {len(out_place)} "
                             f"out_specs")
        return tuple(
            _ScaleGrad.apply(x, 1.0 / _replicated_size(p, mesh))
            if isinstance(x, torch.Tensor) and x.requires_grad
            and _replicated_size(p, mesh) > 1 else x
            for x, p in zip(leaves, out_place))

    def call(*args):
        in_place, grad_place = [], []
        for a, s in zip(args, in_specs):
            leaves = pytree.tree_flatten(a)[0]
            for x, spec in zip(leaves, _specs_like(s, a)):
                if not isinstance(x, torch.Tensor):
                    in_place.append(None)
                    grad_place.append(None)
                    continue
                p = placements(spec, mesh)
                in_place.append(p)
                grad_place.append(tuple(
                    Partial() if isinstance(q, Replicate) else q for q in p))
        mapped = local_map(body, out_placements=out_place,
                           in_placements=tuple(in_place),
                           in_grad_placements=tuple(grad_place),
                           device_mesh=mesh, redistribute_inputs=True)
        res = mapped(*(pytree.tree_map_only(
            torch.Tensor, lambda t: _replicated(t, mesh), a) for a in args))
        return rebuild["out"](iter(res))

    return call


# ---------------------------------------------------------------------------
# Collectives inside a body, named by mesh axes
# ---------------------------------------------------------------------------

def _group(mesh, axis: str):
    return mesh.get_group(axis)


def _all_reduce(x, mesh, axes):
    import torch.distributed._functional_collectives as funcol
    for a in axes:
        if mesh_shape(mesh)[a] > 1:
            x = funcol.wait_tensor(funcol.all_reduce(x, "sum",
                                                     _group(mesh, a)))
    return x


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return _all_reduce(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.contiguous(), ctx.mesh, ctx.axes), None, None


def psum(x, axes, mesh):
    """Sum of ``x`` over the ranks of mesh axes ``axes`` (``jax.lax.psum``;
    its gradient is the sum of the ranks' gradients)."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    return _PSum.apply(x.contiguous(), mesh, axes)


def pmean(x, axes, mesh):
    """Mean of ``x`` over the ranks of mesh axes ``axes``
    (``jax.lax.pmean``)."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    n = math.prod(mesh_shape(mesh)[a] for a in axes)
    return psum(x, axes, mesh) / n


def all_gather(x, axis: str, mesh, dim: int = 0):
    """``x`` of every rank of ``axis`` concatenated along ``dim``
    (``jax.lax.all_gather(..., tiled=True)``; its gradient is the
    reduce-scatter)."""
    import torch.distributed._functional_collectives as funcol
    return funcol.all_gather_tensor_autograd(x.contiguous(), dim,
                                             _group(mesh, axis))


def all_to_all(x, axis: str, mesh):
    """Chunk ``i`` of ``x``'s leading dim goes to rank ``i`` of ``axis``;
    chunk ``j`` of the result came from rank ``j``
    (``jax.lax.all_to_all(x, axis, 0, 0)``). One
    ``all_to_all_single``: gloo has no list all-to-all."""
    import torch.distributed._functional_collectives as funcol
    out = funcol.all_to_all_single_autograd(x.contiguous(), None, None,
                                            _group(mesh, axis))
    return funcol.wait_tensor(out)


def axis_index(axis: str, mesh) -> int:
    """This rank's coordinate along ``axis`` (``jax.lax.axis_index``)."""
    return mesh.get_local_rank(axis)
