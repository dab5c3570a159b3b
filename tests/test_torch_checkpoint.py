"""Port parity for the checkpoint store (``repro_torch.checkpoint``, on
the CPU): the reference's tests/test_checkpoint.py on the port, and the
on-disk layout shared with ``repro.checkpoint``: a checkpoint written by
either package loads in the other bit for bit (bf16 as its uint16 view,
float32, int32, a scalar step; dict, list and named-tuple paths), with
the same manifest and the same file bytes. Every async writer is joined
before a test reads its files; every file lies under ``tmp_path``."""

import json
import os
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import load_checkpoint as jload_checkpoint
from repro.checkpoint import save_checkpoint as jsave_checkpoint
from repro_torch import convert
from repro_torch.checkpoint import (CheckpointManager, latest_step,
                                    load_checkpoint, save_checkpoint)
from repro_torch.models.params import leaves


class Pair(NamedTuple):
    k: object
    v: object


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "params": {"w": torch.randn(8, 4, generator=g).to(torch.bfloat16),
                   "b": torch.randn(4, generator=g)},
        "opt": {"m": torch.zeros(8, 4), "step": torch.tensor(7,
                                                             dtype=torch.int32)},
    }


def _bits(t: torch.Tensor) -> np.ndarray:
    """A tensor's bytes, as numpy (bf16 through its int16 view)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy()


def _same(a, b) -> None:
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(_bits(a), _bits(b))


# ---------------------------------------------------------------------------
# The reference's tests/test_checkpoint.py, on the port
# ---------------------------------------------------------------------------

def test_roundtrip_including_bf16(tmp_path):
    tree = _tree()
    save_checkpoint(str(tmp_path), 7, tree)
    back = load_checkpoint(str(tmp_path), 7, tree)
    for a, b in zip(leaves(tree), leaves(back)):
        _same(a, b)


def test_latest_step_ignores_partial(tmp_path):
    tree = _tree()
    save_checkpoint(str(tmp_path), 5, tree)
    save_checkpoint(str(tmp_path), 10, tree)
    # a crash mid-save: a tmp dir without manifest
    os.makedirs(tmp_path / "step_99.tmp")
    (tmp_path / "step_99.tmp" / "junk.npy").write_bytes(b"x")
    # and a finalized-looking dir without manifest
    os.makedirs(tmp_path / "step_50")
    assert latest_step(str(tmp_path)) == 10
    assert latest_step(str(tmp_path / "absent")) is None


def test_missing_leaf_raises(tmp_path):
    tree = _tree()
    save_checkpoint(str(tmp_path), 1, tree)
    bigger = {**tree, "extra": torch.zeros(2)}
    with pytest.raises(ValueError, match="missing leaves"):
        load_checkpoint(str(tmp_path), 1, bigger)


def test_manager_retention_and_async(tmp_path):
    tree = _tree()
    mgr = CheckpointManager(str(tmp_path), save_every=2, keep=2)
    for step in range(1, 9):
        mgr.maybe_save(step, tree)
    mgr.wait()
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(tmp_path)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    assert steps == [6, 8]


def test_restore_latest_roundtrip(tmp_path):
    tree = _tree()
    mgr = CheckpointManager(str(tmp_path), save_every=1)
    mgr.maybe_save(3, tree)
    mgr.wait()
    step, back = mgr.restore_latest(tree)
    assert step == 3
    _same(back["params"]["w"], tree["params"]["w"])


def test_restore_latest_none_when_empty(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    step, back = mgr.restore_latest(_tree())
    assert step is None and back is None


# ---------------------------------------------------------------------------
# The port's own behaviour
# ---------------------------------------------------------------------------

def test_save_snapshots_before_returning(tmp_path):
    """The leaves are copied before ``save_checkpoint`` returns: a change
    to a leaf while the writer runs is not in the checkpoint."""
    tree = _tree()
    want = tree["opt"]["m"].clone()
    thread = save_checkpoint(str(tmp_path), 2, tree, blocking=False)
    tree["opt"]["m"].add_(1.0)
    thread.join(timeout=60)
    assert not thread.is_alive()
    _same(load_checkpoint(str(tmp_path), 2, tree)["opt"]["m"], want)


def test_load_places_leaves_on_the_target_device_and_keeps_dtype(tmp_path):
    """Each leaf comes back in the dtype the manifest records (not the
    target's) and as a new tensor."""
    tree = _tree()
    save_checkpoint(str(tmp_path), 4, tree)
    target = {"params": {"w": torch.zeros(8, 4), "b": torch.zeros(4)},
              "opt": {"m": torch.zeros(8, 4), "step": torch.zeros(())}}
    back = load_checkpoint(str(tmp_path), 4, target)
    assert back["params"]["w"].dtype == torch.bfloat16
    assert back["opt"]["step"].dtype == torch.int32
    assert all(t.device.type == "cpu" for t in leaves(back))
    back["opt"]["m"].add_(1.0)
    assert not tree["opt"]["m"].any()


# ---------------------------------------------------------------------------
# Across the packages
# ---------------------------------------------------------------------------

def _mixed_numpy(seed=1):
    """A tree of numpy float32 / int32 leaves with a list and a named
    tuple, and which leaves are bf16 in the checkpoint."""
    rng = np.random.default_rng(seed)
    return {"params": {"embed": rng.standard_normal((6, 4)),
                       "layers": [rng.standard_normal((3, 2)),
                                  rng.standard_normal(5)]},
            "cache": Pair(k=rng.standard_normal((2, 2)),
                          v=rng.standard_normal(3)),
            "opt": {"m": rng.standard_normal((6, 4)),
                    "step": np.asarray(11, np.int32)}}


def _as(tree, leaf):
    if isinstance(tree, dict):
        return {k: _as(v, leaf) for k, v in tree.items()}
    if isinstance(tree, Pair):
        return Pair(*(_as(x, leaf) for x in tree))
    if isinstance(tree, list):
        return [_as(x, leaf) for x in tree]
    return leaf(tree)


def _jax_tree():
    def leaf(a):
        if a.dtype == np.int32:
            return jnp.asarray(a)
        # matrices in bf16, vectors in float32
        return jnp.asarray(a, jnp.bfloat16 if a.ndim == 2 else jnp.float32)
    return _as(_mixed_numpy(), leaf)


def _files(path):
    return {name: (path / name).read_bytes() for name in os.listdir(path)
            if name.endswith(".npy")}


def test_reference_checkpoint_loads_in_the_port_bit_for_bit(tmp_path):
    jtree = _jax_tree()
    jsave_checkpoint(str(tmp_path), 3, jtree)
    target = _as(_mixed_numpy(), lambda a: torch.zeros(a.shape))
    back = load_checkpoint(str(tmp_path), 3, target)
    jl = jax.tree.leaves(jtree)
    tl = jax.tree.leaves(back, is_leaf=lambda x: isinstance(x, torch.Tensor))
    assert len(jl) == len(tl) == 7
    for j, t in zip(jl, tl):
        _same(t, convert.to_tensor(np.asarray(j), "cpu"))
    assert isinstance(back["cache"], Pair)
    assert isinstance(back["params"]["layers"], list)


def test_port_checkpoint_loads_in_the_reference_bit_for_bit(tmp_path):
    """The port writes the reference's manifest and the same file bytes,
    and the reference loads it bit for bit."""
    jtree = _jax_tree()
    ttree = jax.tree.map(lambda j: convert.to_tensor(np.asarray(j), "cpu"),
                         jtree)
    save_checkpoint(str(tmp_path / "port"), 3, ttree)
    jsave_checkpoint(str(tmp_path / "ref"), 3, jtree)
    ours, theirs = tmp_path / "port" / "step_3", tmp_path / "ref" / "step_3"
    assert json.loads((ours / "manifest.json").read_text()) == \
        json.loads((theirs / "manifest.json").read_text())
    assert _files(ours) == _files(theirs)
    back = jload_checkpoint(str(tmp_path / "port"), 3, jtree)
    for j, b in zip(jax.tree.leaves(jtree), jax.tree.leaves(back)):
        assert j.dtype == b.dtype and j.shape == b.shape
        np.testing.assert_array_equal(
            np.asarray(j).reshape(-1).view(np.uint8),
            np.asarray(b).reshape(-1).view(np.uint8))
