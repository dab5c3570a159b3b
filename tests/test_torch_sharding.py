"""The port's logical-axis sharding (``repro_torch.models.sharding``)
against the reference's, in process, on abstract meshes (no devices):
for all ten architectures on the (2,2), (4,2), (16,16) and (2,16,16)
meshes, and each architecture's supported shapes' global batches (the
long-context batch of 1 frees the batch axes), ``param_specs``,
``cache_specs``, ``batch_specs`` and ``opt_state_specs`` equal the
reference's ``PartitionSpec``s entry by entry, and the dry run's
per-device state bytes equal the reference's exactly. ``placements``
turns each spec into DTensor placements and ``spec_of`` turns them back.
"""

import os

import jax
import pytest
from jax.sharding import AbstractMesh as JAbstractMesh
from jax.sharding import PartitionSpec

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_arch as jget_arch
from repro.configs import supported_shapes as jsupported
from repro.data.synthetic import batch_specs as jbatch_specs
from repro.models.lm import build_lm as jbuild_lm
from repro.models.sharding import make_rules as jmake_rules
from repro.models.sharding import serving_weight_overrides as jserving
from repro.optim.adamw import abstract_opt_state as jabstract_opt
from repro.optim.adamw import opt_state_specs as jopt_specs
from repro_torch.configs import SHAPES, get_arch
from repro_torch.configs.registry import ARCH_IDS
from repro_torch.data.synthetic import batch_specs
from repro_torch.models.lm import build_lm
from repro_torch.models.sharding import (AbstractMesh, Rules, Spec,
                                         make_rules, placements,
                                         serving_weight_overrides, spec_of)
from repro_torch.optim.adamw import abstract_opt_state, opt_state_specs

MESHES = {"2x2": ((2, 2), ("data", "model")),
          "4x2": ((4, 2), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


@pytest.fixture(scope="module")
def jdryrun():
    """The reference's dry-run module. Importing it sets ``XLA_FLAGS``
    (512 host devices, for its own process); the variable is put back at
    once, before anything here starts jax."""
    before = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as mod
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before
    return mod


def _jleaves(tree):
    return jax.tree.leaves(tree, is_leaf=lambda x: isinstance(x,
                                                              PartitionSpec))


def _leaves(tree):
    """Spec or tensor leaves in ``jax.tree.leaves``' order: dict keys
    sorted, named-tuple fields in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, tuple) and not isinstance(tree, Spec):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _same_specs(port_tree, ref_tree):
    got = [tuple(s) for s in _leaves(port_tree)]
    want = [tuple(s) for s in _jleaves(ref_tree)]
    assert got == want


def _meshes(name):
    shape, axes = MESHES[name]
    return AbstractMesh(shape, axes), JAbstractMesh(shape, axes)


def _cells(arch):
    return [(s, SHAPES[s]) for s in jsupported(jget_arch(arch))]


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_equal_the_reference(arch, mesh_name):
    mesh, jmesh = _meshes(mesh_name)
    cfg, jcfg = get_arch(arch), jget_arch(arch)
    for shape_name, shape in _cells(arch):
        for strategy in ("tp", "ep"):
            if strategy == "ep" and (cfg.moe is None
                                     or cfg.moe.num_shared_experts
                                     or cfg.moe.num_experts
                                     % dict(zip(mesh.mesh_dim_names,
                                                mesh.shape))["model"]):
                continue
            lm = build_lm(cfg, mesh, global_batch=shape.global_batch,
                          moe_strategy=strategy)
            jlm = jbuild_lm(jcfg, jmesh, global_batch=shape.global_batch,
                            moe_strategy=strategy)
            assert tuple(lm.rules.spec(*Rules.__dataclass_fields__)) == \
                tuple(jlm.rules.spec(*Rules.__dataclass_fields__))
            _same_specs(lm.param_specs(), jlm.param_specs())
            _same_specs(lm.cache_specs(), jlm.cache_specs())
            _same_specs(opt_state_specs(lm.param_specs()),
                        jopt_specs(jlm.param_specs()))
            if shape.kind == "train":
                shapes, specs = batch_specs(cfg, shape, lm.rules)
                jshapes, jspecs = jbatch_specs(jcfg, JSHAPES[shape_name],
                                               jlm.rules)
                assert sorted(specs) == sorted(jspecs)
                for k in specs:
                    assert tuple(specs[k]) == tuple(jspecs[k])
                    assert tuple(shapes[k].shape) == jshapes[k].shape
                    assert str(shapes[k].dtype).split(".")[-1] == \
                        str(jshapes[k].dtype)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_state_bytes_per_device_equal_the_reference(arch, mesh_name,
                                                    jdryrun):
    from repro_torch.launch.dryrun import estimate_state_bytes_per_device
    mesh, jmesh = _meshes(mesh_name)
    cfg, jcfg = get_arch(arch), jget_arch(arch)
    for shape_name, shape in _cells(arch):
        lm = build_lm(cfg, mesh, global_batch=shape.global_batch)
        jlm = jbuild_lm(jcfg, jmesh, global_batch=shape.global_batch)
        p = estimate_state_bytes_per_device(lm.abstract_params(),
                                            lm.param_specs(), mesh)
        jp = jdryrun.estimate_state_bytes_per_device(
            jlm.abstract_params(), jlm.param_specs(), jmesh)
        assert p == jp
        if shape.kind == "train":
            o = estimate_state_bytes_per_device(
                abstract_opt_state(lm.abstract_params()),
                opt_state_specs(lm.param_specs()), mesh)
            jo = jdryrun.estimate_state_bytes_per_device(
                jabstract_opt(jlm.abstract_params()),
                jopt_specs(jlm.param_specs()), jmesh)
            assert o == jo
        if shape.kind == "decode":
            n = shape.seq_len + 256
            c = estimate_state_bytes_per_device(
                lm.init_cache(shape.global_batch, n, abstract=True),
                lm.cache_specs(), mesh)
            jc = jdryrun.estimate_state_bytes_per_device(
                jlm.init_cache(shape.global_batch, n, abstract=True),
                jlm.cache_specs(), jmesh)
            assert c == jc


def test_h2o_danube_params_per_device_on_one_pod():
    """The pinned figure the card's dry-run phase prints."""
    from repro_torch.launch.dryrun import estimate_state_bytes_per_device
    mesh = AbstractMesh((16, 16), ("data", "model"))
    lm = build_lm(get_arch("h2o-danube-1.8b"), mesh, global_batch=256)
    assert estimate_state_bytes_per_device(
        lm.abstract_params(), lm.param_specs(), mesh) == 24_156_160


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_placements_round_trip(mesh_name):
    mesh, _ = _meshes(mesh_name)
    n = 0
    for arch in ARCH_IDS:
        lm = build_lm(get_arch(arch), mesh, global_batch=1)
        for tree in (lm.param_specs(), lm.cache_specs()):
            for spec in _leaves(tree):
                place = placements(spec, mesh)
                assert len(place) == len(mesh.shape)
                assert spec_of(place, mesh, len(spec)) == spec
                n += 1
    assert n > 100


def test_placements_shard_one_dim_over_two_axes_major_first():
    from torch.distributed.tensor import Replicate, Shard
    mesh = AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    assert placements(Spec(("pod", "data"), None, "model"), mesh) == (
        Shard(0), Shard(0), Shard(2))
    assert placements(Spec(), mesh) == (Replicate(),) * 3


@pytest.mark.parametrize("bad", [Spec(("data", "pod")), Spec("data", "data"),
                                 Spec("expert")])
def test_placements_reject_what_dtensor_cannot_lay_out(bad):
    mesh = AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    with pytest.raises(ValueError):
        placements(bad, mesh)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("gb", [1, 4, 256])
def test_make_rules_and_serving_overrides_equal_the_reference(mesh_name, gb):
    mesh, jmesh = _meshes(mesh_name)
    for kv, h in ((8, 32), (2, 4), (0, 0)):
        r = make_rules(mesh, global_batch=gb, num_kv_heads=kv, num_heads=h)
        jr = jmake_rules(jmesh, global_batch=gb, num_kv_heads=kv,
                         num_heads=h)
        assert tuple(r.spec(*Rules.__dataclass_fields__)) == \
            tuple(jr.spec(*Rules.__dataclass_fields__))
    for arch in ARCH_IDS:
        assert serving_weight_overrides(get_arch(arch), gb, mesh) == \
            jserving(jget_arch(arch), gb, jmesh)
    assert make_rules(None) == Rules(
        batch=None, heads=None, kv_seq=None, vocab=None, w_fsdp=None,
        w_tp=None, w_vocab_tp=None, expert_capacity=None, expert_in=None,
        expert_out=None)
