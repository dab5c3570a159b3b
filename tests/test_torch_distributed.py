"""The port's distribution stack on gloo process groups (CPU, no
network): ``build_lm`` on a ``DeviceMesh``, DTensor parameters and moments
laid out by ``param_specs`` / ``opt_state_specs``, the kernels on each
rank's local shard, the trainer on a mesh, checkpoints restored onto
another mesh, prefill and decode with the KV cache written in place, and
``compressed_psum``.

The reference's own tests of this path (``tests/distribution/
test_sharded.py``) fail on jax 0.9.0 (ROADMAP C5), so the sharded port is
held to the port on one device, and that one to the reference elsewhere
(``test_torch_train.py``, ``test_torch_grads.py``). One spawn per mesh
carries all of that mesh's checks: a (4,2) group of 8 ranks, then a
(2,2) group of 4 that restores what the first saved; each test below
reads their results.
"""

import jax
import numpy as np
import pytest

from _torch_spawn import spawn
import _torch_dist_workers as W
from repro.checkpoint import save_checkpoint as jsave_checkpoint
from repro.configs import get_arch as jget_arch
from repro.launch.train import Trainer as JTrainer
from repro.launch.train import TrainerConfig as JTrainerConfig
from repro.models.lm import build_lm as jbuild_lm
from repro.optim.adamw import OptimizerConfig as JOptimizerConfig
from repro.optim.compress import compress_int8, decompress_int8

LOSS_REL = 1e-5      # the sharded step's loss against one device
LEAF_REL = 1e-4      # each leaf, of its largest value


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both spawns: (4,2) train and save, then (2,2) restore and serve."""
    tmp = tmp_path_factory.mktemp("dist")
    ckpt, ref = tmp / "ckpt", tmp / "ref"
    jlm = jbuild_lm(jget_arch(W.ARCH, smoke=True))
    jsave_checkpoint(str(ref), 0, {"params": jlm.init(jax.random.key(0))})
    jt = JTrainer(_jconfig())
    want = jt.run()["history"]
    init = jax.tree.map(np.asarray, jt.lm.init(jax.random.key(0)))
    train = spawn(W.train_step_4x2, 8, tmp / "pg42", str(ckpt), init)
    serve = spawn(W.serve_2x2, 4, tmp / "pg22", str(ckpt), str(ref))
    return {"train": train, "serve": serve, "reference_history": want}


def _jconfig():
    """The reference's trainer as the workers' ``trainer_config``."""
    return JTrainerConfig(arch=W.ARCH, smoke=True, steps=W.TRAIN_STEPS,
                          seed=0, batch_override=W.BATCH, seq_override=W.SEQ,
                          arch_overrides={"param_dtype": "float32"},
                          opt=JOptimizerConfig(warmup_steps=1))


def test_sharded_init_equals_one_device_bit_for_bit(runs):
    assert all(r["init_equal"] for r in runs["train"])


def test_sharded_train_step_matches_single_device(runs):
    r = runs["train"][0]
    assert abs(r["loss2"] - r["loss1"]) <= LOSS_REL * abs(r["loss1"])
    assert abs(r["gnorm2"] - r["gnorm1"]) <= LEAF_REL * r["gnorm1"]
    for name, err in r["errs"].items():
        assert err <= LEAF_REL, (name, err)


def test_every_rank_reports_the_same_loss(runs):
    assert len({r["loss2"] for r in runs["train"]}) == 1


def test_state_keeps_its_spec_layout(runs):
    assert all(r["layout"] for r in runs["train"])


def test_trainer_on_mesh_matches_the_reference_trainer(runs):
    """The trainer on the (4,2) mesh, from the reference's float32 init,
    gives the reference's single-device losses."""
    got = runs["train"][0]["history"]
    want = runs["reference_history"]
    assert len(got) == len(want) == W.TRAIN_STEPS
    np.testing.assert_allclose(got, want, rtol=LOSS_REL)


def test_rescale_plan_is_the_reference_planners(runs):
    assert runs["train"][0]["plan"] == (
        "mesh {'data': 4, 'model': 2} -> {'data': 4, 'model': 2}, "
        "grad_accum x1, dropped 0 devices")


def test_restore_onto_a_smaller_mesh_is_bit_for_bit(runs):
    for r in runs["serve"]:
        equal, laid = r["restore_4x2"]
        assert equal and laid


def test_reference_checkpoint_restores_onto_mesh_bit_for_bit(runs):
    for r in runs["serve"]:
        equal, laid = r["restore_ref"]
        assert equal and laid


def test_prefill_and_decode_on_mesh_equal_one_device(runs):
    r = runs["serve"][0]
    assert r["logits_err"] <= LEAF_REL
    assert r["cache_err"] <= LEAF_REL
    assert r["tokens_equal"]


def test_server_on_mesh_serves_the_single_device_tokens(runs):
    for r in runs["serve"]:
        got, want = r["server_tokens"]["mesh"], r["server_tokens"]["one"]
        assert got == want and got[1] == 2


def test_decode_writes_the_callers_cache_in_place(runs):
    """C4 under a mesh: the append writes into the DTensor shard that
    owns the slot, so the cache the caller holds has changed."""
    for r in runs["serve"]:
        assert r["cache_changed"]
        assert r["cache_kinds"] == ["DTensor"]


def test_decode_attention_gathers_the_sharded_kv(runs):
    """decode_attention over a cache split on ``kv_seq`` all-gathers it
    (DTensor's softmax over a sharded dim) rather than splitting the
    softmax: the step's collectives include all-gathers."""
    comm = runs["serve"][0]["decode_comm"]
    assert comm.get("all_gather_into_tensor", 0) > 0, comm


@pytest.mark.parametrize("mode", ["int8", "bf16", "f32"])
def test_compressed_psum_matches_reference_rank_by_rank(runs, mode):
    """Mesh (2,2), axis ``data``: ranks r and r ^ 2 sum together. The
    expectation applies the reference's ``compress_int8`` /
    ``decompress_int8`` to each rank's gradient plus residual."""
    for rank, r in enumerate(runs["serve"]):
        mean, resid = r["psum"][mode]
        peers = [rank, rank ^ 2]
        for key in ("a", "b"):
            parts, own = [], None
            for p in peers:
                g, res = W.psum_inputs(p)
                g32 = g[key] + res[key]
                if mode == "int8":
                    q, scale = compress_int8(g32)
                    d = np.asarray(decompress_int8(q, scale))
                    left = g32 - d
                elif mode == "bf16":
                    d = np.asarray(jax.numpy.asarray(g32).astype(
                        jax.numpy.bfloat16).astype(np.float32))
                    left = g32 - d
                else:
                    d, left = g32, np.zeros_like(g32)
                parts.append(d)
                if p == rank:
                    own = left
            want = (parts[0] + parts[1]) / 2
            tol = 2 ** -7 * np.abs(want).max() if mode == "bf16" else 1e-6
            np.testing.assert_allclose(mean[key], want, rtol=0, atol=tol)
            np.testing.assert_allclose(resid[key], own, rtol=0, atol=1e-7)


def test_init_residuals_are_zero(runs):
    z = runs["serve"][0]["psum"]["zero_residuals"]
    assert all(not v.any() and v.dtype == np.float32 for v in z.values())
