"""The port's training driver (``repro_torch.launch.train``, on the CPU):
the reference's system tests ``test_training_reduces_loss`` and
``test_resume_is_bitwise_identical`` on the port, the port's trainer
against the reference's on the same float32 init (losses step for step),
a checkpoint of either trainer resumed by the other, and the CLI.

Each test runs torch on one thread (``one_thread`` restores the count):
two trainers compared at rtol 1e-6 must sum in the same order, and the
tiny smoke model gains nothing from more. Every file lies under
``tmp_path``; ``Trainer.run`` joins its checkpoint writer before it
returns. Assertions read losses, never step seconds.

Tolerances: float32 losses of the two packages at rtol 1e-5 (two
frameworks' float32 sums through four AdamW steps); the port against
itself at rtol 1e-6, as the reference's resume test."""

import os
import shutil

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import load_checkpoint as jload_checkpoint
from repro.launch.train import Trainer as JTrainer
from repro.launch.train import TrainerConfig as JTrainerConfig
from repro.optim.adamw import OptimizerConfig as JOptimizerConfig
from repro_torch import convert
from repro_torch.launch import Trainer, TrainerConfig
from repro_torch.launch import train as train_mod
from repro_torch.models.params import leaves
from repro_torch.optim import OptimizerConfig

ARCH = "h2o-danube-1.8b"


@pytest.fixture(autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def _tc(steps, ckpt_dir=None, ckpt_every=50, **kw):
    return TrainerConfig(
        arch=ARCH, smoke=True, steps=steps, seed=0, batch_override=8,
        seq_override=64, ckpt_dir=ckpt_dir, ckpt_every=ckpt_every,
        log_every=1000, device="cpu",
        opt=OptimizerConfig(peak_lr=3e-3, warmup_steps=5, total_steps=200),
        **kw)


# ---------------------------------------------------------------------------
# The reference's tests/test_system.py, on the port
# ---------------------------------------------------------------------------

def test_training_reduces_loss():
    out = Trainer(_tc(steps=60)).run()
    first = np.mean(out["history"][:5])
    last = np.mean(out["history"][-5:])
    assert last < first - 0.1, (first, last)


def test_resume_is_bitwise_identical(tmp_path):
    ckpt = str(tmp_path / "ck")
    full = Trainer(_tc(steps=20, ckpt_dir=ckpt + "_a",
                       ckpt_every=100)).run()
    # run 10 steps, checkpoint, resume for 10 more
    Trainer(_tc(steps=10, ckpt_dir=ckpt, ckpt_every=10)).run()
    resumed = Trainer(_tc(steps=20, ckpt_dir=ckpt, ckpt_every=10)).run()
    assert len(resumed["history"]) == 10
    np.testing.assert_allclose(resumed["history"], full["history"][10:],
                               rtol=1e-6)


# ---------------------------------------------------------------------------
# Against the reference's trainer
# ---------------------------------------------------------------------------

STEPS = 4
OPT = dict(peak_lr=3e-3, warmup_steps=2, total_steps=20)


def _f32(cls, opt_cls, **kw):
    return cls(arch=ARCH, smoke=True, steps=STEPS, seed=0, batch_override=4,
               seq_override=32, log_every=1000,
               arch_overrides={"param_dtype": "float32"}, opt=opt_cls(**OPT),
               **kw)


def test_trainer_matches_reference_and_resumes_its_checkpoint(tmp_path):
    """On the reference's float32 init (converted), the port's four steps
    give the reference's losses. The reference's checkpoint of step 2
    resumes in the port to the same losses, and the port's checkpoint of
    step 4 loads in the reference, bit for bit the port's final
    parameters."""
    ck = str(tmp_path / "ck")
    jt = JTrainer(_f32(JTrainerConfig, JOptimizerConfig, ckpt_dir=ck,
                       ckpt_every=2))
    want = jt.run()["history"]
    jparams = jt.lm.init(jax.random.key(0))
    tparams = convert.lm_params(jax.tree.map(np.asarray, jparams), "cpu")
    got = Trainer(_f32(TrainerConfig, OptimizerConfig, device="cpu"),
                  params=tparams).run()
    np.testing.assert_allclose(got["history"], want, rtol=1e-5)

    shutil.rmtree(os.path.join(ck, f"step_{STEPS}"))
    resumed = Trainer(_f32(TrainerConfig, OptimizerConfig, device="cpu",
                           ckpt_dir=ck, ckpt_every=2)).run()
    assert len(resumed["history"]) == STEPS - 2
    np.testing.assert_allclose(resumed["history"], want[2:], rtol=1e-5)
    back = jload_checkpoint(ck, STEPS, {"params": jparams,
                                        "opt": jt.restore_or_init()[1]})
    for t, j in zip(leaves(resumed["params"]),
                    jax.tree.leaves(back["params"])):
        assert t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_train_step_reports_the_reference_metrics():
    """One step's metrics: the loss and its terms, the MoE aux losses
    (zero here), the global norm and the learning rate; every value
    finite and detached."""
    trainer = Trainer(_tc(steps=1))
    params, opt, _ = trainer.init_state()
    _, new_opt, m = trainer.step_fn(params, opt, trainer.batch_at(0))
    assert set(m) == {"loss", "ce_loss", "z_loss", "load_balance",
                      "router_z", "grad_norm", "lr"}
    assert all(torch.isfinite(v) and not v.requires_grad
               for v in m.values())
    assert int(new_opt["step"]) == 1
    assert float(m["loss"]) == pytest.approx(
        float(m["ce_loss"] + m["z_loss"]), rel=1e-6)


def test_cli_trains_on_the_cpu(tmp_path, capsys):
    train_mod.main(["--arch", ARCH, "--smoke", "--steps", "3", "--device",
                    "cpu", "--ckpt-dir", str(tmp_path), "--ckpt-every",
                    "2"])
    out = capsys.readouterr().out
    assert "[train] step=0 loss=" in out
    assert "[train] done: final_loss=" in out
    assert sorted(os.listdir(tmp_path)) == ["step_2"]


def test_trainer_runs_on_the_gpu_unless_asked():
    assert TrainerConfig().device == "cuda"
