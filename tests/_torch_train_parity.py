"""Trainer parity of the port against the reference for one family's
smoke config, shared by tests/test_torch_train_{moe,ssm,encoder,vlm}.py
(one file per family, so that xdist's ``--dist loadfile`` spreads them).

``check_trainer`` runs the reference's ``Trainer`` for STEPS float32
steps, then the port's ``Trainer`` from the reference's init (converted
leaf for leaf): the same losses at rtol 1e-5 (two frameworks' float32
sums through STEPS AdamW steps, as tests/test_torch_train.py holds the
dense family). The port then resumes its own checkpoint of step
CKPT_EVERY and repeats its later losses and final parameters bit for
bit. With ``across``, the reference's checkpoint of step CKPT_EVERY
resumes in the port to the reference's losses, and the port's checkpoint
of step STEPS loads in the reference bit for bit.

Torch runs on one thread (``one_thread``, which each file imports and
which restores the count), so a run and its resume sum in one order.
Every file lies under ``tmp_path``; ``Trainer.run`` joins its checkpoint
writer before it returns."""

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
from repro_torch.models.params import leaves
from repro_torch.optim import OptimizerConfig

STEPS, CKPT_EVERY = 4, 2
BATCH, SEQ = 4, 32
OPT = dict(peak_lr=3e-3, warmup_steps=2, total_steps=20)


@pytest.fixture(autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def _tc(cls, opt_cls, arch, **kw):
    return cls(arch=arch, smoke=True, steps=STEPS, seed=0,
               batch_override=BATCH, seq_override=SEQ, log_every=1000,
               arch_overrides={"param_dtype": "float32"},
               opt=opt_cls(**OPT), ckpt_every=CKPT_EVERY, **kw)


def _port(arch, **kw):
    return _tc(TrainerConfig, OptimizerConfig, arch, device="cpu", **kw)


def check_trainer(arch: str, tmp_path, across: bool = False) -> None:
    """The checks above for ``arch``."""
    ref_ck = str(tmp_path / "ref")
    jt = JTrainer(_tc(JTrainerConfig, JOptimizerConfig, arch,
                      ckpt_dir=ref_ck if across else None))
    want = jt.run()["history"]
    assert len(want) == STEPS and np.isfinite(want).all(), want
    jparams = jt.lm.init(jax.random.key(0))
    tparams = convert.lm_params(jax.tree.map(np.asarray, jparams), "cpu")

    own = str(tmp_path / "port")
    got = Trainer(_port(arch, ckpt_dir=own), params=tparams).run()
    np.testing.assert_allclose(got["history"], want, rtol=1e-5)

    shutil.rmtree(os.path.join(own, f"step_{STEPS}"))
    again = Trainer(_port(arch, ckpt_dir=own)).run()
    assert len(again["history"]) == STEPS - CKPT_EVERY
    np.testing.assert_array_equal(again["history"],
                                  got["history"][CKPT_EVERY:])
    for a, b in zip(leaves(again["params"]), leaves(got["params"])):
        assert torch.equal(a, b)

    if across:
        shutil.rmtree(os.path.join(ref_ck, f"step_{STEPS}"))
        resumed = Trainer(_port(arch, ckpt_dir=ref_ck)).run()
        assert len(resumed["history"]) == STEPS - CKPT_EVERY
        np.testing.assert_allclose(resumed["history"], want[CKPT_EVERY:],
                                   rtol=1e-5)
        back = jload_checkpoint(own, STEPS, {
            "params": jparams, "opt": jt.restore_or_init()[1]})
        for t, j in zip(leaves(again["params"]),
                        jax.tree.leaves(back["params"])):
            assert t.dtype == torch.float32
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
