"""The port's ``Trainer`` on the mamba2-2.7b smoke config (the SSD
mixer's chunked scan under autograd, each layer checkpointed) against
the reference's trainer, float32, from the reference's init: the same
losses and a bit-for-bit resume (``_torch_train_parity.check_trainer``);
and the SSD's gradient where its decay overflows (ROADMAP C30)."""

import jax
import numpy as np
import torch

from _torch_train_parity import check_trainer, one_thread  # noqa: F401
from repro_torch import convert
from repro_torch.models.params import leaves


def test_trainer_matches_reference_and_resumes(tmp_path):
    check_trainer("mamba2-2.7b", tmp_path)


def test_ssd_gradient_is_finite_where_the_decay_overflows():
    """ROADMAP C30. At a full-width chunk (mamba2-2.7b's 256) the
    intra-chunk decay exp(cum_l - cum_m) overflows above the diagonal,
    which the mask then drops; the reference's gradient of that mask is
    0 times inf, NaN in every layer. The port masks the exponent first:
    its gradient at a chunk of 64 whose decay overflows (A = 16, dt =
    0.1: 102 nats a chunk) is finite, and equal within the gradient
    tests' 1e-4 to the reference's at a chunk of 16, where nothing
    overflows (the chunk changes only the order of float32 sums)."""
    import dataclasses

    import jax.numpy as jnp

    from repro.configs import get_arch as jget_arch
    from repro.configs.base import ShapeConfig as JShape
    from repro.data.synthetic import make_batch as jmake_batch
    from repro.models import build_lm as jbuild_lm
    from repro_torch.launch.train import loss_and_grads
    from repro_torch.models import build_lm as tbuild_lm

    from test_torch_grads import REL

    small = dataclasses.replace(jget_arch("mamba2-2.7b", smoke=True),
                                param_dtype="float32")
    wide = dataclasses.replace(small, ssm=dataclasses.replace(
        small.ssm, chunk=64))
    jparams = jbuild_lm(small).init(jax.random.key(0))
    mamba = jparams["layers"]["pos0"]["mamba"]
    dt = 0.1
    mamba["a_log"] = jnp.full_like(mamba["a_log"], np.log(16.0))
    mamba["dt_bias"] = jnp.full_like(mamba["dt_bias"],
                                     dt + np.log(-np.expm1(-dt)))
    batch = jmake_batch(small, JShape("t", 64, 2, "train"), step=0, seed=0)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def jgrads(cfg):
        return jax.jit(jax.grad(lambda p, b: jbuild_lm(cfg).loss(p, b)[0]))(
            jparams, jbatch)

    overflowed = jgrads(wide)
    assert not all(np.isfinite(np.asarray(g)).all()
                   for g in jax.tree.leaves(overflowed))
    want = jax.tree.leaves(jgrads(small))
    tcfg = convert.arch_config_from_dict(dataclasses.asdict(wide))
    _, _, tgrads = loss_and_grads(
        tbuild_lm(tcfg, device="cpu"),
        convert.lm_params(jax.tree.map(np.asarray, jparams), "cpu"),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    assert len(want) == len(leaves(tgrads))
    for w, t in zip(want, leaves(tgrads)):
        w, t = np.asarray(w), t.numpy()
        assert np.isfinite(w).all() and np.isfinite(t).all()
        assert np.abs(t - w).max() <= REL * np.abs(w).max()
