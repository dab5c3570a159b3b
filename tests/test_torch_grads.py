"""Gradient parity of the port's ``LM.loss`` (``repro_torch.models.lm``,
on the CPU, kernels on: the embedding lookup through ``EmbedLookup``,
attention through ``FlashAttention``, each layer checkpointed by
``cfg.remat``) against ``jax.grad`` of the reference's ``loss``, from the
reference's float32 init converted leaf for leaf, on ``make_batch``'s
inputs: the dense family here; the MoE, SSM, hybrid and frontend
families in tests/test_torch_grads_{moe,ssm,hybrid,frontends}.py, which
import ``check_grads`` (one file per family group, so that xdist's
``--dist loadfile`` spreads their cost).

Every leaf's gradient within 1e-4 of the largest magnitude of the
reference's gradient of that leaf (two frameworks' float32 products and
sums in another order, through the backward of a few layers), and the
loss at rtol 1e-5. Float32 only: in bf16 a router's products can tie
within an ulp and swap a token's experts (ROADMAP C18). MoE configs at
capacity factor 8.0, as tests/test_torch_models.py runs them, so that a
float32 difference cannot move a drop."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.configs.base import ShapeConfig as JShape
from repro.data.synthetic import make_batch as jmake_batch
from repro.models import build_lm as jbuild_lm
from repro_torch import convert
from repro_torch.launch.train import loss_and_grads
from repro_torch.models import build_lm as tbuild_lm
from repro_torch.models.params import leaves

REL = 1e-4
B, S = 2, 16
DENSE = ["yi_34b", "granite_34b", "h2o_danube_1p8b", "internlm2_20b"]


def check_grads(arch, **reps):
    """Both packages' loss and gradients at the reference's float32 init
    of ``arch``'s smoke config (``reps`` replaced), held to ``REL``.
    Returns the worst leaf's relative difference."""
    jcfg = dataclasses.replace(jget_arch(arch, smoke=True),
                               param_dtype="float32", **reps)
    if jcfg.moe is not None:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, capacity_factor=8.0))
    tcfg = convert.arch_config_from_dict(dataclasses.asdict(jcfg))
    assert tcfg.use_kernels
    jlm, tlm = jbuild_lm(jcfg), tbuild_lm(tcfg, device="cpu")
    jparams = jlm.init(jax.random.key(0))
    tparams = convert.lm_params(jax.tree.map(np.asarray, jparams), "cpu")
    batch = jmake_batch(jcfg, JShape("t", S, B, "train"), step=0, seed=0)
    (want, _), jgrads = jax.jit(jax.value_and_grad(jlm.loss, has_aux=True))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    got, _, tgrads = loss_and_grads(tlm, tparams, {
        k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    flat, _ = jax.tree.flatten_with_path(jgrads)
    assert len(flat) == len(leaves(tgrads))
    worst = 0.0
    for (path, j), t in zip(flat, leaves(tgrads)):
        j = np.asarray(j)
        assert t.dtype == torch.float32 and t.shape == j.shape, path
        t = t.numpy()
        assert np.isfinite(t).all(), path
        top = np.abs(j).max()
        err = np.abs(t - j).max()
        if top == 0:
            assert err == 0, jax.tree_util.keystr(path)
            continue
        assert err <= REL * top, (jax.tree_util.keystr(path), err, top)
        worst = max(worst, err / top)
    return worst


@pytest.mark.parametrize("arch", DENSE)
def test_loss_grads_match_reference(arch):
    check_grads(arch)


def test_loss_chunks_and_remat_policies_keep_the_grads():
    """``loss_chunks`` (each chunk checkpointed), ``remat_policy="dots"``
    and no remat change memory, not values."""
    check_grads("h2o_danube_1p8b", loss_chunks=4, remat_policy="dots")
    check_grads("h2o_danube_1p8b", remat=False)
