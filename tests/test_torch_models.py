"""Port parity for the model stack: configs, parameter declarations, the
parameter carry, and the LM's ``forward``, ``loss``, ``prefill``,
``decode_step`` and ``init_cache`` (``repro_torch.models``, on the CPU)
for the dense, MoE and SSM families against the JAX package's (the
hybrid, audio and vision families in tests/test_torch_hybrid.py and
tests/test_torch_frontends.py), with the
reference's params converted leaf for leaf. MoE configs run at capacity
factor 8.0, as the reference's consistency tests do (``_f32`` in
tests/models/test_consistency.py), so that a float32 difference cannot
move a drop.

Tolerances: float32 rtol = atol = 1e-4 (two frameworks' float32 matmuls
and softmaxes in another summation order, through a few layers); int8 KV
at the reference's own bound for int8 against full precision (5%
relative, tests/models/test_kv_quantization.py); bf16 logits within 5e-2
relative to their largest magnitude."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS, get_arch as jget_arch
from repro.models import build_lm as jbuild_lm
from repro.models.params import model_decls as jmodel_decls
from repro.models.params import param_count_tree as jparam_count_tree
from repro_torch import convert
from repro_torch.configs import get_arch as tget_arch
from repro_torch.models import build_lm as tbuild_lm
from repro_torch.models.params import (ParamDecl, init_params, leaves,
                                       model_decls, param_count_tree)

DENSE = ["yi_34b", "granite_34b", "h2o_danube_1p8b", "internlm2_20b"]
MOE = ["mixtral_8x7b", "qwen2_moe_a2p7b"]
SSM = ["mamba2_2p7b"]
PORTED = DENSE + MOE + SSM
OTHER = [a for a in ARCH_IDS if a not in PORTED]
B, S, STEPS = 2, 12, 6       # h2o-danube's smoke window is 8: decode past it


def _cfgs(arch, **reps):
    ref = jget_arch(arch, smoke=True)
    if ref.moe is not None:
        ref = dataclasses.replace(
            ref, moe=dataclasses.replace(ref.moe, capacity_factor=8.0))
    ref = dataclasses.replace(ref, **reps)
    return ref, convert.arch_config_from_dict(dataclasses.asdict(ref))


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


def _rel(got, want):
    got, want = _np(got), _np(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


_RUNS = {}


def _run(arch, **reps):
    """Both packages' forward, prefill and STEPS decode steps on one
    reference init (cached per configuration)."""
    key = (arch, tuple(sorted(reps.items())))
    if key in _RUNS:
        return _RUNS[key]
    jcfg, tcfg = _cfgs(arch, **reps)
    jlm, tlm = jbuild_lm(jcfg), tbuild_lm(tcfg, device="cpu")
    jparams = jlm.init(jax.random.key(0))
    tparams = convert.lm_params(jax.tree.map(np.asarray, jparams), "cpu")
    rng = np.random.default_rng(0)
    toks = rng.integers(0, jcfg.vocab_size, (B, S + STEPS)).astype(np.int32)
    full = {"tokens": jnp.asarray(toks[:, :S])}
    res = {"forward": (jax.jit(jlm.forward)(jparams, full)[0],
                       tlm.forward(tparams, {"tokens": torch.from_numpy(
                           toks[:, :S])})[0])}
    max_len = S + STEPS + 8
    jl, jc, jcur = jax.jit(jlm.prefill, static_argnums=2)(jparams, full,
                                                          max_len)
    tl, tc, tcur = tlm.prefill(tparams, {"tokens": torch.from_numpy(
        toks[:, :S])}, max_len)
    # decode_step appends to the port's cache in place: keep a copy
    res["prefill"] = (jl, tl, _cache_leaves(jc),
                      [t.clone() for t in _cache_leaves(tc)], int(jcur), tcur)
    jdec = jax.jit(jlm.decode_step)
    steps = []
    for t in range(STEPS):
        jl, jc = jdec(jparams, jnp.asarray(toks[:, S + t]), jc, jcur)
        tl, tc = tlm.decode_step(tparams, torch.from_numpy(toks[:, S + t]),
                                 tc, tcur)
        jcur, tcur = jcur + 1, tcur + 1
        steps.append((jl, tl))
    res["decode"] = steps
    res["cache"] = (jc, tc)
    # The cache-free model on the whole prefix, for the int8 bound.
    last = {"tokens": jnp.asarray(toks[:, :S + 1])}
    res["full_next"] = jax.jit(jlm.forward)(jparams, last)[0][
        :, -1, :jcfg.vocab_size]
    _RUNS[key] = res
    return res


def _cache_leaves(cache):
    """Every leaf of a serve cache: the K/V (and scales) or the Mamba
    state of each period position, in order."""
    return [x for c in cache.values() for entry in c.values() for x in entry]


# ---------------------------------------------------------------------------
# Configs and declarations
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_counts_match_reference(arch, smoke):
    jcfg, tcfg = jget_arch(arch, smoke=smoke), tget_arch(arch, smoke=smoke)
    assert tcfg.param_count() == jcfg.param_count()
    assert tcfg.active_param_count() == jcfg.active_param_count()
    assert param_count_tree(tcfg) == jparam_count_tree(jcfg)
    assert (tcfg.padded_vocab, tcfg.scan_period) == \
        (jcfg.padded_vocab, jcfg.scan_period)
    assert [tcfg.layer_kinds(l) for l in range(tcfg.num_layers)] == \
        [jcfg.layer_kinds(l) for l in range(jcfg.num_layers)]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_config_and_decl_tree_match_reference(arch):
    """The registry's config equals the reference's carried through
    ``arch_config_from_dict``, and the declaration trees are congruent:
    same paths, shapes, axes, initializers and fan-ins, in the same
    leaf order."""
    jcfg = jget_arch(arch)
    assert convert.arch_config_from_dict(dataclasses.asdict(jcfg)) == \
        tget_arch(arch)
    assert tget_arch(arch).use_kernels and not jcfg.use_pallas
    jl, _ = jax.tree.flatten_with_path(
        jmodel_decls(jcfg), is_leaf=lambda x: hasattr(x, "logical"))
    tl = leaves(model_decls(tget_arch(arch)))
    assert len(jl) == len(tl)
    for (path, jd), td in zip(jl, tl):
        assert isinstance(td, ParamDecl)
        assert dataclasses.astuple(td) == dataclasses.astuple(jd), path


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_lm_params_carry_a_reference_init_bit_for_bit(dtype):
    jcfg, tcfg = _cfgs("yi_34b", param_dtype=dtype)
    jparams = jbuild_lm(jcfg).init(jax.random.key(3))
    tparams = convert.lm_params(jax.tree.map(np.asarray, jparams), "cpu")
    jleaves = jax.tree.leaves(jparams)
    tleaves = leaves(tparams)
    assert len(jleaves) == len(tleaves)
    for j, t in zip(jleaves, tleaves):
        assert t.dtype == getattr(torch, dtype) and t.shape == j.shape
        np.testing.assert_array_equal(_np(t), _np(j))


def test_init_params_draws_each_leaf_at_its_scale():
    cfg = tget_arch("h2o_danube_1p8b", smoke=True)
    gen = torch.Generator().manual_seed(0)
    params = init_params(cfg, gen, "cpu")
    again = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    for a, b in zip(leaves(params), leaves(again)):
        assert torch.equal(a, b)
    assert params["embed"]["table"].dtype == torch.bfloat16
    w = params["layers"]["pos0"]["mlp"]["w_gate"].float()
    assert w.shape == (2, 64, 128)
    assert abs(float(w.std()) * 64 ** 0.5 - 1) < 0.1
    assert torch.equal(params["final_norm"], torch.ones(64,
                                                        dtype=torch.bfloat16))
    # ssm leaves (another family's decls) stay float32
    m = init_params(tget_arch("mamba2_2p7b", smoke=True),
                    torch.Generator().manual_seed(0), "cpu")
    assert m["layers"]["pos0"]["mamba"]["a_log"].dtype == torch.float32


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("arch", MOE + SSM)
def test_moe_and_ssm_params_carry_bit_for_bit(arch, dtype):
    """The router, expert, shared-expert and Mamba leaves keep their
    bits and dtypes; ``a_log`` and ``dt_bias`` stay float32."""
    jcfg, tcfg = _cfgs(arch, param_dtype=dtype)
    jparams = jbuild_lm(jcfg).init(jax.random.key(3))
    tparams = convert.lm_params(jax.tree.map(np.asarray, jparams), "cpu")
    jl, _ = jax.tree.flatten_with_path(jparams)
    tleaves = leaves(tparams)
    assert len(jl) == len(tleaves)
    for (path, j), t in zip(jl, tleaves):
        assert str(t.dtype).endswith(str(j.dtype)), path
        assert t.shape == j.shape, path
        np.testing.assert_array_equal(_np(t), _np(j))
    if arch in SSM:
        m = tparams["layers"]["pos0"]["mamba"]
        assert m["a_log"].dtype == m["dt_bias"].dtype == torch.float32


# ---------------------------------------------------------------------------
# The LM against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", PORTED)
def test_forward_matches_reference(arch):
    want, got = _run(arch, param_dtype="float32")["forward"]
    assert got.shape == want.shape
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", PORTED)
def test_prefill_matches_reference(arch):
    jl, tl, jc, tc, jcur, tcur = _run(arch, param_dtype="float32")["prefill"]
    assert tcur == jcur == S
    np.testing.assert_allclose(_np(tl), _np(jl), rtol=1e-4, atol=1e-4)
    assert len(tc) == len(jc)
    for t, j in zip(tc, jc):
        assert t.shape == j.shape
        np.testing.assert_allclose(_np(t), _np(j), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", PORTED)
def test_decode_steps_match_reference(arch):
    res = _run(arch, param_dtype="float32")
    for t, (jl, tl) in enumerate(res["decode"]):
        np.testing.assert_allclose(_np(tl), _np(jl), rtol=1e-4, atol=1e-4,
                                   err_msg=f"step {t}")
    jc, tc = res["cache"]
    assert tc.keys() == jc.keys()
    for t, j in zip(_cache_leaves(tc), _cache_leaves(jc)):
        np.testing.assert_allclose(_np(t), _np(j), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", DENSE + MOE)
def test_int8_kv_cache_decode(arch):
    """int8 storage: every cache leaf has the reference's dtype and shape,
    the first decode step is within the reference's own int8 bound of the
    cache-free model, and within that bound of the reference's int8
    decode."""
    res = _run(arch, param_dtype="float32", kv_cache_dtype="int8")
    jc, tc = res["cache"]
    for t, j in zip(_cache_leaves(tc), _cache_leaves(jc)):
        assert t.shape == j.shape and str(t.dtype).endswith(str(j.dtype))
    jl, tl = res["decode"][0]
    assert _rel(tl, res["full_next"]) < 0.05
    assert _rel(tl, jl) < 0.05


@pytest.mark.parametrize("arch", DENSE + SSM)
def test_bf16_logits_match_reference(arch):
    """bf16 params end to end. Not for MoE: bf16 router logits of two
    frameworks can differ by one ulp, which swaps a token's experts and
    moves its output by tens of percent (mixtral's smoke decode reads
    0.31); the routing is held exactly in float32 instead."""
    res = _run(arch)
    assert _rel(*res["forward"][::-1]) < 5e-2
    jl, tl, *_ = res["prefill"]
    assert _rel(tl, jl) < 5e-2
    for jl, tl in res["decode"]:
        assert _rel(tl, jl) < 5e-2


@pytest.mark.parametrize("kv_dtype", ["param", "int8"])
@pytest.mark.parametrize("arch", ["yi_34b", "h2o_danube_1p8b",
                                  "qwen2_moe_a2p7b", "mamba2_2p7b"])
def test_init_cache_matches_reference(arch, kv_dtype):
    """Zero serve caches of the same leaves, shapes and dtypes (the SWA
    window caps the length; a Mamba cache holds the conv taps in the
    parameter dtype and the SSD state in float32, whatever the KV
    dtype)."""
    jcfg, tcfg = _cfgs(arch, kv_cache_dtype=kv_dtype)
    want = jbuild_lm(jcfg).init_cache(3, 20)
    got = tbuild_lm(tcfg, device="cpu").init_cache(3, 20)
    assert got.keys() == want.keys()
    assert {k: v.keys() for k, v in got.items()} == \
        {k: v.keys() for k, v in want.items()}
    assert len(_cache_leaves(got)) == len(_cache_leaves(want))
    for t, j in zip(_cache_leaves(got), _cache_leaves(want)):
        assert t.shape == j.shape and str(t.dtype).endswith(str(j.dtype))
        assert not t.any()


@pytest.mark.parametrize("vocab", [256, 250])
def test_loss_matches_reference(vocab):
    """Forward + CE + z-loss, with and without padded vocab columns and a
    loss mask, and chunked."""
    jcfg, tcfg = _cfgs("internlm2_20b", param_dtype="float32",
                       vocab_size=vocab)
    jlm, tlm = jbuild_lm(jcfg), tbuild_lm(tcfg, device="cpu")
    jparams = jlm.init(jax.random.key(1))
    tparams = convert.lm_params(jax.tree.map(np.asarray, jparams), "cpu")
    rng = np.random.default_rng(1)
    toks = rng.integers(0, vocab, (2, 16)).astype(np.int32)
    labels = rng.integers(0, vocab, (2, 16)).astype(np.int32)
    mask = (rng.random((2, 16)) < 0.7).astype(np.float32)
    batch = dict(tokens=toks, labels=labels, loss_mask=mask)
    want, wm = jlm.loss(jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    for chunks in (None, 3):
        t = tbuild_lm(dataclasses.replace(tcfg, loss_chunks=chunks),
                      device="cpu")
        got, gm = t.loss(tparams, {k: torch.from_numpy(v)
                                   for k, v in batch.items()})
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
        np.testing.assert_allclose(float(gm["ce_loss"]), float(wm["ce_loss"]),
                                   rtol=1e-5)
        assert set(gm) == set(wm)


@pytest.mark.parametrize("arch", MOE + SSM)
def test_loss_with_aux_matches_reference(arch):
    """Forward + CE + z-loss + the MoE aux losses (``1e-2 *
    load_balance + router_z``; zero for Mamba), every metric, with a loss
    mask and padded vocab columns."""
    jcfg, tcfg = _cfgs(arch, param_dtype="float32", vocab_size=250)
    jlm, tlm = jbuild_lm(jcfg), tbuild_lm(tcfg, device="cpu")
    jparams = jlm.init(jax.random.key(1))
    tparams = convert.lm_params(jax.tree.map(np.asarray, jparams), "cpu")
    rng = np.random.default_rng(1)
    toks = rng.integers(0, 250, (2, 16)).astype(np.int32)
    labels = rng.integers(0, 250, (2, 16)).astype(np.int32)
    mask = (rng.random((2, 16)) < 0.7).astype(np.float32)
    batch = dict(tokens=toks, labels=labels, loss_mask=mask)
    want, wm = jlm.loss(jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    got, gm = tlm.loss(tparams, {k: torch.from_numpy(v)
                                 for k, v in batch.items()})
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    assert set(gm) == set(wm)
    for k in wm:
        np.testing.assert_allclose(float(gm[k]), float(wm[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    if arch in MOE:
        assert float(gm["load_balance"]) > 0 and float(gm["router_z"]) > 0
    else:
        assert float(gm["load_balance"]) == float(gm["router_z"]) == 0


def test_embedding_grad_update_matches_reference():
    jcfg, tcfg = _cfgs("yi_34b", param_dtype="float32")
    jlm, tlm = jbuild_lm(jcfg), tbuild_lm(tcfg, device="cpu")
    jparams = jlm.init(jax.random.key(2))
    tparams = convert.lm_params(jax.tree.map(np.asarray, jparams), "cpu")
    rng = np.random.default_rng(2)
    toks = rng.integers(0, 20, (2, 16)).astype(np.int32)
    grads = rng.standard_normal((2, 16, jcfg.d_model)).astype(np.float32)
    want = jlm.embedding_grad_update(jparams, jnp.asarray(toks),
                                     jnp.asarray(grads), lr=0.1)
    got = tlm.embedding_grad_update(tparams, torch.from_numpy(toks),
                                    torch.from_numpy(grads), lr=0.1)
    np.testing.assert_allclose(_np(got["embed"]["table"]),
                               _np(want["embed"]["table"]), rtol=1e-5,
                               atol=1e-5)
    assert got["lm_head"] is tparams["lm_head"]


@pytest.mark.parametrize("arch", OTHER)
def test_other_families_raise_not_implemented(arch):
    """The hybrid, audio and vision architectures build like the others
    (their parity is in tests/test_torch_hybrid.py and
    tests/test_torch_frontends.py); what still raises for them is what
    raises for every family: a device mesh and expert parallelism."""
    cfg = tget_arch(arch, smoke=True)
    assert tbuild_lm(cfg, device="cpu").cfg is cfg
    with pytest.raises(NotImplementedError, match="A9"):
        tbuild_lm(cfg, mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="A9"):
        tbuild_lm(cfg, moe_strategy="ep", device="cpu")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_build_lm_takes_every_registry_architecture(arch):
    """Every registry id builds, and its smoke config's forward and loss
    run on ``make_batch``'s batch: logits of (B, S, padded vocab) in the
    reference's dtype for that input (float32 for the audio frames),
    finite, and a finite loss."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.synthetic import make_batch
    cfg = tget_arch(arch, smoke=True)
    lm = tbuild_lm(cfg, device="cpu")
    params = lm.init(torch.Generator().manual_seed(0))
    batch = {k: torch.from_numpy(v) for k, v in make_batch(
        cfg, ShapeConfig("s", 16, 2, "train"), step=0).items()}
    logits, aux = lm.forward(params, batch)
    assert logits.shape == (2, 16, cfg.padded_vocab)
    assert logits.dtype == (torch.float32 if cfg.modality == "audio"
                            else torch.bfloat16)
    assert bool(torch.isfinite(logits.float()).all())
    loss, metrics = lm.loss(params, batch)
    assert bool(torch.isfinite(loss)) and set(aux) <= set(metrics)


@pytest.mark.parametrize("what", ["mesh", "ep"])
def test_mesh_and_expert_parallel_raise_not_implemented(what):
    cfg = tget_arch("yi_34b", smoke=True)
    with pytest.raises(NotImplementedError, match="A9"):
        if what == "mesh":
            tbuild_lm(cfg, mesh=object(), device="cpu")
        else:
            tbuild_lm(cfg, moe_strategy="ep", device="cpu")
