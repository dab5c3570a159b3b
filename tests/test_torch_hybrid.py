"""Port parity for the hybrid family: jamba-v0.1-52b's period-8 layer walk
(attention at position 4, Mamba elsewhere, MoE at the odd positions) in
``repro_torch.models.lm``, on the CPU, against the JAX package's, with the
reference's params converted leaf for leaf. The smoke config has 8 layers
(one group of the period); the 16-layer copy has two groups, so that a
cache or parameter leaf indexed by layer instead of by group shows.

Tolerances: float32 max |diff| under 1e-5 of the reference's largest
magnitude (two frameworks' float32 products in another summation order);
the losses and their aux terms at rtol 1e-5; int8 KV at the reference's
own 5% bound for int8 against full precision. MoE layers run at capacity
factor 8.0, as in tests/test_torch_models.py, so that no float32
difference can move a drop. In bf16 the router's products can tie within
an ulp and swap a token's experts (ROADMAP C18), so bf16 is held as C19
holds it, in tests/test_torch_bf16_witness.py: each package's decode
step against its own cache-free forward, the port's no further than
twice the reference's plus 1e-3."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import build_lm as jbuild_lm
from repro_torch import convert
from repro_torch.models import build_lm as tbuild_lm
from test_torch_models import _cache_leaves, _cfgs, _rel, _run

ARCH = "jamba_v0p1_52b"
LAYERS = [8, 16]
REL = 1e-5
PERIOD = 8


def _reps(layers, **kw):
    return dict(param_dtype="float32", num_layers=layers, **kw)


@pytest.mark.parametrize("layers", LAYERS)
def test_forward_matches_reference(layers):
    want, got = _run(ARCH, **_reps(layers))["forward"]
    assert got.shape == want.shape
    assert _rel(got, want) < REL


@pytest.mark.parametrize("layers", LAYERS)
def test_prefill_matches_reference(layers):
    jl, tl, jc, tc, jcur, tcur = _run(ARCH, **_reps(layers))["prefill"]
    assert tcur == jcur
    assert _rel(tl, jl) < REL
    assert len(tc) == len(jc) == 7 * 4 + 2     # Mamba x 4, attn K and V
    for t, j in zip(tc, jc):
        assert t.shape == j.shape and t.shape[0] == layers // PERIOD
        assert _rel(t, j) < REL


@pytest.mark.parametrize("layers", LAYERS)
def test_decode_steps_match_reference(layers):
    res = _run(ARCH, **_reps(layers))
    for t, (jl, tl) in enumerate(res["decode"]):
        assert _rel(tl, jl) < REL, f"step {t}"
    jc, tc = res["cache"]
    assert list(tc) == list(jc) == [f"pos{p}" for p in range(PERIOD)]
    for t, j in zip(_cache_leaves(tc), _cache_leaves(jc)):
        assert _rel(t, j) < REL


@pytest.mark.parametrize("kv_dtype", ["param", "int8"])
@pytest.mark.parametrize("layers", LAYERS)
def test_init_cache_layout_per_position(layers, kv_dtype):
    """One entry per period position: an attention cache at position 4
    (int8 with its scales when configured) and a Mamba cache at the
    others, every leaf led by the group axis (layers // 8), with the
    reference's shapes and dtypes."""
    jcfg, tcfg = _cfgs(ARCH, num_layers=layers, kv_cache_dtype=kv_dtype)
    want = jbuild_lm(jcfg).init_cache(3, 20)
    got = tbuild_lm(tcfg, device="cpu").init_cache(3, 20)
    assert list(got) == [f"pos{p}" for p in range(PERIOD)]
    for pos, entry in got.items():
        assert list(entry) == (["attn"] if pos == "pos4" else ["mamba"])
        assert entry.keys() == want[pos].keys()
        kind = next(iter(entry))
        assert type(entry[kind]).__name__ == type(want[pos][kind]).__name__
        for t, j in zip(entry[kind], want[pos][kind]):
            assert t.shape == j.shape and t.shape[0] == layers // PERIOD
            assert str(t.dtype).endswith(str(j.dtype))
            assert not t.any()


@pytest.mark.parametrize("layers", LAYERS)
def test_loss_with_aux_matches_reference(layers):
    """CE, z-loss and the MoE positions' aux losses, summed over both
    groups, with a loss mask and padded vocab columns."""
    jcfg, tcfg = _cfgs(ARCH, **_reps(layers, vocab_size=250))
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
    np.testing.assert_allclose(float(got), float(want), rtol=REL)
    assert set(gm) == set(wm)
    for k in wm:
        np.testing.assert_allclose(float(gm[k]), float(wm[k]), rtol=REL,
                                   atol=1e-7, err_msg=k)
    assert float(gm["load_balance"]) > 0 and float(gm["router_z"]) > 0
    aux = 1e-2 * float(gm["load_balance"]) + float(gm["router_z"])
    np.testing.assert_allclose(
        float(got), float(gm["ce_loss"] + gm["z_loss"]) + aux, rtol=1e-6)


def test_int8_kv_at_the_attention_position():
    """int8 storage at position 4 only: the Mamba positions keep their
    float32 state; the first decode step within the reference's int8
    bound of the cache-free model and of the reference's int8 decode."""
    res = _run(ARCH, **_reps(16, kv_cache_dtype="int8"))
    jc, tc = res["cache"]
    assert [type(e).__name__ for c in tc.values() for e in c.values()] == \
        ["MambaCache"] * 4 + ["QuantAttnCache"] + ["MambaCache"] * 3
    for t, j in zip(_cache_leaves(tc), _cache_leaves(jc)):
        assert t.shape == j.shape and str(t.dtype).endswith(str(j.dtype))
    assert str(tc["pos4"]["attn"].k.dtype) == "torch.int8"
    jl, tl = res["decode"][0]
    assert _rel(tl, res["full_next"]) < 0.05
    assert _rel(tl, jl) < 0.05
