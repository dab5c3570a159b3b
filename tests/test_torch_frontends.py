"""Port parity for the audio and vision frontends: hubert-xlarge (an
encoder over precomputed frames) and internvl2-76b (patches projected
ahead of the text tokens), their smoke configs in
``repro_torch.models.lm`` on the CPU against the JAX package's, on
``make_batch``'s inputs and the reference's params converted leaf for
leaf.

``jnp`` promotes a float32 x bf16 product to float32, and torch's
``matmul`` of mixed dtypes raises, so the port multiplies through
``layers.mm``, which promotes as ``jnp.promote_types`` does: hubert's
float32 frames keep its residual stream and logits float32 on bf16
weights (so its bf16 run is held at the float32 bound), and internvl2's
projected patches are cast to the text dtype.

Tolerances: float32 max |diff| under 1e-5 of the reference's largest
magnitude; losses at rtol 1e-5; internvl2's bf16 logits within 5e-2 of
the largest magnitude, as tests/test_torch_models.py holds the dense
family's."""

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
from repro_torch.models import build_lm as tbuild_lm
from repro_torch.models import layers
from test_torch_models import _cache_leaves, _rel

REL = 1e-5
ARCHS = ["hubert_xlarge", "internvl2_76b"]
B, STEPS = 2, 6


def _setup(arch, dtype, seq=24):
    """Both packages' LMs and params, and one ``make_batch`` batch as jnp
    and torch dicts (``seq`` positions: for internvl2 its 8 patches and
    ``seq - 8`` text tokens)."""
    jcfg = dataclasses.replace(jget_arch(arch, smoke=True),
                               param_dtype=dtype)
    tcfg = convert.arch_config_from_dict(dataclasses.asdict(jcfg))
    jlm, tlm = jbuild_lm(jcfg), tbuild_lm(tcfg, device="cpu")
    jparams = jlm.init(jax.random.key(0))
    tparams = convert.lm_params(jax.tree.map(np.asarray, jparams), "cpu")
    batch = jmake_batch(jcfg, JShape("t", seq, B, "train"), step=0, seed=0)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    return jlm, jparams, tlm, tparams, jb, tb


@pytest.mark.parametrize("a,b", [("float32", "bfloat16"),
                                 ("bfloat16", "float32"),
                                 ("bfloat16", "bfloat16"),
                                 ("float16", "bfloat16"),
                                 ("float32", "float16"),
                                 ("float32", "float32")])
def test_mm_promotes_as_jnp(a, b):
    x = torch.ones(2, 3, dtype=getattr(torch, a))
    w = torch.ones(3, 4, dtype=getattr(torch, b))
    got = layers.mm(x, w)
    want = jnp.ones((2, 3), a) @ jnp.ones((3, 4), b)
    assert str(got.dtype).endswith(str(jnp.promote_types(a, b)))
    assert str(got.dtype).endswith(str(want.dtype))
    assert bool((got == 3).all())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_embed_inputs_match_reference(arch, dtype):
    """x in the reference's dtype (hubert float32 whatever the weights,
    internvl2 the weights'), within 1e-5; the loss mask equal (zeros over
    internvl2's patch prefix), also with a left-padded ``loss_mask``."""
    jlm, jparams, tlm, tparams, jb, tb = _setup(arch, dtype)
    mask = (np.random.default_rng(0).random(jb["labels"].shape)
            < 0.7).astype(np.float32)
    jb["loss_mask"], tb["loss_mask"] = jnp.asarray(mask), torch.from_numpy(
        mask)
    jx, jm = jlm._embed_inputs(jparams, jb)
    tx, tm = tlm._embed_inputs(tparams, tb)
    assert str(tx.dtype).endswith(str(jx.dtype))
    if arch == "hubert_xlarge":
        assert tx.dtype == torch.float32
    else:
        assert str(tx.dtype).endswith(dtype)
    assert tx.shape == jx.shape
    assert _rel(tx, jx) < (REL if tx.dtype == torch.float32 else 1e-2)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    if arch == "internvl2_76b":
        assert not tm[:, :8].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch, dtype):
    jlm, jparams, tlm, tparams, jb, tb = _setup(arch, dtype)
    want = jax.jit(jlm.forward)(jparams, jb)[0]
    got = tlm.forward(tparams, tb)[0]
    assert got.shape == want.shape
    assert str(got.dtype).endswith(str(want.dtype))
    if got.dtype == torch.float32:          # hubert in bf16 too
        assert _rel(got, want) < REL
    else:
        assert _rel(got, want) < 5e-2


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_matches_reference(arch):
    """CE over ``_full_labels`` (labels left-padded over the patch
    prefix), masked by the frontend's mask and a left-padded
    ``loss_mask``; every metric."""
    jlm, jparams, tlm, tparams, jb, tb = _setup(arch, "float32")
    mask = (np.random.default_rng(1).random(jb["labels"].shape)
            < 0.7).astype(np.float32)
    jb["loss_mask"], tb["loss_mask"] = jnp.asarray(mask), torch.from_numpy(
        mask)
    want, wm = jax.jit(jlm.loss)(jparams, jb)
    got, gm = tlm.loss(tparams, tb)
    np.testing.assert_allclose(float(got), float(want), rtol=REL)
    assert set(gm) == set(wm)
    for k in wm:
        np.testing.assert_allclose(float(gm[k]), float(wm[k]), rtol=REL,
                                   atol=1e-7, err_msg=k)
    S = tlm._embed_inputs(tparams, tb)[0].shape[1]
    np.testing.assert_array_equal(tlm._full_labels(tb, S).numpy(),
                                  np.asarray(jlm._full_labels(jb, S)))


def test_vlm_prefill_and_decode_match_reference():
    """internvl2: ``prefill`` of patches and text, then STEPS decode
    steps of text tokens, logits and caches within 1e-5 in float32."""
    jlm, jparams, tlm, tparams, jb, tb = _setup("internvl2_76b", "float32")
    serve_j = {k: v for k, v in jb.items() if k != "labels"}
    serve_t = {k: v for k, v in tb.items() if k != "labels"}
    max_len = 24 + STEPS
    jl, jc, jcur = jax.jit(jlm.prefill, static_argnums=2)(jparams, serve_j,
                                                          max_len)
    tl, tc, tcur = tlm.prefill(tparams, serve_t, max_len)
    assert tcur == int(jcur) == 24
    assert _rel(tl, jl) < REL
    for t, j in zip(_cache_leaves(tc), _cache_leaves(jc)):
        assert t.shape == j.shape and _rel(t, j) < REL
    toks = np.random.default_rng(2).integers(
        0, jlm.cfg.vocab_size, (STEPS, B)).astype(np.int32)
    dec = jax.jit(jlm.decode_step)
    for s in range(STEPS):
        jl, jc = dec(jparams, jnp.asarray(toks[s]), jc, jcur)
        tl, tc = tlm.decode_step(tparams, torch.from_numpy(toks[s]), tc,
                                 tcur)
        jcur, tcur = jcur + 1, tcur + 1
        assert _rel(tl, jl) < REL, f"step {s}"
    for t, j in zip(_cache_leaves(tc), _cache_leaves(jc)):
        assert _rel(t, j) < REL


def test_hubert_activations_stay_float32_on_bf16_weights(monkeypatch):
    """Every layer of hubert's bf16 model carries a float32 residual
    stream, as the reference's does: the attention and MLP products
    promote, and B6's plain version sees float32 q, k and v."""
    _, _, tlm, tparams, _, tb = _setup("hubert_xlarge", "bfloat16")
    assert tparams["layers"]["pos0"]["attn"]["wq"].dtype == torch.bfloat16
    seen = []
    orig = layers.flash_attention

    def spy(q, k, v, **kw):
        seen.append((q.dtype, k.dtype, v.dtype, kw["causal"]))
        return orig(q, k, v, **kw)

    monkeypatch.setattr(layers, "flash_attention", spy)
    x, _, _ = tlm._backbone(tparams, tb)
    assert x.dtype == torch.float32
    assert seen == [(torch.float32,) * 3 + (False,)] * tlm.cfg.num_layers
