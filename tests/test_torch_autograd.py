"""The port's autograd over its kernels' wrappers, on the CPU (where the
wrappers run their plain versions, and no kernel launches):

* ``layers.EmbedLookup`` — ``mc_embed``'s kernel route. ``gradcheck`` in
  float64; its backward, the scheduler's embedding-gradient write (B1's
  sort of the batch, then B3's ``add`` into a zero table), equals
  autograd through the kernels-off route, and for a bf16 table each
  row's float32 sum rounded once.
* ``flash_attention.kernel.FlashAttention`` — B6. The gradients of q, k
  and v through the wrapper equal autograd through
  ``flash_attention_plain`` bit for bit (the backward is that autograd),
  for causal, windowed and bidirectional masks, GQA and MQA, float32 and
  bf16, a ragged S over several blocks; and, in float32, those of a dense
  float64 softmax attention within 2e-5 of their largest magnitude (the
  plain version's float32 blocks against float64).
* ``cfg.remat`` checkpoints each layer of the train walk under autograd
  and nothing under ``no_grad``; ``loss_chunks`` each chunk.

The generators are explicit ``torch.Generator``s."""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.core.config import MemoryControllerConfig
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.sorted_gather import kernel as sg_kernel
from repro_torch.models import build_lm, layers
from repro_torch.models import lm as lm_mod
from repro_torch.models.params import leaves

MC = MemoryControllerConfig()


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _tokens(shape, vocab, seed=0):
    """Token ids with many repeats (Zipf-like), int32."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.zipf(1.3, size=shape) - 1) % vocab).to(
        torch.int32)


# ---------------------------------------------------------------------------
# EmbedLookup
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(3, 7), (11,)])
def test_embed_gradcheck_float64(shape):
    table = torch.randn(9, 5, dtype=torch.float64, generator=_gen(),
                        requires_grad=True)
    tokens = _tokens(shape, 9)
    assert torch.autograd.gradcheck(
        lambda t: layers.mc_embed(t, tokens, MC), (table,))


@pytest.mark.parametrize("shape", [(4, 33), (50,)])
def test_embed_backward_is_the_sorted_gradient_write(shape):
    """Kernel route against the kernels-off route (``index_select``'s
    autograd) on the same float32 upstream gradient: equal; the forward
    equal to ``table[tokens]``."""
    table = torch.randn(40, 6, generator=_gen(1))
    tokens = _tokens(shape, 40, seed=2)
    up = torch.randn(*shape, 6, generator=_gen(3))
    grads = []
    for use_kernels in (True, False):
        t = table.clone().requires_grad_()
        out = layers.mc_embed(t, tokens, MC, use_kernels=use_kernels)
        assert torch.equal(out, table[tokens.long()])
        (g,) = torch.autograd.grad(out, [t], up)
        grads.append(g)
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-6, atol=1e-6)
    assert grads[0][torch.bincount(tokens.reshape(-1).long(),
                                   minlength=40) == 0].eq(0).all()


def test_embed_backward_rounds_each_bf16_row_once():
    """A bf16 table's gradient: each row's addends summed in float32, in
    arrival order, and rounded to bf16 once."""
    table = torch.randn(16, 8, generator=_gen(4)).to(torch.bfloat16)
    tokens = _tokens((2, 64), 16, seed=5)
    up = torch.randn(2, 64, 8, generator=_gen(6)).to(torch.bfloat16)
    t = table.clone().requires_grad_()
    (g,) = torch.autograd.grad(layers.mc_embed(t, tokens, MC), [t], up)
    want = torch.zeros(16, 8).index_add_(0, tokens.reshape(-1).long(),
                                         up.reshape(-1, 8).float())
    assert g.dtype == torch.bfloat16
    assert torch.equal(g, want.to(torch.bfloat16))


def test_embed_without_grad_and_launch_counts():
    """No grad wanted: the same lookup, and no gradient graph; no kernel
    launches on the CPU either way."""
    table = torch.randn(10, 4, generator=_gen())
    tokens = _tokens((2, 5), 10)
    out = layers.mc_embed(table, tokens, MC)
    assert not out.requires_grad
    assert torch.equal(out, table[tokens.long()])
    assert sg_kernel.LIB.launches == 0


# ---------------------------------------------------------------------------
# FlashAttention
# ---------------------------------------------------------------------------

CASES = [  # (B, S, H, KV, hd, causal, window, q_block, kv_block)
    (2, 24, 4, 2, 16, True, None, 512, 1024),
    (1, 37, 4, 1, 32, True, 8, 16, 8),
    (2, 19, 2, 2, 16, False, None, 8, 16),
    (1, 40, 6, 3, 16, True, 5, 16, 16),
]


def _qkv(case, dtype, seed=0):
    B, S, H, KV, hd = case[:5]
    g = _gen(seed)
    return [torch.randn(B, S, n, hd, generator=g).to(dtype)
            for n in (H, KV, KV)]


def _kw(case):
    return dict(causal=case[5], window=case[6], q_block=case[7],
                kv_block=case[8])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CASES)
def test_flash_backward_is_autograd_through_the_plain_version(case, dtype):
    q, k, v = _qkv(case, dtype)
    up = torch.randn(q.shape, generator=_gen(7)).to(dtype)
    grads = []
    for fn in (fa_kernel.flash_attention_fwd,
               fa_kernel.flash_attention_plain):
        qkv = [t.clone().requires_grad_() for t in (q, k, v)]
        out = fn(*qkv, **_kw(case))
        grads.append((out, torch.autograd.grad(out, qkv, up)))
    (o1, g1), (o2, g2) = grads
    assert torch.equal(o1, o2)
    for a, b in zip(g1, g2):
        assert a.dtype == dtype and torch.equal(a, b)
    assert fa_kernel.LIB.launches == 0


def _dense(q, k, v, causal, window):
    """Softmax attention in float64, the whole score matrix at once."""
    B, S, H, hd = q.shape
    G = H // k.shape[2]
    k, v = (t.repeat_interleave(G, dim=2) for t in (k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * hd ** -0.5
    qi = torch.arange(S)[:, None]
    ki = torch.arange(S)[None, :]
    mask = torch.ones(S, S, dtype=torch.bool)
    if causal:
        mask &= ki <= qi
    if window is not None:
        mask &= ki > qi - window
    s = s.masked_fill(~mask, float("-inf"))
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v)


@pytest.mark.parametrize("case", CASES)
def test_flash_grads_match_dense_float64_attention(case):
    q, k, v = _qkv(case, torch.float32, seed=1)
    up = torch.randn(q.shape, generator=_gen(8))
    qkv = [t.clone().requires_grad_() for t in (q, k, v)]
    got = torch.autograd.grad(
        fa_kernel.flash_attention_fwd(*qkv, **_kw(case)), qkv, up)
    ref = [t.double().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(_dense(*ref, case[5], case[6]), ref,
                               up.double())
    for a, b in zip(got, want):
        top = float(b.abs().max())
        assert float((a.double() - b).abs().max()) <= 2e-5 * top


def test_flash_backward_only_for_inputs_that_need_it():
    case = CASES[0]
    q, k, v = _qkv(case, torch.float32)
    q.requires_grad_()
    out = fa_kernel.flash_attention_fwd(q, k, v, **_kw(case))
    (gq,) = torch.autograd.grad(out.sum(), [q])
    assert gq.shape == q.shape and k.grad is None and v.grad is None


def test_flash_float32_output_of_bf16_inputs_is_differentiable():
    q, k, v = _qkv(CASES[0], torch.bfloat16)
    qkv = [t.clone().requires_grad_() for t in (q, k, v)]
    out = fa_kernel.flash_attention_fwd(*qkv, out_dtype=torch.float32)
    assert out.dtype == torch.float32
    grads = torch.autograd.grad(out.sum(), qkv)
    assert all(g.dtype == torch.bfloat16 and torch.isfinite(g.float()).all()
               for g in grads)


# ---------------------------------------------------------------------------
# remat and loss_chunks
# ---------------------------------------------------------------------------

def _count_checkpoints(monkeypatch):
    calls = []
    real = lm_mod.checkpoint

    def counting(fn, *args, **kwargs):
        calls.append(getattr(fn, "__name__", "?"))
        return real(fn, *args, **kwargs)

    monkeypatch.setattr(lm_mod, "checkpoint", counting)
    return calls


def _lm_and_batch(**reps):
    cfg = dataclasses.replace(get_arch("h2o_danube_1p8b", smoke=True),
                              param_dtype="float32", **reps)
    lm = build_lm(cfg, device="cpu")
    params = lm.init(_gen())
    tokens = _tokens((2, 16), cfg.vocab_size)
    return lm, params, {"tokens": tokens, "labels": tokens}


def test_remat_checkpoints_each_layer_under_autograd(monkeypatch):
    calls = _count_checkpoints(monkeypatch)
    lm, params, batch = _lm_and_batch(loss_chunks=4)
    flat = [p.requires_grad_() for p in leaves(params)]
    loss, _ = lm.loss(params, batch)
    assert calls == ["_train_block"] * lm.cfg.num_layers + ["terms"] * 4
    torch.autograd.grad(loss, flat)
    calls.clear()
    with torch.no_grad():
        lm.loss(params, batch)
        lm.forward(params, batch)
    assert calls == []


def test_no_remat_checkpoints_nothing(monkeypatch):
    calls = _count_checkpoints(monkeypatch)
    lm, params, batch = _lm_and_batch(remat=False)
    for p in leaves(params):
        p.requires_grad_()
    lm.loss(params, batch)
    assert calls == []


def test_unknown_remat_policy_raises():
    lm, params, batch = _lm_and_batch(remat_policy="everything")
    with pytest.raises(ValueError, match="remat_policy"):
        lm.loss(params, batch)
