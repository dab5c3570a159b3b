"""The plain embedding lookups' backward sums in a fixed order (ROADMAP C32).

``mc_embed`` with kernels off (the scheduler's plain sort and gathers) and
with the scheduler disabled (one ``index_select``) take their backward
from ``layers.EmbedLookup``'s plain route: a stable sort of the token ids
and B3's plain ``add`` into a zero table, each row's addends summed in
slot order in float32 and rounded once, with no ``index_add`` (on CUDA an
atomic add in no fixed order). On the CPU, from numpy seed 0, on batches
with repeated ids: the float32 gradient against ``jax.grad`` of the
reference's ``repro.models.layers.mc_embed`` with the same controller
config, the bf16 gradient against its float32 sums rounded once, no
``index_add`` among the ATen ops the backward dispatches, and which
kernel wrappers each route reaches (a wrapper reached on a CUDA tensor
launches its kernel). The forward keeps ``table[tokens]``'s bits on both
routes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.core.config import MemoryControllerConfig as JMC
from repro.core.config import SchedulerConfig as JSched
from repro.models import layers as jl
from repro_torch.core.config import MemoryControllerConfig as TMC
from repro_torch.core.config import SchedulerConfig as TSched
from repro_torch.kernels.bitonic_sort import ops as bs_ops
from repro_torch.kernels.sorted_gather import kernel as sg_kernel
from repro_torch.kernels.sorted_scatter import kernel as ss_kernel
from repro_torch.models import layers as tl

VOCAB, D = 64, 24
# (token shape, scheduler enabled, use_kernels): the two plain routes, over
# a batch of sequences and over a 1-D decode-style stream.
ROUTES = [((4, 96), True, False), ((300,), True, False),
          ((4, 96), False, False), ((300,), False, False),
          ((4, 96), False, True)]
IDS = [f"{'x'.join(map(str, s))}-sched_{e}-kernels_{k}" for s, e, k in ROUTES]


def _inputs(shape, dtype=np.float32):
    """Table, Zipf token ids (many repeats) and the upstream gradient, all
    from numpy seed 0."""
    rng = np.random.default_rng(0)
    table = rng.standard_normal((VOCAB, D)).astype(dtype)
    tokens = ((rng.zipf(1.2, size=shape) - 1) % VOCAB).astype(np.int32)
    up = rng.standard_normal((*shape, D)).astype(dtype)
    assert np.bincount(tokens.reshape(-1)).max() > 10
    return table, tokens, up


def _port_grad(table, tokens, up, enabled, use_kernels):
    t = table.clone().requires_grad_()
    out = tl.mc_embed(t, tokens, TMC(scheduler=TSched(enabled=enabled)),
                      use_kernels=use_kernels)
    assert torch.equal(out, table[tokens.long()])
    (g,) = torch.autograd.grad(out, [t], up)
    return out, g


@pytest.mark.parametrize("shape,enabled,use_kernels", ROUTES, ids=IDS)
def test_float32_gradient_matches_jax_grad(shape, enabled, use_kernels):
    table, tokens, up = _inputs(shape)
    jmc = JMC(scheduler=JSched(enabled=enabled))
    want = np.asarray(jax.grad(lambda t: jnp.sum(
        jl.mc_embed(t, jnp.asarray(tokens), jmc) * jnp.asarray(up)))(
            jnp.asarray(table)))
    _, got = _port_grad(torch.from_numpy(table), torch.from_numpy(tokens),
                        torch.from_numpy(up), enabled, use_kernels)
    assert got.dtype == torch.float32
    err = np.abs(got.numpy().astype(np.float64) - want).max()
    assert err <= 1e-6 * np.abs(want).max(), err


@pytest.mark.parametrize("shape,enabled,use_kernels", ROUTES, ids=IDS)
def test_bf16_gradient_is_its_float32_sums_rounded_once(shape, enabled,
                                                        use_kernels):
    table, tokens, up = _inputs(shape)
    tt = torch.from_numpy(table).to(torch.bfloat16)
    upt = torch.from_numpy(up).to(torch.bfloat16)
    tok = torch.from_numpy(tokens)
    _, got = _port_grad(tt, tok, upt, enabled, use_kernels)
    # float32 sums of the bf16 addends, each row's in arrival order
    flat = tokens.reshape(-1)
    rows = upt.reshape(-1, D).float()
    want = torch.zeros(VOCAB, D)
    for i in range(flat.shape[0]):
        want[flat[i]] += rows[i]
    assert got.dtype == torch.bfloat16
    assert torch.equal(got.view(torch.int16),
                       want.to(torch.bfloat16).view(torch.int16))


class _AtenOps(TorchDispatchMode):
    """Records the name of every ATen op dispatched inside it, those of
    autograd's backward formulas included (``index_select``'s backward
    dispatches ``aten.index_add`` from C++, which no Python patch sees)."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


# The kernel wrappers of B1, B2 and B3, as mc_embed and sorted_scatter reach
# them: (module, attribute).
WRAPPERS = {"bitonic_sort": (bs_ops, "bitonic_sort_batched"),
            "sorted_gather": (sg_kernel, "gather_rows"),
            "sorted_scatter": (ss_kernel, "scatter_rows")}


def _count_wrappers(monkeypatch) -> dict:
    """Wrap each kernel wrapper to count its calls; returns the counts."""
    calls = dict.fromkeys(WRAPPERS, 0)

    def counted(name, fn):
        def call(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return call

    for name, (mod, attr) in WRAPPERS.items():
        monkeypatch.setattr(mod, attr, counted(name, getattr(mod, attr)))
    return calls


@pytest.mark.parametrize("shape,enabled,use_kernels", ROUTES, ids=IDS)
def test_backward_is_the_plain_write_without_index_add(
        shape, enabled, use_kernels, monkeypatch):
    table, tokens, up = _inputs(shape)

    def refuse(*args, **kwargs):
        raise AssertionError("index_add_ on the embedding's backward")

    monkeypatch.setattr(torch.Tensor, "index_add_", refuse)
    with pytest.raises(AssertionError, match="index_add_"):
        torch.zeros(2).index_add_(0, torch.tensor([0]), torch.ones(1))
    calls = _count_wrappers(monkeypatch)
    t = torch.from_numpy(table).requires_grad_()
    out = tl.mc_embed(t, torch.from_numpy(tokens),
                      TMC(scheduler=TSched(enabled=enabled)),
                      use_kernels=use_kernels)
    with _AtenOps() as aten:
        (g,) = torch.autograd.grad(out, [t], torch.from_numpy(up))
    assert not [op for op in aten.ops if "index_add" in op], aten.ops
    assert any(op.startswith("aten.segment_reduce") for op in aten.ops), \
        aten.ops
    assert calls == dict.fromkeys(WRAPPERS, 0), calls
    assert bool(torch.isfinite(g).all())
    monkeypatch.undo()
    assert torch.Tensor.index_add_ is not refuse
    assert all(getattr(m, a).__name__ == a for m, a in WRAPPERS.values())


def test_kernel_route_reaches_the_kernel_wrappers(monkeypatch):
    """The kernel route (scheduler on, kernels on) reaches B1's wrapper in
    the forward and the backward, B2's in the forward and B3's in the
    backward, dispatches no ``index_add`` either, and gives the plain
    route's float32 gradient."""
    table, tokens, up = _inputs((4, 96))
    grads = []
    for use_kernels, want in ((True, dict(bitonic_sort=2, sorted_gather=1,
                                          sorted_scatter=1)),
                              (False, dict.fromkeys(WRAPPERS, 0))):
        calls = _count_wrappers(monkeypatch)
        t = torch.from_numpy(table).requires_grad_()
        out = tl.mc_embed(t, torch.from_numpy(tokens), TMC(),
                          use_kernels=use_kernels)
        with _AtenOps() as aten:
            grads.append(torch.autograd.grad(out, [t],
                                             torch.from_numpy(up))[0])
        monkeypatch.undo()
        assert calls == want, (use_kernels, calls)
        assert not [op for op in aten.ops if "index_add" in op], aten.ops
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-6, atol=1e-6)


def test_index_select_backward_dispatches_index_add():
    """The check above sees what it looks for: the parent's scheduler-off
    route, a bare ``index_select``, dispatches ``aten.index_add`` in its
    backward."""
    table, tokens, up = _inputs((4, 96))
    t = torch.from_numpy(table).requires_grad_()
    out = t.index_select(0, torch.from_numpy(tokens).reshape(-1))
    with _AtenOps() as aten:
        torch.autograd.grad(out, [t], torch.from_numpy(up).reshape(-1, D))
    assert [op for op in aten.ops if "index_add" in op], aten.ops


def test_no_grad_lookup_builds_no_graph():
    table, tokens, _ = _inputs((4, 96))
    for enabled in (True, False):
        out = tl.mc_embed(torch.from_numpy(table), torch.from_numpy(tokens),
                          TMC(scheduler=TSched(enabled=enabled)),
                          use_kernels=False)
        assert out.grad_fn is None and not out.requires_grad
        assert torch.equal(out, torch.from_numpy(table)[tokens])
