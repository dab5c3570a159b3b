"""Port parity for the MoE FFN (``repro_torch.models.blocks.moe_ffn`` and
its router, capacity and slot helpers, on the CPU) against
``repro.models.blocks.moe_ffn`` on the same float32 params and inputs.

The routing is held exactly: each token's experts (read from the
reference's own ``capture_moe_dispatch`` record), each assignment's slot
and kept mask (against the reference's slot formula), for the ``sort``
and ``cumsum`` dispatches, ample (8.0) and starved (0.3) capacity, and 1,
2 and 4 scheduler groups. Outputs and the aux losses at rtol = atol =
1e-4 (two frameworks' float32 products in another summation order)."""

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.core.capture import TraceCapture as JCapture
from repro.models import blocks as jblocks
from repro.models import build_lm as jbuild_lm
from repro.models.sharding import make_rules
from repro_torch import convert
from repro_torch.core.capture import TraceCapture as TCapture
from repro_torch.models import blocks as tblocks

ARCHS = ["mixtral_8x7b", "qwen2_moe_a2p7b"]   # top-2 of 8; top-4 of 8 + 2


@functools.lru_cache(maxsize=None)
def _layer0(arch):
    """Layer 0's MoE params of the reference's float32 init (seed 0), as
    numpy leaves."""
    jcfg = dataclasses.replace(jget_arch(arch, smoke=True),
                               param_dtype="float32")
    params = jbuild_lm(jcfg).init(jax.random.key(0))
    return jax.tree.map(lambda t: np.asarray(t[0]),
                        params["layers"]["pos0"]["moe"])


def _setup(arch, capacity_factor=8.0):
    jcfg = jget_arch(arch, smoke=True)
    jcfg = dataclasses.replace(
        jcfg, param_dtype="float32",
        moe=dataclasses.replace(jcfg.moe, capacity_factor=capacity_factor))
    tcfg = convert.arch_config_from_dict(dataclasses.asdict(jcfg))
    leaves = _layer0(arch)
    jp = jax.tree.map(jnp.asarray, leaves)
    tp = convert.lm_params(leaves, "cpu")
    return jcfg, tcfg, jp, tp


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _ref_slots(top_e, groups, experts, capacity, dispatch):
    """The reference's slot placement (``repro.models.blocks.moe_ffn``'s
    scheduler lines), on its own top-k experts."""
    e_grp = jnp.asarray(top_e).reshape(groups, -1)
    na = e_grp.shape[1]
    if dispatch == "sort":
        order = jnp.argsort(e_grp, axis=-1, stable=True)
        e_sorted = jnp.take_along_axis(e_grp, order, axis=-1)
        run_start = jax.vmap(
            lambda es: jnp.searchsorted(es, jnp.arange(experts)))(e_sorted)
        pos_sorted = (jnp.arange(na)[None, :]
                      - jnp.take_along_axis(run_start, e_sorted, axis=-1))
        pos_in_e = jax.vmap(lambda z, o, v: z.at[o].set(v))(
            jnp.zeros((groups, na), jnp.int32), order,
            pos_sorted.astype(jnp.int32))
    else:
        onehot = jax.nn.one_hot(e_grp, experts, dtype=jnp.int32)
        pos_in_e = (jnp.cumsum(onehot, axis=1) * onehot).sum(-1) - 1
    keep = pos_in_e < capacity
    return np.asarray(pos_in_e), np.asarray(keep), np.asarray(
        jnp.where(keep, pos_in_e, capacity))


def _ref_capacity(cfg, tg):
    m = cfg.moe
    c = int(math.ceil(tg * m.top_k / m.num_experts * m.capacity_factor))
    if c >= 64:
        c = -(-c // 128) * 128
    return min(c, tg)


def _run_both(arch, cf, x, **kw):
    jcfg, tcfg, jp, tp = _setup(arch, cf)
    with JCapture() as jcap:
        want, waux = jblocks.moe_ffn(jp, jnp.asarray(x), jcfg,
                                     make_rules(None), None, **kw)
    with TCapture() as tcap:
        got, gaux = tblocks.moe_ffn(tp, torch.from_numpy(x), tcfg, **kw)
    return (jcfg, tcfg, tp), (want, waux, jcap), (got, gaux, tcap)


# qwen2-moe (the served MoE) over the whole grid; mixtral at starved
# capacity in two groups.
GRID = [("qwen2_moe_a2p7b", d, cf, g) for d in ("sort", "cumsum")
        for cf in (8.0, 0.3) for g in (1, 2, 4)] + [
    ("mixtral_8x7b", d, 0.3, 2) for d in ("sort", "cumsum")]


@pytest.mark.parametrize("arch,dispatch,cf,groups", GRID)
def test_moe_ffn_matches_reference(arch, dispatch, cf, groups):
    x = _x((4, 8, 64))
    (jcfg, tcfg, tp), (want, waux, jcap), (got, gaux, _) = _run_both(
        arch, cf, x, dispatch=dispatch, num_groups=groups)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    assert gaux.keys() == waux.keys()
    for k in waux:
        np.testing.assert_allclose(float(gaux[k]), float(waux[k]),
                                   rtol=1e-4, atol=1e-6)
    # the routing, exactly
    m = tcfg.moe
    T = x.shape[0] * x.shape[1]
    _, _, _, _, top_e = tblocks.moe_route(tp, torch.from_numpy(x), tcfg)
    jtop_e = jcap.rows()["pe_id"][:T * m.top_k].reshape(T, m.top_k)
    np.testing.assert_array_equal(top_e.numpy(), jtop_e)
    C = tblocks.moe_capacity(tcfg, T // groups)
    assert C == _ref_capacity(jcfg, T // groups)
    pos, keep, slot = tblocks.moe_slots(top_e, groups, m.num_experts, C,
                                        dispatch)
    for a, b in zip((pos, keep, slot),
                    _ref_slots(jtop_e, groups, m.num_experts, C, dispatch)):
        np.testing.assert_array_equal(a.numpy(), b)
    if cf == 0.3:
        assert not keep.all()        # the starved case drops
    else:
        assert keep.all()


@pytest.mark.parametrize("cf", [8.0, 0.3])
@pytest.mark.parametrize("arch", ARCHS)
def test_sort_dispatch_bitwise_matches_cumsum(arch, cf):
    """The port's two dispatches give the same bits, drops included."""
    _, tcfg, _, tp = _setup(arch, cf)
    x = torch.from_numpy(_x((2, 16, 64), seed=1))
    a, _ = tblocks.moe_ffn(tp, x, tcfg, dispatch="sort")
    b, _ = tblocks.moe_ffn(tp, x, tcfg, dispatch="cumsum")
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="unknown MoE dispatch"):
        tblocks.moe_ffn(tp, x, tcfg, dispatch="onehot")


@pytest.mark.parametrize("arch", ARCHS)
def test_no_drop_and_ragged_groups_match_reference(arch):
    """``no_drop`` (the decode path: capacity = tokens) at cf 0.3, and a
    group count that does not divide the tokens (falls back to 1)."""
    for kw, shape in ((dict(no_drop=True), (3, 1, 64)),
                      (dict(num_groups=4), (3, 5, 64))):
        x = _x(shape, seed=2)
        _, (want, _, _), (got, _, _) = _run_both(arch, 0.3, x, **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-4)


def test_top_k_breaks_ties_toward_the_lower_index():
    rng = np.random.default_rng(3)
    probs = rng.integers(0, 4, (64, 12)).astype(np.float32) / 4
    probs[0] = 0.5                    # one row all tied
    wv, wi = jax.lax.top_k(jnp.asarray(probs), 5)
    gv, gi = tblocks.top_k_lower_first(torch.from_numpy(probs), 5)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    assert gi[0].tolist() == [0, 1, 2, 3, 4]


@pytest.mark.parametrize("arch", ARCHS)
def test_forced_ties_route_like_the_reference(arch):
    """A zero router makes every probability equal: each token takes
    experts 0..k-1 on both sides, and the outputs agree."""
    jcfg, tcfg, jp, tp = _setup(arch, 0.3)
    jp = {**jp, "router": jnp.zeros_like(jp["router"])}
    tp = {**tp, "router": torch.zeros_like(tp["router"])}
    x = _x((2, 8, 64), seed=4)
    with JCapture() as jcap:
        want, waux = jblocks.moe_ffn(jp, jnp.asarray(x), jcfg,
                                     make_rules(None), None)
    got, gaux = tblocks.moe_ffn(tp, torch.from_numpy(x), tcfg)
    k = tcfg.moe.top_k
    assert (jcap.rows()["pe_id"][:16 * k].reshape(16, k)
            == np.arange(k)).all()
    _, _, _, top_p, top_e = tblocks.moe_route(tp, torch.from_numpy(x), tcfg)
    assert (top_e.numpy() == np.arange(k)).all()
    assert torch.allclose(top_p, torch.full_like(top_p, 1 / k))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(float(gaux["load_balance"]),
                               float(waux["load_balance"]), rtol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_capture_moe_dispatch_records_match_reference(arch):
    x = _x((2, 6, 64), seed=5)
    _, (_, _, jcap), (_, _, tcap) = _run_both(arch, 8.0, x)
    want, got = jcap.rows(), tcap.rows()
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert tcap.op_counts() == jcap.op_counts()
    assert set(tcap.op_counts()) == {"moe_dispatch", "moe_combine"}
    assert tcap.n_rows_total == jcap.n_rows_total
    # no capture active: nothing recorded, nothing raised
    tblocks.capture_moe_dispatch(torch.zeros((3, 2), dtype=torch.int64),
                                 3, 64, 4)
