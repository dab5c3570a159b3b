"""Port parity for the model trace zoo and the token half of the synthetic
data: ``repro_torch.data.synthetic`` (``zipf_tokens``, ``make_batch``,
``SyntheticDataset``) bit-equal to the reference's for every
architecture, and ``repro_torch.data.model_traces.capture_model_trace``
(the exercise script under an active ``TraceCapture``, through the
embedding, KV, frontend, MoE and SSM hooks) against the reference's live
capture on the same parameters, converted leaf for leaf, on the CPU.

Which rows can differ: a decode step feeds back the argmax of its logits,
and a MoE layer's routes are the router's top-k, so those rows depend on
the two frameworks' arithmetic (``model_traces.value_dependent``); every
other row comes from the data and the shapes. In float32 the two
packages give the same trace, all six columns, for all ten smoke
configs. In bf16 (the configs as registered) the value-independent rows
are equal and the value-dependent ones have the same count; the rows
that differ come from near-ties (ROADMAP C20). The pinned traces under
``tests/goldens/traces/`` are the reference's on an older JAX, whose
decode rows differ from its own live capture today (ROADMAP A7.6), so
they are held on their value-independent rows and op counts.

This file holds the dense, audio and vision architectures;
``test_torch_model_traces_{moe,ssm,hybrid}.py`` the others, with this
file's helpers. Run as a script, it prints each architecture's bf16
differences (JSON lines)::

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_model_traces.py
"""

import contextlib
import dataclasses
import functools
import json
import sys
import types

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.configs import registry as jregistry
from repro.configs.base import ShapeConfig as JShape
from repro.data import model_traces as jmt
from repro.data import synthetic as jsyn
from repro.models import lm as jlm_mod
from repro_torch import convert
from repro_torch.configs import get_arch as tget_arch
from repro_torch.configs import registry as tregistry
from repro_torch.configs.base import ShapeConfig as TShape
from repro_torch.core import capture as capture_mod
from repro_torch.data import model_traces as tmt
from repro_torch.data import synthetic as tsyn
from repro_torch.models import blocks
from repro_torch.models import build_lm as tbuild_lm
from repro_torch.models import lm as tlm_mod

COLUMNS = ("pe_id", "row_id", "rw", "nbytes", "op", "arrival_cycle")
HERE = ["yi_34b", "granite_34b", "h2o_danube_1p8b", "internlm2_20b",
        "hubert_xlarge", "internvl2_76b"]


@contextlib.contextmanager
def smoke_at(dtype: str | None):
    """Both packages' ``capture_model_trace`` on their registry's smoke
    configs at ``dtype`` (each module's ``registry`` swapped for the
    call); as registered when ``dtype`` is None."""
    mods = ((jmt, jregistry), (tmt, tregistry))
    if dtype is not None:
        for mod, reg in mods:
            mod.registry = types.SimpleNamespace(
                get_arch=lambda name, smoke=False, reg=reg:
                dataclasses.replace(reg.get_arch(name, smoke=smoke),
                                    param_dtype=dtype))
    try:
        yield
    finally:
        for mod, reg in mods:
            mod.registry = reg


@functools.lru_cache(maxsize=None)
def _reference(arch: str, dtype: str | None):
    """The reference's own ``capture_model_trace(arch)``, at ``dtype``
    when given, and the parameters it drew (its ``LM.init`` wrapped for
    the call)."""
    drawn = []
    init = jlm_mod.LM.init

    def keep(self, key):
        drawn.append(init(self, key))
        return drawn[-1]

    jlm_mod.LM.init = keep
    try:
        with smoke_at(dtype):
            cap = jmt.capture_model_trace(arch)
    finally:
        jlm_mod.LM.init = init
    (params,) = drawn
    return cap, convert.lm_params(jax.tree.map(np.asarray, params), "cpu")


def ref_capture(arch: str, dtype: str | None):
    return _reference(arch, dtype)[0]


@functools.lru_cache(maxsize=None)
def port_capture(arch: str, dtype: str | None):
    params = _reference(arch, dtype)[1]
    with smoke_at(dtype):
        return tmt.capture_model_trace(arch, params=params, device="cpu")


def same_layout(got, want) -> None:
    """Regions, op labels, op count and every column's length equal."""
    assert got.to_dict()["regions"] == want.to_dict()["regions"]
    assert got.op_labels == want.op_labels
    assert got.n_ops == want.n_ops and len(got) == len(want)


def differences(arch: str) -> dict:
    """The bf16 captures' differing rows: per differing record, its op,
    ordinal and positions, with both packages' row and port ids."""
    got, want = port_capture(arch, None), ref_capture(arch, None)
    g, w = got.rows(), want.rows()
    vd = tmt.value_dependent(got)
    diff = np.nonzero((g["row_id"] != w["row_id"])
                      | (g["pe_id"] != w["pe_id"]))[0]
    records = []
    for stamp in np.unique(g["arrival_cycle"][diff]):
        at = diff[g["arrival_cycle"][diff] == stamp]
        first = int(np.argmax(g["arrival_cycle"] == stamp))
        records.append(dict(
            op=got.op_labels[int(g["op"][at[0]])], ordinal=int(stamp),
            positions=(at - first).tolist(),
            reference_rows=w["row_id"][at].tolist(),
            port_rows=g["row_id"][at].tolist(),
            reference_ports=w["pe_id"][at].tolist(),
            port_ports=g["pe_id"][at].tolist()))
    return dict(arch=arch, requests=len(got),
                value_dependent=int(vd.sum()), differing=int(diff.size),
                value_independent_differing=int((~vd[diff]).sum()),
                records=records)


def check_bf16(arch: str) -> None:
    """Value-independent rows equal in all six columns; the
    value-dependent ones in every column but the row and port ids."""
    got, want = port_capture(arch, None), ref_capture(arch, None)
    same_layout(got, want)
    g, w = got.rows(), want.rows()
    vd = tmt.value_dependent(got)
    np.testing.assert_array_equal(vd, tmt.value_dependent(want))
    for c in COLUMNS:
        np.testing.assert_array_equal(g[c][~vd], w[c][~vd], err_msg=c)
        if c not in ("row_id", "pe_id"):
            np.testing.assert_array_equal(g[c], w[c], err_msg=c)


def check_float32(arch: str) -> None:
    """The whole trace equal: regions, labels and all six columns."""
    got, want = port_capture(arch, "float32"), ref_capture(arch, "float32")
    same_layout(got, want)
    g, w = got.rows(), want.rows()
    for c in COLUMNS:
        assert g[c].dtype == w[c].dtype, c
        np.testing.assert_array_equal(g[c], w[c], err_msg=c)
    assert tmt.summarize(got) == jmt.summarize(want)


# ---------------------------------------------------------------------------
# The token half of data/synthetic.py
# ---------------------------------------------------------------------------

def test_zipf_tokens_match_reference():
    for seed, vocab in ((0, 256), (3, 65536), (7, 504)):
        want = jsyn.zipf_tokens(jsyn._rng(seed, 1, 1), (4, 33), vocab)
        got = tsyn.zipf_tokens(tsyn._rng(seed, 1, 1), (4, 33), vocab)
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("smoke", [True, False])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_make_batch_matches_reference(arch, smoke):
    """Every key, dtype, shape and value, over steps, seeds and a batch
    override (the full configs at a short sequence)."""
    jcfg = jregistry.get_arch(arch, smoke=smoke)
    tcfg = tget_arch(arch, smoke=smoke)
    seq = 300 if jcfg.modality == "vision_text" else 40
    for step, seed, override in ((0, 0, None), (3, 0, None), (1, 5, 2)):
        want = jsyn.make_batch(jcfg, JShape("s", seq, 3, "train"), step=step,
                               seed=seed, batch_override=override)
        got = tsyn.make_batch(tcfg, TShape("s", seq, 3, "train"), step=step,
                              seed=seed, batch_override=override)
        assert list(got) == list(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("arch", ["yi_34b", "hubert_xlarge",
                                  "internvl2_76b"])
def test_synthetic_dataset_matches_reference(arch):
    """Host slices and the step iterator, as the reference's."""
    jcfg, tcfg = jregistry.get_arch(arch, True), tget_arch(arch, True)
    for host in range(2):
        want = jsyn.SyntheticDataset(jcfg, JShape("s", 32, 4, "train"),
                                     seed=2, host_index=host, host_count=2)
        got = tsyn.SyntheticDataset(tcfg, TShape("s", 32, 4, "train"),
                                    seed=2, host_index=host, host_count=2)
        for (_, w), (_, g) in zip(zip(range(3), want), zip(range(3), got)):
            assert list(g) == list(w)
            for k in w:
                np.testing.assert_array_equal(g[k], w[k])
        assert got.batch_at(5)["labels"].shape[0] == 2


# ---------------------------------------------------------------------------
# Capture against the reference's live capture
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", HERE)
def test_capture_matches_reference_float32(arch):
    check_float32(arch)


@pytest.mark.parametrize("arch", HERE)
def test_capture_value_independent_rows_match_reference_bf16(arch):
    check_bf16(arch)


def check_pinned(arch: str) -> None:
    """The pinned golden against the port's bf16 capture on the
    reference's parameters: regions, labels, op counts, and every
    value-independent row in all six columns."""
    got, want = port_capture(arch, None), tmt.load_pinned_trace(arch)
    same_layout(got, want)
    assert got.op_counts() == want.op_counts()
    g, w = got.rows(), want.rows()
    vd = tmt.value_dependent(got)
    for c in COLUMNS:
        np.testing.assert_array_equal(g[c][~vd], w[c][~vd], err_msg=c)


@pytest.mark.parametrize("arch", ["yi_34b", "hubert_xlarge",
                                  "internvl2_76b"])
def test_pinned_trace_value_independent_rows_and_op_counts(arch):
    check_pinned(arch)


def test_value_dependent_marks_decode_gathers_and_routes():
    """yi-34b: the 8 decode steps' 4-token gathers; hubert: nothing."""
    yi = port_capture("yi_34b", None)
    vd = tmt.value_dependent(yi)
    assert int(vd.sum()) == tmt.CAPTURE_DECODE_STEPS * tmt.CAPTURE_BATCH
    op = np.asarray(yi.op_labels)[yi.rows()["op"]]
    assert set(op[vd]) == {"embed_gather"}
    assert int((op == "embed_gather").sum()) - int(vd.sum()) == \
        2 * tmt.CAPTURE_BATCH * tmt.CAPTURE_SEQ
    assert not tmt.value_dependent(port_capture("hubert_xlarge", None)).any()


def test_hooks_read_nothing_without_a_capture(monkeypatch):
    """With no capture active no hook copies or records anything: the
    serve path's forward, prefill and decode run with ``concrete`` and
    ``TraceCapture.record`` made to raise."""
    def boom(*a, **k):
        raise AssertionError("a hook read a value with no capture active")

    monkeypatch.setattr(capture_mod, "concrete", boom)
    monkeypatch.setattr(capture_mod.TraceCapture, "record", boom)
    for arch in ("internvl2_76b", "jamba_v0p1_52b", "hubert_xlarge"):
        cfg = tget_arch(arch, smoke=True)
        lm = tbuild_lm(cfg, device="cpu")
        params = lm.init(torch.Generator().manual_seed(0))
        data = {k: torch.from_numpy(v) for k, v in tsyn.make_batch(
            cfg, TShape("s", 16, 2, "train"), step=0).items()}
        lm.forward(params, data)
        if cfg.family != "encoder":
            serve = {k: v for k, v in data.items() if k != "labels"}
            logits, cache, cur = lm.prefill(params, serve, 20)
            lm.decode_step(params, torch.argmax(logits, -1).to(torch.int32),
                           cache, cur)


def test_capture_on_the_ports_own_params():
    """Without ``params`` the port's seeded init runs; ``cached_capture``
    memoizes it. The value-independent rows do not depend on the
    weights."""
    a = tmt.cached_capture("internvl2_76b", device="cpu")
    assert tmt.cached_capture("internvl2_76b", device="cpu") is a
    b = port_capture("internvl2_76b", None)
    same_layout(a, b)
    vd = tmt.value_dependent(a)
    for c in COLUMNS:
        np.testing.assert_array_equal(a.rows()[c][~vd], b.rows()[c][~vd])
    s = tmt.summarize(a)
    assert s["n_requests"] == len(a) and s["op_counts"] == a.op_counts()


def bf16_ulps(gap: float, scale: float) -> float:
    """``gap`` in bf16 ulps at magnitude ``scale`` (8 significand bits)."""
    return gap / 2.0 ** (np.floor(np.log2(scale)) - 7)


def near_ties(arch: str) -> dict:
    """Where the first differing decode token and the first differing MoE
    route come from: the port's own logits there (the step's LM logits;
    the layer's router logits at the first rank where the two packages'
    top-k lists differ), the gap between its pick and the reference's,
    absolute and in bf16 ulps of the row's largest magnitude."""
    got, want = port_capture(arch, None), ref_capture(arch, None)
    g, w = got.rows(), want.rows()
    op = np.asarray(got.op_labels)[g["op"]]
    step_logits, router_logits = [], []
    orig = (tlm_mod.LM.prefill, tlm_mod.LM.decode_step, blocks.moe_route)

    def prefill(self, *a, **k):
        out = orig[0](self, *a, **k)
        step_logits.append(out[0].float())
        return out

    def decode_step(self, *a, **k):
        out = orig[1](self, *a, **k)
        step_logits.append(out[0].float())
        return out

    def moe_route(*a, **k):
        out = orig[2](*a, **k)
        router_logits.append(out[1])
        return out

    tlm_mod.LM.prefill, tlm_mod.LM.decode_step = prefill, decode_step
    blocks.moe_route = moe_route
    try:
        again = tmt.capture_model_trace(arch, params=_reference(arch, None)[1],
                                        device="cpu")
    finally:
        tlm_mod.LM.prefill, tlm_mod.LM.decode_step, blocks.moe_route = orig
    assert np.array_equal(again.rows()["row_id"], g["row_id"])
    out = {"arch": arch}
    diff = (g["row_id"] != w["row_id"]) | (g["pe_id"] != w["pe_id"])
    gathers = np.unique(g["arrival_cycle"][op == "embed_gather"])
    dec = np.nonzero(diff & (op == "embed_gather"))[0]
    if dec.size:
        i = dec[0]
        step = int(np.searchsorted(gathers, g["arrival_cycle"][i])) - 2
        first = int(np.argmax(g["arrival_cycle"] == g["arrival_cycle"][i]))
        b = int(i - first)
        embed = next(r for r in got.to_dict()["regions"]
                     if r["name"].startswith("embed:"))
        pt, rt = int(g["row_id"][i]) - embed["base"], \
            int(w["row_id"][i]) - embed["base"]
        lg = step_logits[step][b]
        gap = float(lg[pt] - lg[rt])
        out["decode"] = dict(step=step, sequence=b, port_token=pt,
                             reference_token=rt, port_logit_gap=gap,
                             gap_bf16_ulps=bf16_ulps(gap,
                                                     float(lg.abs().max())),
                             rows_differing=int(dec.size))
    moe = np.nonzero(diff & (op == "moe_dispatch"))[0]
    if moe.size:
        i = moe[0]
        stamps = np.unique(g["arrival_cycle"][op == "moe_dispatch"])
        call = int(np.searchsorted(stamps, g["arrival_cycle"][i]))
        first = int(np.argmax(g["arrival_cycle"] == g["arrival_cycle"][i]))
        k = tget_arch(arch, smoke=True).moe.top_k
        tok = int(i - first) // k
        at = slice(first + tok * k, first + tok * k + k)
        pe, re_ = g["pe_id"][at].tolist(), w["pe_id"][at].tolist()
        j = next(j for j in range(k) if pe[j] != re_[j])
        lg = router_logits[call][tok]
        gap = float(lg[pe[j]] - lg[re_[j]])
        out["route"] = dict(
            moe_call=call, token=tok, rank=j, port_experts=pe,
            reference_experts=re_, port_router_logit_gap=gap,
            gap_bf16_ulps=bf16_ulps(gap, float(lg.abs().max())),
            rows_differing=int(moe.size))
    return out


def main() -> int:
    for arch in ARCH_IDS:
        print(json.dumps(differences(arch)), flush=True)
        print(json.dumps(near_ties(arch)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
