"""The port's dry run, roofline and report (``repro_torch.launch``), in
process on the ``fake`` backend: ``meta`` DTensors on a fake mesh, the
step counted once per device.

* The layer-group extrapolation the dry run relies on, total = G1 +
  (G - 1)(G2 - G1), equals the unrolled 6-layer count on the reference's
  tiny h2o-danube override (``tests/distribution/test_sharded.py:108``,
  which fails on jax 0.9.0, ROADMAP C5). The port counts each op, so it
  is held at 1e-6 where the reference allows XLA 12%.
* ``RooflineReport``'s terms with the H100 constants.
* ``report.py`` renders the reference's fixture records as the
  reference's does, and the port's records, whose compile fields are null.
"""

import json
import math

import pytest

from repro.launch import report as jreport
from repro_torch.launch import dryrun, report, roofline
from repro_torch.launch.mesh import make_test_mesh

TINY = {"d_model": 64, "num_heads": 4, "num_kv_heads": 2, "d_ff": 128,
        "vocab_size": 256, "head_dim": 16, "attn_window": 8}


def _counts(nl, shape=(2, 2)):
    mesh = make_test_mesh(shape, device_type="cpu")
    fn, args, _, _, _ = dryrun.build_cell(
        "h2o-danube-1.8b", "train_4k", mesh,
        overrides={**TINY, "num_layers": nl})
    return dryrun.count_step(fn, args)


@pytest.fixture(scope="module")
def tiny():
    with dryrun.fake_world(4):
        counts = {nl: _counts(nl) for nl in (1, 2, 6)}
    with dryrun.fake_world(1):
        counts["one"] = {nl: _counts(nl, (1, 1)) for nl in (1, 2)}
    return counts


def _extrap(g1, g2, n=6):
    return g1 + (n - 1) * (g2 - g1)


def test_cost_extrapolation_exact_on_unrollable_model(tiny):
    g1, g2, g6 = tiny[1], tiny[2], tiny[6]
    assert g6.flops > 0
    assert math.isclose(_extrap(g1.flops, g2.flops), g6.flops, rel_tol=1e-6)
    assert math.isclose(_extrap(g1.hbm_bytes, g2.hbm_bytes), g6.hbm_bytes,
                        rel_tol=1e-6)
    for k, v in g6.collectives_detail.items():
        assert math.isclose(_extrap(g1.collectives_detail[k],
                                    g2.collectives_detail[k]), v,
                            rel_tol=1e-6, abs_tol=0.5)


def test_counts_are_per_device(tiny):
    """A layer's FLOPs on one rank of the (2,2) mesh are a fraction of
    the same layer's on one device: batch and heads are split in two
    each, so about a quarter, and well under a half."""
    per_layer = tiny[2].flops - tiny[1].flops
    one = tiny["one"][2].flops - tiny["one"][1].flops
    assert 0.2 * one < per_layer < 0.5 * one


def _one_layer_flops(mesh_shape, overrides):
    with dryrun.fake_world(math.prod(mesh_shape)):
        mesh = make_test_mesh(mesh_shape, device_type="cpu")
        fn, args, _, _, _ = dryrun.build_cell(
            "h2o-danube-1.8b", "train_4k", mesh,
            overrides={**overrides, "num_layers": 1})
        return dryrun.count_step(fn, args).flops


@pytest.mark.parametrize("mesh_shape, overrides", [
    ((2, 2), TINY), ((4, 2), TINY), ((2, 4), TINY), ((16, 16), {})],
    ids=["tiny-2x2", "tiny-4x2", "tiny-2x4", "full-16x16"])
def test_train_step_splits_its_work_evenly(mesh_shape, overrides):
    """A train step's FLOPs on one rank, times the ranks, are the
    one-device step's: no rank repeats another's products. Without the
    gradient constraint in ``sharding.shard`` the backward of ``wo`` and
    ``w_down`` ran on whole weights on every rank (ROADMAP C28): 3.5
    times a device's share of 6·N·D on the full-width 16x16 cell. On
    (2,4) the two KV heads do not divide the model axis and are
    replicated; their projection's columns are split all the same."""
    ranks = math.prod(mesh_shape)
    per_device = _one_layer_flops(mesh_shape, overrides)
    one = _one_layer_flops((1, 1), overrides)
    assert math.isclose(per_device * ranks, one, rel_tol=1e-9)


def test_step_runs_collectives(tiny):
    det = tiny[6].collectives_detail
    assert det["all-gather"] > 0 and det["reduce-scatter"] > 0
    assert det["all-reduce"] > 0


def test_roofline_terms_use_h100_constants():
    assert roofline.PEAK_FLOPS == 989e12
    assert roofline.HBM_BW == 3.35e12
    assert roofline.COLLECTIVE_BW == 450e9
    r = roofline.RooflineReport(
        name="x", chips=4, hlo_flops=4 * 989e12, hbm_bytes=4 * 3.35e12 * 2,
        collective_bytes=450e9 * 3, collectives_detail={},
        model_flops=2 * 989e12)
    assert r.compute_s == pytest.approx(1.0)
    assert r.memory_s == pytest.approx(2.0)
    assert r.collective_s == pytest.approx(3.0)
    assert r.bottleneck == "collective"
    assert r.bound_s == pytest.approx(3.0)
    assert r.useful_flops_ratio == pytest.approx(0.5)
    assert r.roofline_fraction == pytest.approx(0.5 / 3.0)
    assert r.row().startswith("| x | 3.956e+15 |")


def test_model_flops_is_six_n_d_for_training():
    from repro_torch.configs import SHAPES, get_arch
    cfg = get_arch("h2o-danube-1.8b")
    n = cfg.active_param_count()
    assert roofline.model_flops_for(cfg, SHAPES["train_4k"], n) == \
        6.0 * n * 256 * 4096
    assert roofline.model_flops_for(cfg, SHAPES["decode_32k"], n) == \
        2.0 * n * 128


def test_analyze_scales_per_device_counts_to_global():
    c = roofline.StepCounts(flops=10.0, hbm_bytes=20.0,
                            collectives_detail={"all-gather": 3,
                                                "all-reduce": 4})
    r = roofline.analyze("c", c, chips=8, model_flops=40.0)
    assert (r.hlo_flops, r.hbm_bytes, r.collective_bytes) == (80.0, 160.0,
                                                              7.0)


def _records(tmp_path, recs):
    p = tmp_path / "dryrun.jsonl"
    p.write_text("".join(json.dumps(r) + "\n" for r in recs))
    return str(p)


def _ref_style(cell, **kw):
    r = {"cell": cell, "compile_s": 12.0, "state_bytes_per_device": 3 << 30,
         "memory_analysis": {"temp_size_in_bytes": 200 << 20},
         "hlo_flops": 1.5e15,
         "collectives_detail": {"all-gather": 1 << 20, "all-reduce": 2 << 20},
         "compute_s": 0.02, "memory_s": 0.04, "collective_s": 0.01,
         "bottleneck": "memory", "useful_flops_ratio": 0.9,
         "roofline_fraction": 0.5}
    r.update(kw)
    return r


def test_report_renders_reference_records_as_the_reference(tmp_path):
    path = _records(tmp_path, [
        _ref_style("gpt-125m/base/1pod", roofline_fraction=0.7),
        _ref_style("gpt-125m/base/1pod", roofline_fraction=0.6),
        _ref_style("yi-34b/base/1pod", roofline_fraction=0.3,
                   collective_s=0.05),
        _ref_style("yi-34b/base/2pod", roofline_fraction=0.4),
        {"cell": "broken/base/1pod", "error": "OOM during compile xyz"}])
    recs, jrecs = report.load(path), jreport.load(path)
    assert recs == jrecs
    assert report.summary(recs) == jreport.summary(jrecs)
    assert report.dryrun_table(recs) == jreport.dryrun_table(jrecs)
    for mesh in ("1pod", "2pod"):
        assert report.roofline_table(recs, mesh) == \
            jreport.roofline_table(jrecs, mesh)


def test_report_renders_the_ports_records(tmp_path, tiny):
    c = tiny[6]
    r = roofline.analyze("h2o_danube_1p8b/train_4k/1pod", c, chips=4,
                         model_flops=1e12)
    rec = {"cell": r.name, "chips": 4, "moe_strategy": "tp",
           "lower_s": None, "compile_s": None, "memory_analysis": None,
           "state_bytes_per_device": 1 << 20, "hlo_flops": r.hlo_flops,
           "collectives_detail": r.collectives_detail,
           "compute_s": r.compute_s, "memory_s": r.memory_s,
           "collective_s": r.collective_s, "bottleneck": r.bottleneck,
           "useful_flops_ratio": r.useful_flops_ratio,
           "roofline_fraction": r.roofline_fraction}
    recs = report.load(_records(tmp_path, [rec]))
    table = report.dryrun_table(recs)
    assert "| h2o_danube_1p8b/train_4k | 1pod | — | 1.0M | — |" in table
    assert f"**{r.bottleneck}**" in report.roofline_table(recs, "1pod")
    assert "cells compiled OK: 1; failed: 0" in report.summary(recs)


def test_fake_world_refuses_a_second_group():
    with dryrun.fake_world(4):
        with pytest.raises(RuntimeError, match="process of its own"):
            with dryrun.fake_world(4):
                pass


def test_run_cell_h2o_danube_train_on_one_pod():
    """The card's dry-run cell, on the host: its state bytes (parameters
    and AdamW moments per device) are the reference's figure, and the
    counted step does at least the model's 6·N·D."""
    rec = dryrun.run_cell("h2o-danube-1.8b", "train_4k")
    assert rec["state_bytes_per_device"] == STATE_BYTES_H2O_TRAIN
    assert rec["compile_s"] is None and rec["memory_analysis"] is None
    assert 0.1 < rec["useful_flops_ratio"] <= 1.0
    assert rec["bottleneck"] in ("compute", "memory", "collective")
    assert rec["flops_per_device"] * 256 == rec["hlo_flops"]


# parameters 24,156,160 bytes per device (test_torch_sharding.py) plus the
# float32 moments, each of the parameters' layout, and the int32 step
STATE_BYTES_H2O_TRAIN = 24_156_160 + 2 * 2 * 24_156_160 + 4
