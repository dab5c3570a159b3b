"""The 18 pinned goldens (``tests/goldens/*.json``) reproduced by the port.

Each case's configuration is the reference's, carried across with
``convert.config_from_dict``; its trace is built by the shared case
definitions (``tests/core/golden_cases.py``), except the serving
workloads, which the port's own arrival generators build (and which are
held equal to the reference's draws first). The record functions are
``golden_cases``' rebuilt on the port's ``MemoryController``, and every
field is compared with ``==``: no tolerance.
"""

import dataclasses
import json
import os
import pathlib
import sys

import numpy as np
import pytest

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "core"))

import golden_cases as gc  # noqa: E402
from repro.data import synthetic as ref_synthetic  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import MemoryController  # noqa: E402
from repro_torch.data import model_traces, synthetic  # noqa: E402

NAMES = sorted(gc.CASES) + sorted(gc.SERVING_CASES) \
    + sorted(gc.MODEL_TRACE_CASES)


def _port_config(config):
    return convert.config_from_dict(dataclasses.asdict(config))


def _closed_loop_record(res) -> dict:
    agg = res.as_channel_result()
    return {
        "n_requests": res.n_requests,
        "makespan_fpga_cycles": res.makespan_fpga_cycles,
        "dram_makespan_fpga_cycles": res.dram_makespan_fpga_cycles,
        "arbitration_cycles": res.arbitration_cycles,
        "cache_hit_rate": res.cache_hit_rate,
        "requests_per_channel": list(res.requests_per_channel),
        "breakdown": res.breakdown(),
        "row_hits": agg.row_hits,
        "row_conflicts": agg.row_conflicts,
        "first_accesses": agg.first_accesses,
        "stage_requests": {s.name: [s.in_requests, s.out_requests]
                           for s in res.stages},
    }


def _serving_workload(builder):
    """The serving case's workload from the port's arrival generators,
    with the seeds and sizes of ``golden_cases``' builders."""
    if builder is gc._poisson_serving:
        rng = np.random.default_rng(3)
        rows = gc._powerlaw_rows(rng, gc.N_SERVING, 8192)
        rw = (rng.random(gc.N_SERVING) < 0.1).astype(np.int32)
        arr = synthetic.poisson_arrivals(rng, gc.N_SERVING, 0.05)
        return rows, rw, None, arr
    assert builder is gc._hog_victim_serving
    return synthetic.hog_victim_workload(
        np.random.default_rng(4), n_victim=600, n_hog=2400,
        victim_rate=0.01, hog_rate=0.12)


def _serving_record(name: str) -> dict:
    config, workload, arb_policy, weights = gc.SERVING_CASES[name]
    rows, rw, pe, arr = _serving_workload(workload)
    for got, want in zip((rows, rw, pe, arr), workload()):
        assert (got is None and want is None) or np.array_equal(got, want)
    res = MemoryController(_port_config(config)).simulate(
        pe, rows, rw, gc.ROW_BYTES, arbiter_policy=arb_policy,
        weights=weights, arrival_cycle=arr)
    agg = res.as_channel_result()
    s = res.serving
    rec = {
        "n_requests": res.n_requests,
        "makespan_fpga_cycles": res.makespan_fpga_cycles,
        "dram_makespan_fpga_cycles": res.dram_makespan_fpga_cycles,
        "row_hits": agg.row_hits,
        "row_conflicts": agg.row_conflicts,
        "first_accesses": agg.first_accesses,
        "p50_sojourn": s.p50_sojourn,
        "p95_sojourn": s.p95_sojourn,
        "p99_sojourn": s.p99_sojourn,
        "mean_sojourn": s.mean_sojourn,
        "worst_sojourn": s.worst_sojourn,
        "sustained_req_per_cycle": s.sustained_req_per_cycle,
        "offered_req_per_cycle": s.offered_req_per_cycle,
        "idle_fpga_cycles": s.idle_fpga_cycles,
        "per_tenant": {str(p): rec for p, rec in s.per_port.items()},
        "stage_requests": {st.name: [st.in_requests, st.out_requests]
                           for st in res.stages},
    }
    if res.fault is not None:
        rec["fault"] = res.fault.as_dict()
        rec["n_dropped_requests"] = int(res.dropped.sum())
    return rec


def _model_trace_record(name: str) -> dict:
    arch = gc.MODEL_TRACE_CASES[name]
    assert model_traces.FAMILY_REPRESENTATIVE[name.removeprefix(
        "model_trace_")] == arch
    cap = model_traces.load_pinned_trace(arch)
    config = _port_config(gc.PAPER_COMBINED_CONFIG)
    pe, rows, rw = cap.replay_arrays(config.num_pes)
    res = MemoryController(config).simulate(
        pe, rows, rw, model_traces.REPLAY_ROW_BYTES)
    rec = _closed_loop_record(res)
    rec["arch"] = arch
    rec["op_counts"] = cap.op_counts()
    return rec


def port_golden_record(name: str) -> dict:
    """``golden_cases.golden_record`` on the port's controller."""
    if name in gc.SERVING_CASES:
        return _serving_record(name)
    if name in gc.MODEL_TRACE_CASES:
        return _model_trace_record(name)
    config, trace, multiport = gc.CASES[name]
    rows, rw = trace()
    pe = None
    if multiport:
        pe = np.random.default_rng(2).integers(0, config.num_pes,
                                               rows.shape[0])
    res = MemoryController(_port_config(config)).simulate(
        pe, rows, rw, gc.ROW_BYTES)
    return _closed_loop_record(res)


def test_eighteen_cases():
    assert len(NAMES) == 18
    on_disk = {f[:-5] for f in os.listdir(gc.GOLDEN_DIR)
               if f.endswith(".json")}
    assert on_disk == set(NAMES)


@pytest.mark.parametrize("name", NAMES)
def test_port_reproduces_golden(name):
    with open(os.path.join(gc.GOLDEN_DIR, f"{name}.json")) as f:
        golden = json.load(f)
    got = port_golden_record(name)
    assert sorted(golden) == sorted(got)
    for key in sorted(golden):
        assert golden[key] == got[key], (name, key, golden[key], got[key])


def test_pinned_trace_paths_are_the_references():
    """The port reads the same trace files, and its registry gives the
    same families."""
    from repro.data import model_traces as ref_mt
    assert model_traces.TRACE_DIR == ref_mt.TRACE_DIR
    assert model_traces.arch_families() == ref_mt.arch_families()
    assert model_traces.FAMILY_REPRESENTATIVE == ref_mt.FAMILY_REPRESENTATIVE
    assert model_traces.REPLAY_ROW_BYTES == ref_mt.REPLAY_ROW_BYTES
    for arch in model_traces.FAMILY_REPRESENTATIVE.values():
        assert model_traces.pinned_trace_path(arch) \
            == ref_mt.pinned_trace_path(arch)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("process", ["poisson", "bursty", "diurnal"])
def test_arrival_generators_match_the_reference(process, seed):
    fn, ref_fn = (getattr(synthetic, f"{process}_arrivals"),
                  getattr(ref_synthetic, f"{process}_arrivals"))
    got = fn(np.random.default_rng(seed), 257, 0.03)
    want = ref_fn(np.random.default_rng(seed), 257, 0.03)
    assert got.dtype == want.dtype and np.array_equal(got, want)
