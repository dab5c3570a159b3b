"""Fig. 7 and its write extension on the port's simulator.

``chip_smoke.py`` carries a copy of the method of
``benchmarks/fig7_workloads.py`` and ``benchmarks/fig7_write_workloads.py``
(which import the reference package) onto the port; its ``simulate``
phase runs it on the card's machine. Here, on the CPU: the copied trace
builders draw what the benchmarks' draw (their Zipf draws through
``zipf_draws``, numpy 2.0's ``Generator.zipf`` stream, which later numpy
releases do not keep), and the records equal ``BENCH_fig7.json`` and
``BENCH_fig7_write.json`` field for field.
"""

import json
import pathlib
import sys

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from benchmarks import fig7_workloads, fig7_write_workloads  # noqa: E402


@pytest.fixture(scope="module")
def records():
    return chip_smoke.fig7_records()


@pytest.mark.parametrize("which,name", [(0, "BENCH_fig7.json"),
                                        (1, "BENCH_fig7_write.json")])
def test_records_equal_the_bench_files(records, which, name):
    with open(ROOT / name) as f:
        assert records[which] == json.load(f)


def test_fig7_headline_numbers(records):
    fig7, fig7w = records
    gcn, cnn = (fig7["workloads"][k]
                for k in ("gcn_inference", "cnn_inference"))
    assert (gcn["controller_cycles"], gcn["baseline_mig_cycles"]) \
        == (1413646, 1989713)
    assert (cnn["controller_cycles"], cnn["baseline_mig_cycles"]) \
        == (394075, 751341)
    eg, kv = (fig7w["workloads"][k] for k in ("embedding_grad", "kv_append"))
    assert (eg["on_cycles"], eg["off_cycles"]) == (310220, 336925)
    assert (kv["on_cycles"], kv["off_cycles"]) == (500355, 553126)


@pytest.mark.parametrize("a", [1.2, 1.3, 2.5])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_zipf_draws_are_numpy_2_0s(seed, a):
    """``chip_smoke.zipf_draws`` draws numpy 2.0's ``Generator.zipf``
    stream (the numpy that wrote the BENCH files), and leaves the
    generator where ``zipf`` leaves it."""
    got_rng, want_rng = (np.random.default_rng(seed),
                         np.random.default_rng(seed))
    got = chip_smoke.zipf_draws(got_rng, a, 5000)
    want = want_rng.zipf(a, 5000)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert got_rng.random() == want_rng.random()


@pytest.mark.parametrize("seed", [0, 1])
def test_trace_builders_are_the_benchmarks(seed):
    pairs = [(chip_smoke.fig7_gcn_trace, fig7_workloads.gcn_trace),
             (chip_smoke.fig7_cnn_trace, fig7_workloads.cnn_trace),
             (chip_smoke.fig7w_embedding_grad_trace,
              fig7_write_workloads.embedding_grad_trace),
             (chip_smoke.fig7w_kv_append_trace,
              fig7_write_workloads.kv_append_trace)]
    for port_fn, ref_fn in pairs:
        got = port_fn(np.random.default_rng(seed))
        want = ref_fn(np.random.default_rng(seed))
        for a, b in zip(got, want):
            assert np.array_equal(a, b) and np.asarray(a).dtype \
                == np.asarray(b).dtype


def test_workload_records_match_the_reference_method(capsys):
    """The port's method against the reference's on the same small
    traces (the benchmarks' functions print their CSV line)."""
    rng = np.random.default_rng(7)
    adj, feat, fb = fig7_workloads.gcn_trace(rng)
    adj, feat = adj[:6000], feat[:400]
    assert chip_smoke.fig7_workload(adj, feat, fb) \
        == fig7_workloads.run_workload("gcn", adj, feat, fb)
    addrs, rw = fig7_write_workloads.embedding_grad_trace(rng,
                                                          n_tokens=3000)
    assert chip_smoke.fig7w_workload(addrs, rw) \
        == fig7_write_workloads.run_workload("eg", addrs, rw)
