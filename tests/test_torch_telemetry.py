"""Port parity for lifecycle tracing: ``repro_torch.core.telemetry``,
``repro_torch.launch.tracing`` and the ``python -m repro_torch.trace``
CLI against ``repro.core.telemetry``, ``repro.launch.tracing`` and
``repro.trace``, on the same numpy inputs.

Held with ``==``, no tolerance: each fast path's reconstructed event
stream against the port's own oracle and against the reference's stream
(sched, arrival and fault replays); over the 18 pinned goldens a traced
run against the golden record (which the untraced run reproduces,
``test_torch_goldens.py``) and its recorded events against the
reference's traced run; the cycle attribution's exact-sum identity and
its arrays; the Chrome trace object.
"""

import json
import pathlib
import sys

import numpy as np
import pytest

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "core"))

import golden_cases as gc  # noqa: E402
import test_torch_goldens as tg  # noqa: E402
from repro.core import controller as rcontroller  # noqa: E402
from repro.core import telemetry as rtel  # noqa: E402
from repro.core import timing as rt  # noqa: E402
from repro.launch import tracing as rtracing  # noqa: E402
from repro_torch.core import MemoryController  # noqa: E402
from repro_torch.core import config as pcfg  # noqa: E402
from repro_torch.core import telemetry as ptel  # noqa: E402
from repro_torch.core import timing as pt  # noqa: E402
from repro_torch.launch import tracing  # noqa: E402
from test_torch_timing import both  # noqa: E402

SCHED_CASES = [("fifo", 1, 16, 0, 0), ("fifo", 1, 16, 420, 9363),
               ("frfcfs", 16, 16, 0, 0), ("frfcfs", 16, 16, 420, 9363),
               ("frfcfs_cap", 32, 8, 420, 9363)]


def _addrs(rng, n, n_rows=256):
    rows = np.minimum((1.0 / np.clip(rng.random(n), 1e-9, 1.0)) ** 0.8,
                      n_rows - 1).astype(np.int64)
    return rows * pt.DDR4_2400.row_bytes


def _events_three_ways(name, addrs, rw, scheds, kwargs, rkwargs):
    """The port's oracle and fast path and the reference's fast path, each
    under a fresh ``ChannelTrace`` (``scheds``: the reference's config and
    the port's): equal results, and the three event streams returned."""
    seq_t, fast_t, ref_t = (ptel.ChannelTrace(), ptel.ChannelTrace(),
                            rtel.ChannelTrace())
    r_s, p_s = scheds
    fn = getattr(pt, name)
    seq = fn(addrs, pt.DDR4_2400, p_s, rw, engine="sequential",
             trace=seq_t, **kwargs)
    fast = fn(addrs, pt.DDR4_2400, p_s, rw, engine="fast", trace=fast_t,
              **kwargs)
    ref = getattr(rt, name)(addrs, rt.DDR4_2400, r_s, rw, engine="fast",
                            trace=ref_t, **rkwargs)
    assert seq.total_fpga_cycles == fast.total_fpga_cycles \
        == ref.total_fpga_cycles
    return seq_t.events, fast_t.events, ref_t.events


@pytest.mark.parametrize("policy,window,cap,t_rfc,t_refi", SCHED_CASES)
def test_sched_events_match_oracle_and_reference(policy, window, cap, t_rfc,
                                                 t_refi):
    rng = np.random.default_rng(17)
    addrs = _addrs(rng, 1500)
    rw = (rng.random(1500) < 0.3).astype(np.int32)
    kw = dict(policy=policy, reorder_window=window, starvation_cap=cap,
              t_rfc=t_rfc, t_refi=t_refi)
    seq_ev, fast_ev, ref_ev = _events_three_ways(
        "simulate_dram_sched", addrs, rw, both("DRAMSchedConfig", **kw), {},
        {})
    assert seq_ev == fast_ev == ref_ev
    assert any(e[0] == "issue" for e in seq_ev)
    if t_refi:
        assert any(e[0] == "refresh" for e in seq_ev)


@pytest.mark.parametrize("num_ports,arb,weights,rate", [
    (None, "round_robin", None, 0.05), (1, "round_robin", None, 0.02),
    (3, "round_robin", None, 0.05), (3, "weighted", (4, 1, 1), 0.05),
    (3, "priority", None, 0.08)])
def test_arrival_events_match_oracle_and_reference(num_ports, arb, weights,
                                                   rate):
    rng = np.random.default_rng(23)
    n = 1200
    addrs = _addrs(rng, n)
    rw = (rng.random(n) < 0.2).astype(np.int32)
    arr = np.cumsum(rng.exponential(1.0 / rate, n))
    pe = None if num_ports is None else rng.integers(0, num_ports, n)
    scheds = both("DRAMSchedConfig", policy="frfcfs", reorder_window=16,
                  t_rfc=420, t_refi=9363)
    kw = dict(arrival_fpga=arr, pe_id=pe, num_ports=num_ports,
              arb_policy=arb, weights=weights)
    seq_ev, fast_ev, ref_ev = _events_three_ways(
        "simulate_arrivals", addrs, rw, scheds, kw, kw)
    assert seq_ev == fast_ev == ref_ev
    assert {"grant", "issue", "complete"} <= {e[0] for e in seq_ev}


@pytest.mark.parametrize("fc", [
    dict(seed=11, transient_ber=0.004, weak_row_fraction=0.02,
         weak_row_ber=0.5, due_fraction=0.25, max_replays=4,
         backoff_clocks=32, row_retire_threshold=2,
         refresh_escalate_threshold=40),
    dict(seed=5, outage_windows=((0, 4000, 9000),)),
    dict(seed=3)])
def test_fault_events_match_oracle_and_reference(fc):
    rng = np.random.default_rng(31)
    n = 1200
    addrs = _addrs(rng, n)
    rw = (rng.random(n) < 0.2).astype(np.int32)
    arr = np.cumsum(rng.exponential(18.0, n))
    pe = rng.integers(0, 2, n)
    scheds = both("DRAMSchedConfig", policy="frfcfs_cap",
                  reorder_window=32, starvation_cap=8, t_rfc=420,
                  t_refi=9363)
    r_f, p_f = both("FaultConfig", **fc)
    kw = dict(channel=0, arrival_fpga=arr, pe_id=pe, num_ports=2,
              arb_policy="weighted", weights=(4, 1))
    seq_ev, fast_ev, ref_ev = _events_three_ways(
        "simulate_faults", addrs, rw, scheds, dict(kw, faults=p_f),
        dict(kw, faults=r_f))
    assert seq_ev == fast_ev == ref_ev
    if p_f.injects and p_f.transient_ber:
        assert any(e[0] == "replay" for e in seq_ev)
    if p_f.outage_windows:
        assert any(e[0] == "outage" for e in seq_ev)


def _traced(cls, recorders):
    """``cls`` (a ``MemoryController``) whose ``simulate`` records every
    call into a fresh ``TraceRecorder`` of its package, kept in
    ``recorders``."""
    recorder = ptel.TraceRecorder if cls is MemoryController \
        else rtel.TraceRecorder

    class Traced(cls):
        def simulate(self, *args, **kwargs):
            rec = recorder()
            recorders.append(rec)
            return super().simulate(*args, trace=rec, **kwargs)
    return Traced


def _same_events(got, want):
    assert got.stage_events == want.stage_events
    assert got.channels.keys() == want.channels.keys()
    for k, ct in got.channels.items():
        assert ct.events == want.channels[k].events, k
        assert (ct.req_ids is None) == (want.channels[k].req_ids is None)
        if ct.req_ids is not None:
            assert np.array_equal(ct.req_ids, want.channels[k].req_ids)
    for name in ("arrival_fpga", "pe_by_seq"):
        a, b = getattr(got, name), getattr(want, name)
        assert (a is None) == (b is None) and (a is None
                                               or np.array_equal(a, b))
    assert (got.pre_fpga, got.makespan_fpga, got.open_loop) \
        == (want.pre_fpga, want.makespan_fpga, want.open_loop)


@pytest.mark.parametrize("name", tg.NAMES)
def test_traced_golden_is_the_untraced_record(name, monkeypatch):
    """Each golden case run under a recorder gives the golden record field
    for field, and records the reference's event stream."""
    with open(pathlib.Path(gc.GOLDEN_DIR) / f"{name}.json") as f:
        golden = json.load(f)
    port_recs, ref_recs = [], []
    monkeypatch.setattr(tg, "MemoryController",
                        _traced(MemoryController, port_recs))
    got = tg.port_golden_record(name)
    assert sorted(golden) == sorted(got)
    for key in sorted(golden):
        assert golden[key] == got[key], (name, key)
    monkeypatch.setattr(gc, "MemoryController",
                        _traced(rcontroller.MemoryController, ref_recs))
    gc.golden_record(name)
    assert len(port_recs) == len(ref_recs) == 1
    assert port_recs[0].n_events > 0
    _same_events(port_recs[0], ref_recs[0])


def _serving_case(name, package):
    """A golden serving case run traced by ``package`` (the port or the
    reference); returns (result, recorder)."""
    config, workload, arb_policy, weights = gc.SERVING_CASES[name]
    rows, rw, pe, arr = workload()
    if package == "port":
        mc, rec = MemoryController(tg._port_config(config)), \
            ptel.TraceRecorder()
    else:
        mc, rec = rcontroller.MemoryController(config), rtel.TraceRecorder()
    res = mc.simulate(pe, rows, rw, gc.ROW_BYTES, arbiter_policy=arb_policy,
                      weights=weights, arrival_cycle=arr, trace=rec)
    return res, rec


@pytest.mark.parametrize("name", sorted(gc.SERVING_CASES))
def test_attribution_sums_exactly_and_matches_reference(name):
    res, rec = _serving_case(name, "port")
    att = ptel.CycleAttribution.from_pipeline(res, rec)
    assert att.n == res.n_requests
    assert np.array_equal(att.ltr_sum(), res.serving.sojourn_fpga_cycles)
    for k in ptel.COMPONENTS:
        lo = -1e-6 if k == "service" else 0.0
        assert (att.components[k] >= lo).all(), k
    ref = rtel.CycleAttribution.from_pipeline(*_serving_case(name, "ref"))
    assert att.components.keys() == ref.components.keys()
    for k, v in att.components.items():
        assert np.array_equal(v, ref.components[k]), k
    assert att.totals() == ref.totals()
    assert att.per_tenant() == ref.per_tenant()
    assert att.top_rows(5) == ref.top_rows(5)
    assert att.summary_text() == ref.summary_text()


def test_closed_loop_attribution_aggregate_view():
    config, trace_fn, _ = gc.CASES["frfcfs_cap_refresh_gcn"]
    rows, rw = trace_fn()
    rec = ptel.TraceRecorder()
    res = MemoryController(tg._port_config(config)).simulate(
        None, rows, rw, gc.ROW_BYTES, trace=rec)
    att = ptel.CycleAttribution.from_pipeline(res, rec)
    assert att.aggregate_totals is not None
    assert sum(att.totals().values()) == pytest.approx(
        res.makespan_fpga_cycles)
    assert att.totals()["refresh"] > 0
    assert "aggregate" in att.summary_text()


def _without_generator(obj):
    obj = json.loads(json.dumps(obj))
    obj["otherData"].pop("generator")
    return obj


@pytest.mark.parametrize("name", ["serving_hog_victim_weighted",
                                  "faults_ecc_storm"])
def test_chrome_trace_is_the_references(name, tmp_path):
    """The same JSON object as the reference's exporter gives, but for
    the ``generator`` field, which names each package's module; it
    validates, and writes to disk what it returns."""
    _, rec = _serving_case(name, "port")
    _, ref_rec = _serving_case(name, "ref")
    obj = tracing.to_chrome_trace(rec)
    assert obj["otherData"]["generator"] == "repro_torch.launch.tracing"
    assert _without_generator(obj) == _without_generator(
        rtracing.to_chrome_trace(ref_rec))
    path = tmp_path / "t.json"
    counts = tracing.write_chrome_trace(path, rec)
    assert counts["X"] > 0 and counts["C"] > 0 and counts["M"] > 0
    assert tracing.validate_chrome_trace(json.loads(path.read_text())) \
        == counts


def test_validator_rejects_malformed_traces():
    _, rec = _serving_case("serving_poisson_frfcfs", "port")
    obj = tracing.to_chrome_trace(rec)
    tracing.validate_chrome_trace(obj)
    with pytest.raises(ValueError):
        tracing.validate_chrome_trace({"no": "traceEvents"})
    bad = json.loads(json.dumps(obj))
    bad["traceEvents"][0]["ph"] = "Q"
    with pytest.raises(ValueError, match="phase"):
        tracing.validate_chrome_trace(bad)
    bad2 = json.loads(json.dumps(obj))
    next(e for e in bad2["traceEvents"] if e["ph"] == "X")["dur"] = -1.0
    with pytest.raises(ValueError, match="dur"):
        tracing.validate_chrome_trace(bad2)
    assert tracing.to_chrome_trace(rec, max_request_slices=100)[
        "otherData"]["request_slices_dropped"] > 0


@pytest.mark.parametrize("workload", ["poisson", "hog_victim"])
def test_trace_cli_on_a_json_config(workload, tmp_path, capsys):
    """``python -m repro_torch.trace`` on a JSON config writes the
    reference CLI's attribution rollup and a valid Chrome trace."""
    from repro.trace import main as ref_main
    from repro_torch.trace import main
    cfg = tmp_path / f"{workload}.json"
    cfg.write_text(json.dumps({"workload": workload, "n": 1500, "seed": 3,
                               "rate": 0.05, "num_pes": 2,
                               "arb": "weighted", "weights": [4, 1]}))
    outs = {}
    for who, fn in (("port", main), ("ref", ref_main)):
        out, attr = tmp_path / f"{who}.trace.json", tmp_path / f"{who}.a.json"
        assert fn([str(cfg), "--out", str(out), "--attr", str(attr),
                   "--validate"]) == 0
        outs[who] = (json.loads(out.read_text()),
                     json.loads(attr.read_text()), capsys.readouterr().out)
    assert "validated" in outs["port"][2]
    assert "cycle attribution" in outs["port"][2]
    tracing.validate_chrome_trace(outs["port"][0])
    assert _without_generator(outs["port"][0]) == \
        _without_generator(outs["ref"][0])
    assert outs["port"][1] == outs["ref"][1]
    assert set(outs["port"][1]["components_total"]) == set(ptel.COMPONENTS)


def test_trace_cli_refuses_a_golden_case_name(capsys):
    """C16: a golden case name is served by the reference's CLI only (the
    cases are built with the reference package); the port's CLI exits with
    a message that points to the JSON form."""
    from repro_torch.trace import main
    with pytest.raises(SystemExit, match="JSON config"):
        main(["serving_hog_victim_weighted"])


def test_forced_open_loop_zero_arrivals_offers_zero():
    """The port keeps the reference's closed-loop offered load: an
    all-zero-arrival stream forced open loop offers 0.0, not inf."""
    rng = np.random.default_rng(1)
    n = 400
    res = MemoryController(pcfg.MemoryControllerConfig()).simulate(
        None, rng.integers(0, 128, n), np.zeros(n, np.int32), gc.ROW_BYTES,
        arrival_cycle=np.zeros(n), open_loop=True,
        trace=ptel.TraceRecorder())
    assert res.serving.offered_req_per_cycle == 0.0
