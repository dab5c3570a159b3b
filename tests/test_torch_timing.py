"""Parity of the port's modeled-timing core (``repro_torch.core.timing`` and
the numpy fast paths of ``repro_torch.core.trace_engine``) with the
reference's, on the same numpy inputs: every field of every result equal
with ``==`` (arrays by value and dtype), no tolerance. In the port, each
fast path is also held to its own ``*_seq`` oracle. Inputs come from fixed
numpy seeds.
"""

import dataclasses

import numpy as np
import pytest

from repro.core import config as rcfg
from repro.core import timing as rt
from repro.core import trace_engine as rte
from repro_torch.core import config as pcfg
from repro_torch.core import timing as pt
from repro_torch.core import trace_engine as pte

TIMINGS = {"ddr4": (rt.DDR4_2400, pt.DDR4_2400),
           "hbm": (rt.HBM_V5E, pt.HBM_V5E)}

SCHEDS = {
    "fifo": dict(),
    "fifo_refresh": dict(t_rfc=160, t_refi=3000),
    "frfcfs8": dict(policy="frfcfs", reorder_window=8),
    "frfcfs32_refresh": dict(policy="frfcfs", reorder_window=32,
                             t_rfc=420, t_refi=9363),
    "cap16": dict(policy="frfcfs_cap", reorder_window=16, starvation_cap=4),
    "cap32_refresh": dict(policy="frfcfs_cap", reorder_window=32,
                          starvation_cap=8, t_rfc=160, t_refi=4000),
}

FAULTS = {
    "storm": dict(seed=2, transient_ber=0.01, weak_row_fraction=0.02,
                  weak_row_ber=0.5, due_fraction=0.3, max_replays=3,
                  backoff_clocks=64, row_retire_threshold=2,
                  refresh_escalate_threshold=25,
                  outage_windows=((0, 2000, 5000),)),
    "no_ecc_crc": dict(seed=5, transient_ber=0.03, ecc="none",
                       write_crc=False, max_replays=1, backoff_clocks=8),
    "drops": dict(seed=1, transient_ber=0.08, due_fraction=1.0,
                  weak_row_fraction=0.1, weak_row_ber=1.0, max_replays=2,
                  backoff_clocks=8, refresh_escalate_threshold=10,
                  refresh_escalate_max=2),
    "inactive": dict(seed=9),
}


def both(name, **kw):
    """The same config built in the reference's and the port's class."""
    return getattr(rcfg, name)(**kw), getattr(pcfg, name)(**kw)


def assert_same(a, b, where="result", *, strict=True):
    """Field for field with ``==``; arrays by dtype and value. ``strict``
    also holds each scalar's type (the port against the reference's same
    function); a fast path and its oracle may give a python float where
    the other gives a numpy one, as in the reference."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, where
        for f in dataclasses.fields(a):
            assert_same(getattr(a, f.name), getattr(b, f.name),
                        f"{where}.{f.name}", strict=strict)
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), where
        assert a.dtype == b.dtype and a.shape == b.shape, where
        assert np.array_equal(a, b), where
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            assert_same(a[k], b[k], f"{where}[{k!r}]", strict=strict)
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}[{i}]", strict=strict)
    else:
        assert not strict or type(a) is type(b), (where, a, b)
        assert a == b, (where, a, b)


def _addrs(seed, n, timings, n_rows=512):
    """Zipf-shaped rows with in-row offsets, ~20% writes."""
    rng = np.random.default_rng(seed)
    u = np.clip(rng.random(n), 1e-12, 1.0)
    rows = (np.floor(np.minimum(u ** (-1.0 / 0.3), 2.0 ** 40))
            .astype(np.int64) - 1) % n_rows
    cols = rng.integers(0, timings.row_bytes // 64, n) * 64
    rw = (rng.random(n) < 0.2).astype(np.int32)
    return rows * timings.row_bytes + cols, rw


def _serving(seed, n, timings, ports):
    addrs, rw = _addrs(seed, n, timings)
    rng = np.random.default_rng(seed + 100)
    arr = np.cumsum(-np.log1p(-rng.random(n)) / 0.04)
    pe = None if ports == 1 else rng.integers(0, ports, n)
    return addrs, rw, arr, pe


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_analytic_model(seed):
    rng = np.random.default_rng(seed)
    for b in (0, 1, 7, 32, 64, 1000):
        assert pt.t_schedule(b) == rt.t_schedule(b)
        assert pt.t_overlapped_schedule(b, 5, 1234.5) \
            == rt.t_overlapped_schedule(b, 5, 1234.5)
    ref_cfg = rcfg.PAPER_EVAL_CONFIG
    port_cfg = pcfg.PAPER_EVAL_CONFIG
    hits = rng.random(300) < 0.4
    t_mem = pt.DDR4_2400.t_mem_rand()
    assert pt.t_cache_trace(port_cfg, hits, t_mem) \
        == rt.t_cache_trace(ref_cfg, hits, t_mem)
    seq = rng.random(300) < 0.6
    ch = rng.integers(0, 4, 300)
    for ids in (None, ch):
        assert pt.t_dma_transfer(port_cfg, 300, seq, pt.DDR4_2400,
                                 channel_ids=ids) \
            == rt.t_dma_transfer(ref_cfg, 300, seq, rt.DDR4_2400,
                                 channel_ids=ids)
    res = rt.SimResult(float(rng.integers(1, 10 ** 6)), 1, 2, 3)
    port_res = pt.SimResult(res.total_fpga_cycles, 1, 2, 3)
    assert pt.modeled_bandwidth_gbps(port_res, 1 << 20) \
        == rt.modeled_bandwidth_gbps(res, 1 << 20)
    flops, hbm, coll = rng.random(3) * 1e12
    assert pt.roofline_time_s(flops, hbm, coll, chips=4) \
        == rt.roofline_time_s(flops, hbm, coll, chips=4)
    assert pt.SERVING_ARB_POLICIES == rt.SERVING_ARB_POLICIES


@pytest.mark.parametrize("timings", sorted(TIMINGS))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_simulate_dram_access(seed, timings):
    r_t, p_t = TIMINGS[timings]
    addrs, rw = _addrs(seed, 2000, p_t)
    for kw in ({}, {"rw": rw}, {"burst_bytes": 128}):
        assert_same(pt.simulate_dram_access(addrs, p_t, **kw),
                    rt.simulate_dram_access(addrs, r_t, **kw))
    assert pt.turnaround_cycles(rw, p_t) == rt.turnaround_cycles(rw, r_t)
    assert_same(pt.simulate_dram_access(addrs[:0], p_t),
                rt.simulate_dram_access(addrs[:0], r_t))


@pytest.mark.parametrize("window", [1, 4, 16])
@pytest.mark.parametrize("seed", [0, 1])
def test_windowed_matches_oracle_and_reference(seed, window):
    addrs, _ = _addrs(seed, 1500, pt.DDR4_2400)
    fast = pt.simulate_dram_access_windowed(addrs, pt.DDR4_2400, window)
    assert_same(fast, pt.simulate_dram_access_windowed_seq(
        addrs, pt.DDR4_2400, window), strict=False)
    assert_same(fast, rt.simulate_dram_access_windowed(
        addrs, rt.DDR4_2400, window))


@pytest.mark.parametrize("rw", [False, True])
@pytest.mark.parametrize("sched", sorted(SCHEDS))
@pytest.mark.parametrize("seed", [0, 1])
def test_dram_sched_matches_oracle_and_reference(seed, sched, rw):
    addrs, rw_arr = _addrs(seed, 1200, pt.DDR4_2400)
    rw_arr = rw_arr if rw else None
    r_s, p_s = both("DRAMSchedConfig", **SCHEDS[sched])
    got = pt.simulate_dram_sched(addrs, pt.DDR4_2400, p_s, rw_arr)
    assert_same(got, pt.simulate_dram_sched_seq(addrs, pt.DDR4_2400, p_s,
                                                rw_arr),
                strict=False)
    fast = pte.simulate_dram_sched_fast(addrs, pt.DDR4_2400, p_s, rw_arr)
    assert_same(got, fast, strict=False)
    assert_same(got, rt.simulate_dram_sched(addrs, rt.DDR4_2400, r_s,
                                            rw_arr))
    assert_same(fast, rte.simulate_dram_sched_fast(addrs, rt.DDR4_2400, r_s,
                                                   rw_arr))


@pytest.mark.parametrize("ports,policy,weights", [
    (1, "round_robin", None), (3, "round_robin", None),
    (3, "priority", None), (2, "weighted", (4, 1))])
@pytest.mark.parametrize("sched", ["fifo_refresh", "frfcfs8",
                                   "cap32_refresh"])
@pytest.mark.parametrize("seed", [0, 1])
def test_arrivals_match_oracle_and_reference(seed, sched, ports, policy,
                                             weights):
    addrs, rw, arr, pe = _serving(seed, 900, pt.DDR4_2400, ports)
    r_s, p_s = both("DRAMSchedConfig", **SCHEDS[sched])
    kw = dict(arrival_fpga=arr, pe_id=pe,
              num_ports=None if ports == 1 else ports, arb_policy=policy,
              weights=weights)
    got = pt.simulate_arrivals(addrs, pt.DDR4_2400, p_s, rw, **kw)
    assert_same(got, pt.simulate_arrivals_seq(addrs, pt.DDR4_2400, p_s, rw,
                                              **kw),
                strict=False)
    assert_same(got, pte.simulate_arrivals_fast(addrs, pt.DDR4_2400, p_s,
                                                rw, **kw),
                strict=False)
    assert_same(got, rt.simulate_arrivals(addrs, rt.DDR4_2400, r_s, rw,
                                          **kw))


@pytest.mark.parametrize("ports", [1, 2])
@pytest.mark.parametrize("faults", sorted(FAULTS))
@pytest.mark.parametrize("seed", [0, 1])
def test_faults_match_oracle_and_reference(seed, faults, ports):
    addrs, rw, arr, pe = _serving(seed, 800, pt.DDR4_2400, ports)
    r_s, p_s = both("DRAMSchedConfig", policy="frfcfs_cap",
                    reorder_window=16, starvation_cap=8, t_rfc=160,
                    t_refi=4000)
    r_f, p_f = both("FaultConfig", **FAULTS[faults])
    kw = dict(channel=seed, arrival_fpga=arr, pe_id=pe,
              num_ports=None if ports == 1 else ports,
              arb_policy="weighted" if ports > 1 else "round_robin",
              weights=(3, 1) if ports > 1 else None)
    got = pt.simulate_faults(addrs, pt.DDR4_2400, p_s, rw, faults=p_f, **kw)
    assert_same(got, pt.simulate_faults_seq(addrs, pt.DDR4_2400, p_s, rw,
                                            faults=p_f, **kw),
                strict=False)
    if p_f.injects:
        assert_same(got, pte.simulate_faults_fast(addrs, pt.DDR4_2400, p_s,
                                                  rw, faults=p_f, **kw),
                strict=False)
    assert_same(got, rt.simulate_faults(addrs, rt.DDR4_2400, r_s, rw,
                                        faults=r_f, **kw))


def test_refresh_quirk_is_copied():
    """ROADMAP C7: a refresh turns the second access from a row conflict
    into a first access, so refresh makes this trace cheaper. The port
    copies the reference's behaviour and value."""
    addrs = np.asarray([0, 32], np.int64) * (pt.DDR4_2400.row_bytes // 2)
    rw = np.zeros(2, np.int32)
    p_s = pcfg.DRAMSchedConfig(reorder_window=8, t_rfc=5, t_refi=37)
    r_s = rcfg.DRAMSchedConfig(reorder_window=8, t_rfc=5, t_refi=37)
    for engine in ("auto", "sequential"):
        got = pt.simulate_dram_sched(addrs, pt.DDR4_2400, p_s, rw,
                                     engine=engine)
        assert got.total_fpga_cycles == 20.243924392439244
        assert_same(got, rt.simulate_dram_sched(addrs, rt.DDR4_2400, r_s,
                                                rw, engine=engine))
    base = pt.simulate_dram_sched(addrs, pt.DDR4_2400,
                                  pcfg.DRAMSchedConfig(reorder_window=8), rw)
    assert base.total_fpga_cycles == 23.243024302430243


@pytest.mark.parametrize("call", [
    "dram_sched", "dram_sched_seq", "arrivals", "arrivals_seq", "faults",
    "faults_seq"])
def test_trace_waits_for_telemetry(call):
    """Tracing, which this test once found refused, is ported: each entry
    point with a ``ChannelTrace`` gives the untraced result and the same
    event stream as the reference's with ``==``."""
    from repro.core.telemetry import ChannelTrace as RTrace
    from repro_torch.core.telemetry import ChannelTrace
    addrs = np.arange(8, dtype=np.int64) * 4096
    sched = dict(policy="frfcfs", reorder_window=4)
    kw = dict(faults=pcfg.FaultConfig(seed=1, transient_ber=0.1)) \
        if call.startswith("faults") else {}
    rkw = dict(faults=rcfg.FaultConfig(seed=1, transient_ber=0.1)) \
        if kw else {}
    fn = getattr(pt, f"simulate_{call}")
    got_trace, want_trace = ChannelTrace(), RTrace()
    got = fn(addrs, pt.DDR4_2400, pcfg.DRAMSchedConfig(**sched),
             trace=got_trace, **kw)
    assert_same(got, fn(addrs, pt.DDR4_2400, pcfg.DRAMSchedConfig(**sched),
                         **kw))
    assert_same(got, getattr(rt, f"simulate_{call}")(
        addrs, rt.DDR4_2400, rcfg.DRAMSchedConfig(**sched),
        trace=want_trace, **rkw))
    assert got_trace.events and got_trace.events == want_trace.events