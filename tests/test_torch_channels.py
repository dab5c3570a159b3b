"""Parity of the port's multi-port, multi-channel front end
(``repro_torch.core.channels``) and RAS primitives
(``repro_torch.core.faults``) with the reference's, on the same numpy
inputs from fixed seeds: every field equal with ``==``, no tolerance. In
the port, each fast composition is also held to its request-at-a-time
oracle (``use_seq_oracle=True`` / ``*_seq``).
"""

import numpy as np
import pytest

from repro.core import channels as rch
from repro.core import faults as rf
from repro.core import timing as rt
from repro_torch.core import channels as pch
from repro_torch.core import faults as pf
from repro_torch.core import timing as pt
from test_torch_timing import FAULTS, SCHEDS, assert_same, both

MAPS = [(1, "row_interleave", ()), (2, "block_interleave", ()),
        (4, "xor", ()), (8, "row_interleave", ()),
        (4, "block_interleave", (1,)), (8, "xor", (0, 5))]


def _trace(seed, n=1500, n_rows=4096, ports=4):
    rng = np.random.default_rng(seed)
    u = np.clip(rng.random(n), 1e-12, 1.0)
    rows = (np.floor(np.minimum(u ** (-1.0 / 0.25), 2.0 ** 40))
            .astype(np.int64) - 1) % n_rows
    addrs = rows * 4096 + rng.integers(0, 64, n) * 64
    rw = (rng.random(n) < 0.25).astype(np.int32)
    pe = rng.integers(0, ports, n)
    arr = np.cumsum(-np.log1p(-rng.random(n)) / 0.05)
    return addrs, rw, pe, arr


def _maps(channels, policy, failed):
    r_c, p_c = both("ChannelConfig", num_channels=channels, policy=policy)
    r_f, p_f = both("FaultConfig", failed_channels=failed) if failed \
        else (None, None)
    return (rch.AddressMap(r_c, rt.DDR4_2400, r_f),
            pch.AddressMap(p_c, pt.DDR4_2400, p_f))


@pytest.mark.parametrize("channels,policy,failed", MAPS)
@pytest.mark.parametrize("seed", [0, 1])
def test_address_map(seed, channels, policy, failed):
    ref, port = _maps(channels, policy, failed)
    addrs = _trace(seed)[0]
    assert port.granularity == ref.granularity
    assert port.failed_channels == ref.failed_channels
    assert port.surviving_channels == ref.surviving_channels
    ch, local = port.channel_of(addrs), port.local_addr(addrs)
    assert_same(ch, ref.channel_of(addrs))
    assert_same(local, ref.local_addr(addrs))
    assert_same(port.global_addr(ch, local), ref.global_addr(ch, local))
    assert np.array_equal(port.global_addr(ch, local), addrs)
    for got, want in zip(port.decompose(addrs), ref.decompose(addrs)):
        assert_same(got, want)


@pytest.mark.parametrize("ports,policy,weights", [
    (1, "round_robin", None), (4, "round_robin", None),
    (4, "priority", None), (3, "weighted", (5, 2, 1))])
@pytest.mark.parametrize("seed", [0, 1])
def test_arbiter(seed, ports, policy, weights):
    pe = _trace(seed, ports=ports)[2]
    kw = dict(num_ports=ports, policy=policy, weights=weights)
    got = pch.arbitrate_ports(pe, **kw)
    assert_same(got, pch.arbitrate_ports_seq(pe, **kw), strict=False)
    assert_same(got, rch.arbitrate_ports(pe, **kw))
    assert pch.arbiter_fill_cycles(ports) == rch.arbiter_fill_cycles(ports)
    addrs = _trace(seed)[0]
    assert pch.per_port_order_preserved(pe, addrs, **kw) \
        == rch.per_port_order_preserved(pe, addrs, **kw)


@pytest.mark.parametrize("sched", [None, "frfcfs8", "cap32_refresh"])
@pytest.mark.parametrize("channels,policy,failed", MAPS[:4])
def test_simulate_channels(channels, policy, failed, sched):
    addrs, rw, _, _ = _trace(channels)
    r_c, p_c = both("ChannelConfig", num_channels=channels, policy=policy)
    r_s, p_s = both("DRAMSchedConfig", **SCHEDS[sched]) if sched \
        else (None, None)
    for rw_k in (None, rw):
        got = pch.simulate_channels(addrs, pt.DDR4_2400, p_c, rw_k, p_s)
        assert_same(got, pch.simulate_channels_seq(addrs, pt.DDR4_2400, p_c,
                                                   rw_k, p_s), strict=False)
        assert_same(got, rch.simulate_channels(addrs, rt.DDR4_2400, r_c,
                                               rw_k, r_s))


@pytest.mark.parametrize("coalesce", [False, True])
@pytest.mark.parametrize("sched", [None, "frfcfs32_refresh"])
@pytest.mark.parametrize("channels", [1, 4])
def test_schedule_and_simulate_channels(channels, sched, coalesce):
    addrs, rw, _, _ = _trace(channels + 10)
    r_c, p_c = both("ChannelConfig", num_channels=channels, policy="xor")
    r_b, p_b = both("SchedulerConfig", batch_size=32)
    r_s, p_s = both("DRAMSchedConfig", **SCHEDS[sched]) if sched \
        else (None, None)
    kw = dict(coalesce_writes=coalesce)
    got = pch.schedule_and_simulate_channels(
        addrs, rw, sched_config=p_b, timings=pt.DDR4_2400, channel_cfg=p_c,
        dram_sched=p_s, **kw)
    assert_same(got, pch.schedule_and_simulate_channels(
        addrs, rw, sched_config=p_b, timings=pt.DDR4_2400, channel_cfg=p_c,
        dram_sched=p_s, use_seq_oracle=True, **kw), strict=False)
    assert_same(got, rch.schedule_and_simulate_channels(
        addrs, rw, sched_config=r_b, timings=rt.DDR4_2400, channel_cfg=r_c,
        dram_sched=r_s, **kw))


@pytest.mark.parametrize("policy,weights", [
    ("round_robin", None), ("priority", None), ("weighted", (3, 1, 1, 2))])
@pytest.mark.parametrize("channels", [1, 2])
def test_simulate_multiport_channels(channels, policy, weights):
    addrs, rw, pe, _ = _trace(channels + 20)
    r_c, p_c = both("ChannelConfig", num_channels=channels)
    r_b, p_b = both("SchedulerConfig", batch_size=64)
    kw = dict(num_ports=4, policy=policy, weights=weights,
              coalesce_writes=True)
    got = pch.simulate_multiport_channels(
        pe, addrs, rw, timings=pt.DDR4_2400, channel_cfg=p_c,
        sched_config=p_b, **kw)
    assert_same(got, pch.simulate_multiport_channels(
        pe, addrs, rw, timings=pt.DDR4_2400, channel_cfg=p_c,
        sched_config=p_b, use_seq_oracle=True, **kw), strict=False)
    assert_same(got, rch.simulate_multiport_channels(
        pe, addrs, rw, timings=rt.DDR4_2400, channel_cfg=r_c,
        sched_config=r_b, **kw))


@pytest.mark.parametrize("faults", [None, "storm", "drops"])
@pytest.mark.parametrize("ports", [1, 3])
@pytest.mark.parametrize("channels", [1, 2])
def test_simulate_serving_channels(channels, ports, faults):
    addrs, rw, pe, arr = _trace(channels + ports, n=900, ports=ports)
    r_c, p_c = both("ChannelConfig", num_channels=channels)
    r_s, p_s = both("DRAMSchedConfig", **SCHEDS["cap32_refresh"])
    r_f, p_f = both("FaultConfig", **FAULTS[faults]) if faults \
        else (None, None)
    kw = dict(pe_id=pe if ports > 1 else None,
              num_ports=ports if ports > 1 else None, policy="round_robin")
    got = pch.simulate_serving_channels(
        addrs, arr, rw, timings=pt.DDR4_2400, channel_cfg=p_c,
        dram_sched=p_s, faults=p_f, **kw)
    assert_same(got, pch.simulate_serving_channels(
        addrs, arr, rw, timings=pt.DDR4_2400, channel_cfg=p_c,
        dram_sched=p_s, faults=p_f, use_seq_oracle=True, **kw),
        strict=False)
    assert_same(got, rch.simulate_serving_channels(
        addrs, arr, rw, timings=rt.DDR4_2400, channel_cfg=r_c,
        dram_sched=r_s, faults=r_f, **kw))
    # Traced: the same result, and each channel's events equal to the
    # reference's.
    from repro.core.telemetry import TraceRecorder as RRec
    from repro_torch.core.telemetry import TraceRecorder
    rec, rrec = TraceRecorder(), RRec()
    assert_same(pch.simulate_serving_channels(
        addrs, arr, rw, timings=pt.DDR4_2400, channel_cfg=p_c,
        dram_sched=p_s, faults=p_f, trace=rec, **kw), got)
    rch.simulate_serving_channels(
        addrs, arr, rw, timings=rt.DDR4_2400, channel_cfg=r_c,
        dram_sched=r_s, faults=r_f, trace=rrec, **kw)
    assert rec.channels.keys() == rrec.channels.keys()
    for k, ct in rec.channels.items():
        assert ct.events == rrec.channels[k].events, k


@pytest.mark.parametrize("faults", ["storm", "no_ecc_crc", "drops"])
@pytest.mark.parametrize("channel", [0, 3])
def test_fault_draws(faults, channel):
    r_f, p_f = both("FaultConfig", **FAULTS[faults])
    idx = np.arange(0, 5000, 7, dtype=np.int64)
    rows = np.concatenate([np.arange(0, 4000, 3, dtype=np.int64),
                           [pf.SPARE_ROW_BASE + 5]])
    for att in (1, 2, 5):
        got = pf.error_uniforms(p_f, channel, idx, att)
        assert_same(got, rf.error_uniforms(r_f, channel, idx, att))
        assert [pf.error_uniform(p_f, channel, int(i), att)
                for i in idx[:50]] == got[:50].tolist()
    flags = pf.weak_rows(p_f, channel, rows)
    assert_same(flags, rf.weak_rows(r_f, channel, rows))
    assert [pf.weak_row(p_f, channel, int(r)) for r in rows[:60]] \
        == flags[:60].tolist()
    for weak in (False, True):
        assert pf.error_prob(p_f, weak) == rf.error_prob(r_f, weak)
    assert (pf.SPARE_ROW_BASE, pf.REMAP_LOCAL_BASE) \
        == (rf.SPARE_ROW_BASE, rf.REMAP_LOCAL_BASE)


def test_fault_stats_combine():
    a = dict(n_injected=3, n_corrected=1, n_uncorrectable=2, n_replays=2,
             outage_dram_cycles=12.5, rows_retired=((0, 7),),
             dropped_by_port={0: 1})
    b = dict(n_injected=5, n_silent=1, n_dropped=2, spare_issues=4,
             refresh_escalations=1, rows_retired=((1, 9),),
             dropped_by_port={0: 2, 1: 1})
    got = pf.FaultStats(**a).combine(pf.FaultStats(**b))
    want = rf.FaultStats(**a).combine(rf.FaultStats(**b))
    assert_same(got, want)
    assert got.as_dict() == want.as_dict()
    assert got.degraded == want.degraded
