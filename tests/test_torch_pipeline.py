"""Parity of the port's scheduler control plane, staged pipeline and
modeled-timing entry points (``MemoryController.simulate`` and the four
``modeled_*`` methods) with the reference's, over the paper presets and
the ``dram_sched`` and fault variants. The same numpy inputs from fixed
seeds go to both packages; every field is compared with ``==``, no
tolerance. The reference's configs are carried across with
``convert.config_from_dict``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import config as rcfg
from repro.core import scheduler as rsch
from repro.core import timing as rt
from repro.core.controller import MemoryController as RefController
from repro_torch import convert
from repro_torch.core import config as pcfg
from repro_torch.core import pipeline as ppl
from repro_torch.core import scheduler as psch
from repro_torch.core import timing as pt
from repro_torch.core.controller import MemoryController
from test_torch_timing import FAULTS, SCHEDS, assert_same

ROW_BYTES = 4096

_OFF = rcfg.MemoryControllerConfig(
    scheduler=rcfg.SchedulerConfig(enabled=False),
    cache=rcfg.CacheConfig(enabled=False))

CONFIGS = {
    "paper_eval": rcfg.PAPER_EVAL_CONFIG,
    "paper_combined": rcfg.PAPER_COMBINED_CONFIG,
    "combined_frfcfs16": dataclasses.replace(
        rcfg.PAPER_COMBINED_CONFIG,
        dram_sched=rcfg.DRAMSchedConfig(**SCHEDS["frfcfs8"])),
    "off_cap_refresh": dataclasses.replace(
        _OFF, dram_sched=rcfg.DRAMSchedConfig(**SCHEDS["cap32_refresh"])),
    "write_through_xor": dataclasses.replace(
        rcfg.PAPER_COMBINED_CONFIG,
        cache=rcfg.CacheConfig(num_lines=1024, associativity=8,
                               write_policy="write_through"),
        channels=rcfg.ChannelConfig(num_channels=2, policy="xor")),
    "storm": dataclasses.replace(
        _OFF, num_pes=2,
        dram_sched=rcfg.DRAMSchedConfig(**SCHEDS["cap32_refresh"]),
        faults=rcfg.FaultConfig(**FAULTS["storm"])),
}


def _port(config):
    return convert.config_from_dict(dataclasses.asdict(config))


def _trace(seed, n=1200, n_rows=8192, ports=4):
    rng = np.random.default_rng(seed)
    u = np.clip(rng.random(n), 1e-12, 1.0)
    rows = (np.floor(np.minimum(u ** (-1.0 / 0.2), 2.0 ** 40))
            .astype(np.int64) - 1) % n_rows
    rw = (rng.random(n) < 0.15).astype(np.int32)
    pe = rng.integers(0, ports, n)
    arr = np.cumsum(-np.log1p(-rng.random(n)) / 0.05)
    return rows, rw, pe, arr


# ---------------------------------------------------------------------------
# Scheduler control plane
# ---------------------------------------------------------------------------

def _batches(gen):
    return [(b.rw, b.addr, b.pe_id, b.size, b.seq) for b in gen]


@pytest.mark.parametrize("timeout", [4, 40])
@pytest.mark.parametrize("batch", [4, 16, 64])
@pytest.mark.parametrize("seed", [0, 1])
def test_typed_batches(seed, batch, timeout):
    rows, rw, pe, _ = _trace(seed, n=700)
    arrival = np.random.default_rng(seed).integers(0, 3, 700).cumsum()
    kw = dict(batch_size=batch, timeout_cycles=timeout)
    r_c, p_c = rcfg.SchedulerConfig(**kw), pcfg.SchedulerConfig(**kw)
    args = (rows * ROW_BYTES, rw, arrival, pe)
    got = _batches(psch.form_batches_typed(*args, config=p_c))
    assert_same(got, _batches(psch.form_batches_typed_seq(*args,
                                                          config=p_c)))
    assert_same(got, _batches(rsch.form_batches_typed(*args, config=r_c)))
    assert psch.count_batches(rw, arrival, config=p_c) \
        == rsch.count_batches(rw, arrival, config=r_c) == len(got)
    for b_p, b_r in zip(psch.form_batches_typed(*args, config=p_c),
                        rsch.form_batches_typed(*args, config=r_c)):
        assert_same(_batches([psch.reorder_batch(b_p, pt.HBM_V5E)]),
                    _batches([rsch.reorder_batch(b_r, rt.HBM_V5E)]))
        assert psch._is_sequential(b_p.addr, pt.DDR4_2400) \
            == rsch._is_sequential(b_r.addr, rt.DDR4_2400)


@pytest.mark.parametrize("bypass", [False, True])
@pytest.mark.parametrize("coalesce", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_schedule_trace(seed, coalesce, bypass):
    rows, rw, _, _ = _trace(seed, n=900)
    if seed == 2:                       # an already-sorted stream (§V-C)
        rows = np.sort(rows)
    kw = dict(batch_size=32, timeout_cycles=8, bypass_sequential=bypass)
    r_c, p_c = rcfg.SchedulerConfig(**kw), pcfg.SchedulerConfig(**kw)
    arrival = np.arange(900) // 3
    addrs = rows * ROW_BYTES
    got = psch.schedule_trace_rw(addrs, rw, config=p_c, arrival_cycle=arrival,
                                 coalesce_writes=coalesce)
    assert_same(got, psch.schedule_trace_rw_seq(
        addrs, rw, config=p_c, arrival_cycle=arrival,
        coalesce_writes=coalesce))
    assert_same(got, rsch.schedule_trace_rw(
        addrs, rw, config=r_c, arrival_cycle=arrival,
        coalesce_writes=coalesce))
    assert_same(psch.schedule_trace(addrs, rw, config=p_c),
                rsch.schedule_trace(addrs, rw, config=r_c))
    off_p = pcfg.SchedulerConfig(enabled=False)
    off_r = rcfg.SchedulerConfig(enabled=False)
    assert_same(psch.schedule_trace_rw(addrs, rw, config=off_p),
                rsch.schedule_trace_rw(addrs, rw, config=off_r))
    assert psch.count_batches(rw, config=off_p) \
        == rsch.count_batches(rw, config=off_r)


# ---------------------------------------------------------------------------
# simulate() and the modeled_* entry points
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ports", [False, True])
@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("seed", [0, 1])
def test_simulate(seed, config, ports):
    rows, rw, pe, _ = _trace(seed, ports=CONFIGS[config].num_pes)
    pe = pe if ports else None
    ref = RefController(CONFIGS[config])
    port = MemoryController(_port(CONFIGS[config]))
    for kw in ({}, {"coalesce_writes": True},
               {"arbiter_policy": "priority"}):
        assert_same(port.simulate(pe, rows, rw, ROW_BYTES, **kw),
                    ref.simulate(pe, rows, rw, ROW_BYTES, **kw))
    assert_same(port.simulate(pe, rows, None, ROW_BYTES),
                ref.simulate(pe, rows, None, ROW_BYTES))


@pytest.mark.parametrize("faults", [None, "storm", "drops"])
@pytest.mark.parametrize("config", ["paper_combined", "off_cap_refresh"])
@pytest.mark.parametrize("seed", [0, 1])
def test_simulate_open_loop(seed, config, faults):
    rows, rw, pe, arr = _trace(seed, n=900, ports=4)
    cfg = dataclasses.replace(CONFIGS[config], num_pes=4)
    ref, port = RefController(cfg), MemoryController(_port(cfg))
    r_f, p_f = (None, None) if faults is None else (
        rcfg.FaultConfig(**FAULTS[faults]),
        pcfg.FaultConfig(**FAULTS[faults]))
    kw = dict(arbiter_policy="weighted", weights=(4, 1, 1, 2),
              arrival_cycle=arr)
    assert_same(port.simulate(pe, rows, rw, ROW_BYTES, faults=p_f, **kw),
                ref.simulate(pe, rows, rw, ROW_BYTES, faults=r_f, **kw))
    # all-zero stamps forced open loop: the serving datapath, closed-loop
    assert_same(
        port.simulate(pe, rows, rw, ROW_BYTES, arrival_cycle=arr * 0,
                      open_loop=True),
        ref.simulate(pe, rows, rw, ROW_BYTES, arrival_cycle=arr * 0,
                     open_loop=True))


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("seed", [0, 1])
def test_modeled_entry_points(seed, config):
    rows, rw, pe, _ = _trace(seed, ports=CONFIGS[config].num_pes)
    ref = RefController(CONFIGS[config])
    port = MemoryController(_port(CONFIGS[config]))
    assert_same(port.modeled_gather_time(rows, ROW_BYTES),
                ref.modeled_gather_time(rows, ROW_BYTES))
    for coalesce in (False, True):
        assert_same(port.modeled_access_time(rows, rw, ROW_BYTES,
                                             coalesce_writes=coalesce),
                    ref.modeled_access_time(rows, rw, ROW_BYTES,
                                            coalesce_writes=coalesce))
        assert_same(port.modeled_channel_access_time(
            rows, rw, ROW_BYTES, coalesce_writes=coalesce),
            ref.modeled_channel_access_time(rows, rw, ROW_BYTES,
                                            coalesce_writes=coalesce))
    weighted = tuple(range(1, CONFIGS[config].num_pes + 1))
    for policy, weights in (("round_robin", None), ("weighted", weighted)):
        assert_same(port.modeled_multiport_access_time(
            pe, rows, rw, ROW_BYTES, policy=policy, weights=weights,
            coalesce_writes=True),
            ref.modeled_multiport_access_time(
                pe, rows, rw, ROW_BYTES, policy=policy, weights=weights,
                coalesce_writes=True))


def test_modeled_entry_points_take_tensors():
    """A torch tensor is taken as its numpy value; the default controller
    (``device="cuda"``) models on the host with no card."""
    rows, rw, pe, arr = _trace(3)
    mc = MemoryController(pcfg.PAPER_COMBINED_CONFIG)
    assert mc.device == "cuda"
    t = torch.from_numpy
    assert_same(mc.simulate(t(pe), t(rows), t(rw), ROW_BYTES),
                mc.simulate(pe, rows, rw, ROW_BYTES))
    assert_same(mc.simulate(t(pe), t(rows), t(rw), ROW_BYTES,
                            arrival_cycle=t(arr)),
                mc.simulate(pe, rows, rw, ROW_BYTES, arrival_cycle=arr))
    assert_same(mc.modeled_gather_time(t(rows), ROW_BYTES),
                mc.modeled_gather_time(rows, ROW_BYTES))
    assert_same(mc.modeled_access_time(t(rows), t(rw), ROW_BYTES),
                mc.modeled_access_time(rows, rw, ROW_BYTES))
    assert_same(mc.modeled_multiport_access_time(t(pe), t(rows), t(rw),
                                                 ROW_BYTES),
                mc.modeled_multiport_access_time(pe, rows, rw, ROW_BYTES))


def test_simulate_refuses_an_empty_trace():
    mc = MemoryController(pcfg.PAPER_EVAL_CONFIG)
    with pytest.raises(ValueError, match="empty trace"):
        mc.simulate(None, np.zeros(0, np.int64), None, ROW_BYTES)


def test_pipeline_primitives():
    """``RequestStream`` + ``default_stages`` + ``run_pipeline`` give what
    ``simulate`` gives, and a degenerate empty run is allowed there."""
    rows, rw, pe, _ = _trace(4)
    cfg = pcfg.PAPER_COMBINED_CONFIG
    ctx = ppl.PipelineContext.from_config(cfg, pt.DDR4_2400)
    stream = ppl.RequestStream.from_rows(rows, rw, row_bytes=ROW_BYTES,
                                         pe_id=pe)
    res = ppl.run_pipeline(stream, ctx, ppl.default_stages(
        ctx, ports=cfg.num_pes, cache=True))
    assert_same(res, MemoryController(cfg).simulate(pe, rows, rw,
                                                    ROW_BYTES))
    empty = ppl.RequestStream.from_rows(np.zeros(0, np.int64),
                                        row_bytes=ROW_BYTES)
    ctx = ppl.PipelineContext.from_config(cfg, pt.DDR4_2400)
    assert ppl.run_pipeline(empty, ctx, ppl.default_stages(
        ctx, cache=True)).n_requests == 0


@pytest.mark.parametrize("policy", ["write_back", "write_through"])
def test_cache_filter_gives_the_stage_its_dtypes(policy):
    """``CacheFilterStage`` runs the port's ``filter_trace_rw`` (the
    sequential walk under ``engine="auto"``): its hit, keep and
    write-back arrays have the reference's values and numpy dtypes."""
    from repro.core import cache_engine as rce
    from repro_torch.core import cache_engine as pce
    rows, rw, _, _ = _trace(5, n=3000, n_rows=2048)
    kw = dict(num_lines=256, associativity=4, write_policy=policy)
    got = pce.filter_trace_rw(pcfg.CacheConfig(**kw), rows, rw,
                              engine="auto")
    want = rce.filter_trace_rw(rcfg.CacheConfig(**kw), rows, rw,
                               engine="auto")
    assert_same(got, want)
    assert got.n_writebacks == want.n_writebacks
