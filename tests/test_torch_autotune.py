"""Port parity for the autotuner (``repro_torch.core.autotune``, numpy on
the host) against ``repro.core.autotune`` on the same traces.

Each engine is held to its own counterpart with ``==``: the port's
batched engine to the reference's batched engine, the port's oracle to
the reference's oracle. The two engines of one package may differ in the
last digit of a score on some draws (ROADMAP C6), so neither batched
engine is held to an oracle bit for bit. The draws are fixed and
parametrised (no fresh Hypothesis seed), and include C6's."""

import json
import math
import os

import numpy as np
import pytest

from repro.core import autotune as jat
from repro.core.config import (CacheConfig as JCache,
                               DRAMSchedConfig as JDSched,
                               FaultConfig as JFault,
                               MemoryControllerConfig as JMC,
                               SchedulerConfig as JSched)
from repro.data.synthetic import hog_victim_workload as jhog_victim
from repro_torch.core import autotune as tat
from repro_torch.core.config import (CacheConfig as TCache,
                                     DRAMSchedConfig as TDSched,
                                     FaultConfig as TFault,
                                     MemoryControllerConfig as TMC,
                                     SchedulerConfig as TSched)
from repro_torch.data import model_traces as mt
from repro_torch.data.synthetic import hog_victim_workload as thog_victim
from test_torch_timing import assert_same

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (workload (zipf skew, rows, row bytes), cache axes (batches, ways,
# lines), channel axes, DRAM-sched axes, cache on, seed): the reference
# property test's axes at fixed points. The first is C6's draw, where the
# reference's two engines differ in the last digit at mem_ch=4 map=xor
# dsched=frfcfs:32.
DRAWS = [
    ((1.3, 2048, 512), ((16, 64), (1, 4), (1024, 4096)),
     ((1, 2, 4), ("row_interleave", "xor")),
     (("frfcfs", "frfcfs_cap"), (4, 32)), True, 0),
    ((1.05, 1 << 14, 64), ((16, 64), (1, 4), (1024, 4096)),
     ((1,), ("row_interleave",)), (("fifo",), (1,)), True, 1),
    ((1.2, 256, 4096), ((8,), (2,), (256, 16384)),
     ((2,), ("block_interleave",)), (("fifo", "frfcfs"), (1, 8)), False, 2),
    ((1.3, 2048, 512), ((8,), (2,), (256, 16384)),
     ((1, 2, 4), ("row_interleave", "xor")), (("fifo", "frfcfs"), (1, 8)),
     True, 3),
    ((1.05, 1 << 14, 64), ((8,), (2,), (256, 16384)),
     ((2,), ("block_interleave",)), (("frfcfs", "frfcfs_cap"), (4, 32)),
     False, 4),
    ((1.2, 256, 4096), ((16, 64), (1, 4), (1024, 4096)),
     ((1, 2, 4), ("row_interleave", "xor")), (("fifo",), (1,)), True, 5),
]

# perf_model_traces' joint grid (benchmarks/perf_model_traces.py).
FULL_GRID = dict(
    batch_sizes=(16, 64, 256),
    associativities=(1, 4),
    num_lines=(1024, 4096, 16384),
    dma_channels=(4,),
    num_channels=(1, 2, 4),
    mapping_policies=("row_interleave", "xor"),
    dram_sched_policies=("fifo", "frfcfs"),
    reorder_windows=(1, 16, 64),
)


def _draw(workload, cache_axes, chan_axes, sched_axes, enable_cache, seed):
    skew, n_rows, row_bytes = workload
    batches, ways, lines = cache_axes
    rng = np.random.default_rng(seed)
    rows = ((rng.zipf(skew, 1500) - 1) % n_rows).astype(np.int64)
    grids = dict(batch_sizes=batches, associativities=ways,
                 num_lines=lines, dma_channels=(1, 4),
                 num_channels=chan_axes[0], mapping_policies=chan_axes[1],
                 dram_sched_policies=sched_axes[0],
                 reorder_windows=sched_axes[1], enable_cache=enable_cache)
    return rows, row_bytes, grids


def _same_tune(got, want):
    assert got.table == want.table
    assert_same(got.config, want.config, "config")
    assert got.modeled_cycles == want.modeled_cycles
    assert got.candidates_evaluated == want.candidates_evaluated


@pytest.mark.parametrize("engine", ["batched", "oracle"])
@pytest.mark.parametrize("draw", range(len(DRAWS)))
def test_each_engine_matches_its_reference_counterpart(draw, engine):
    rows, row_bytes, grids = _draw(*DRAWS[draw])
    _same_tune(tat.tune(rows, row_bytes, engine=engine, **grids),
               jat.tune(rows, row_bytes, engine=engine, **grids))


def test_c6_engines_differ_only_in_the_last_digit():
    """On C6's draw the port's two engines agree on every description and
    the argmin, and their scores within a few ulps, as the reference's do;
    the reference's differ there, so the port's must too."""
    rows, row_bytes, grids = _draw(*DRAWS[0])
    b = tat.tune(rows, row_bytes, engine="batched", **grids)
    o = tat.tune(rows, row_bytes, engine="oracle", **grids)
    jb = jat.tune(rows, row_bytes, engine="batched", **grids)
    jo = jat.tune(rows, row_bytes, engine="oracle", **grids)
    assert [d for d, _ in b.table] == [d for d, _ in o.table]
    assert_same(b.config, o.config, "config")
    for (_, x), (_, y) in zip(b.table, o.table):
        assert abs(x - y) <= 4 * math.ulp(max(abs(x), abs(y)))
    differs = [d for (d, x), (_, y) in zip(b.table, o.table) if x != y]
    assert "batch=64 ways=1 lines=1024 dma=1 mem_ch=4 map=xor " \
        "dsched=frfcfs:32" in differs
    assert differs == [d for (d, x), (_, y) in zip(jb.table, jo.table)
                       if x != y]


@pytest.mark.parametrize("rows", [[7], [3, 3, 9, 3, 11]])
@pytest.mark.parametrize("engine", ["batched", "oracle"])
def test_tiny_traces_match_reference(rows, engine):
    rows = np.asarray(rows, np.int64)
    grids = dict(batch_sizes=(4, 64), associativities=(1,),
                 num_lines=(1024,), dma_channels=(1,), num_channels=(1, 4),
                 dram_sched_policies=("fifo", "frfcfs"),
                 reorder_windows=(1, 8))
    _same_tune(tat.tune(rows, 4096, engine=engine, **grids),
               jat.tune(rows, 4096, engine=engine, **grids))


def test_vmem_budget_and_errors_match_reference():
    rng = np.random.default_rng(0)
    rows = ((rng.zipf(1.3, 4096) - 1) % 2048).astype(np.int64)
    grids = dict(vmem_budget_bytes=600 << 10, batch_sizes=(512,),
                 associativities=(4,), num_lines=(4096,), dma_channels=(1,),
                 num_channels=(1, 8))
    _same_tune(tat.tune(rows, 512, **grids), jat.tune(rows, 512, **grids))
    with pytest.raises(ValueError, match="unknown tune engine"):
        tat.tune(rows, 512, engine="vmapped")
    with pytest.raises(ValueError, match="no feasible configuration"):
        tat.tune(rows, 512, vmem_budget_bytes=1)


def test_score_matches_reference():
    rng = np.random.default_rng(1)
    rows = ((rng.zipf(1.2, 3000) - 1) % 4096).astype(np.int64)
    assert tat._score(TMC(), rows, 512, tat.DDR4_2400) == \
        jat._score(JMC(), rows, 512, jat.DDR4_2400)


@pytest.mark.parametrize("fam", sorted(mt.FAMILY_REPRESENTATIVE))
def test_pinned_traces_reproduce_bench_model_traces(fam):
    """perf_model_traces' method on the six pinned family traces (8 ports,
    4096-byte rows, the batched engine over its full grid) gives
    ``BENCH_model_traces.json``'s ``families`` entry: the geometry and
    ``tuned_cycles`` to 0.1."""
    with open(os.path.join(ROOT, "BENCH_model_traces.json")) as f:
        want = json.load(f)["families"][fam]
    arch = mt.FAMILY_REPRESENTATIVE[fam]
    assert want["representative"] == arch
    _, rows, _ = mt.load_pinned_trace(arch).replay_arrays(8)
    res = tat.tune(rows, mt.REPLAY_ROW_BYTES, engine="batched", **FULL_GRID)
    cfg = res.config
    assert {"sched_batch": cfg.scheduler.batch_size,
            "cache_ways": cfg.cache.associativity,
            "cache_lines": cfg.cache.num_lines,
            "num_channels": cfg.channels.num_channels,
            "mapping": cfg.channels.policy,
            "dram_sched": cfg.dram_sched.policy,
            "reorder_window": cfg.dram_sched.reorder_window,
            "dma_channels": cfg.dma.num_parallel_dma} == want["geometry"]
    assert round(res.modeled_cycles, 1) == want["tuned_cycles"]


def _sweep_cfgs(multiport):
    kw = dict(policy="frfcfs", reorder_window=8) if multiport else dict(
        policy="frfcfs_cap", reorder_window=16, starvation_cap=8,
        t_rfc=420, t_refi=9363)
    return [mc(num_pes=2 if multiport else 8,
               scheduler=sc(enabled=False), cache=cc(enabled=False),
               dram_sched=ds(**kw))
            for mc, sc, cc, ds in ((TMC, TSched, TCache, TDSched),
                                   (JMC, JSched, JCache, JDSched))]


@pytest.mark.parametrize("multiport", [False, True])
def test_sweep_serving_loads_matches_reference(multiport):
    rng = np.random.default_rng(3)
    n = 2000
    rows = ((rng.zipf(1.2, n) - 1) % 4096).astype(np.int64)
    rw = (rng.random(n) < 0.2).astype(np.int32)
    pe = rng.integers(0, 2, n).astype(np.int32) if multiport else None
    arrivals = [np.cumsum(rng.exponential(1.0 / (0.09 * f), n))
                for f in (0.5, 1.2)]
    kw = dict(arbiter_policy="weighted", weights=(4, 1)) if multiport \
        else {}
    tcfg, jcfg = _sweep_cfgs(multiport)
    got = tat.sweep_serving_loads(tcfg, rows, rw, pe, arrivals, 4096, **kw)
    want = jat.sweep_serving_loads(jcfg, rows, rw, pe, arrivals, 4096, **kw)
    assert len(got) == len(want) == 2
    for i, (g, w) in enumerate(zip(got, want)):
        assert_same(g, w, f"point {i}")
    with pytest.raises(ValueError, match="one entry per request"):
        tat.sweep_serving_loads(tcfg, rows, rw, pe, [np.zeros(3)], 4096)
    with pytest.raises(ValueError, match="finite"):
        tat.sweep_serving_loads(tcfg, rows, rw, pe, [np.full(n, np.nan)],
                                4096)


@pytest.mark.parametrize("case", ["no_target", "target", "faults"])
def test_tune_serving_matches_reference(case):
    """The constrained QoS search over the reference's hog/victim stream:
    without a target (p99-min), with a generous one (makespan-min among
    feasible), and with an error storm (the retry-policy axis)."""
    kw = dict(n_victim=200, n_hog=800, victim_rate=0.02, hog_rate=0.2)
    rows, rw, pe, arr = thog_victim(np.random.default_rng(7), **kw)
    want_arrays = jhog_victim(np.random.default_rng(7), **kw)
    for a, b in zip((rows, rw, pe, arr), want_arrays):
        np.testing.assert_array_equal(a, np.asarray(b))
    grid = dict(num_ports=2, arb_policies=("round_robin", "weighted"),
                weight_ratios=(4,),
                dram_sched_policies=("frfcfs", "frfcfs_cap"),
                reorder_windows=(16,), starvation_caps=(8,))
    tkw, jkw = dict(grid), dict(grid)
    if case == "target":
        tkw["slo_p99_cycles"] = jkw["slo_p99_cycles"] = 1e12
    if case == "faults":
        f = dict(seed=3, transient_ber=0.05, weak_row_fraction=0.05,
                 weak_row_ber=0.5, due_fraction=0.5, max_replays=2,
                 backoff_clocks=8)
        tkw.update(faults=TFault(**f), max_replays_grid=(1, 4),
                   backoff_grid=(8, 64))
        jkw.update(faults=JFault(**f), max_replays_grid=(1, 4),
                   backoff_grid=(8, 64))
    got = tat.tune_serving(rows, rw, pe, arr, 4096, **tkw)
    want = jat.tune_serving(rows, rw, pe, arr, 4096, **jkw)
    assert_same(got, want, "tune_serving")
    assert got.candidates_evaluated == len(got.table) == \
        (16 if case == "faults" else 4)
