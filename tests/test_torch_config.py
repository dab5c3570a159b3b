"""Port parity: the controller config, timing presets and Eq. 1 of
``repro_torch`` equal the JAX reference's field for field, and the same bad
inputs raise ``ValueError`` in both packages."""

import dataclasses

import pytest

from repro.core import config as jcfg
from repro.core import timing as jtiming
from repro_torch import convert
from repro_torch.core import config as tcfg
from repro_torch.core import timing as ttiming

PRESETS = ["PAPER_EVAL_CONFIG", "PAPER_COMBINED_CONFIG"]
SUB_CONFIGS = ["SchedulerConfig", "CacheConfig", "ChannelConfig",
               "DRAMSchedConfig", "FaultConfig", "DMAConfig",
               "MemoryControllerConfig"]


@pytest.mark.parametrize("name", PRESETS)
def test_presets_equal_field_for_field(name):
    j, t = getattr(jcfg, name), getattr(tcfg, name)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.vmem_footprint_bytes() == j.vmem_footprint_bytes()
    assert t.describe() == j.describe()


@pytest.mark.parametrize("name", SUB_CONFIGS)
def test_defaults_equal(name):
    assert (dataclasses.asdict(getattr(tcfg, name)())
            == dataclasses.asdict(getattr(jcfg, name)()))


def _variants(m):
    """Configs across the footprint's terms: every engine toggle, channel
    counts, reorder windows and an active fault layer."""
    return [
        m.MemoryControllerConfig(
            scheduler=m.SchedulerConfig(enabled=s, batch_size=b),
            cache=m.CacheConfig(enabled=c, num_lines=lines, associativity=4),
            dma=m.DMAConfig(enabled=d, num_parallel_dma=ch),
            channels=m.ChannelConfig(num_channels=nch),
            dram_sched=m.DRAMSchedConfig(policy="frfcfs", reorder_window=w),
            faults=(m.FaultConfig(transient_ber=1e-4) if f else None))
        for s, c, d, b, lines, ch, nch, w, f in [
            (True, True, True, 64, 4096, 4, 1, 1, False),
            (True, False, True, 512, 256, 8, 4, 16, True),
            (False, True, False, 4, 32768, 1, 16, 512, True),
            (True, True, False, 128, 1024, 2, 2, 8, False),
        ]]


def test_footprint_equal_across_variants():
    for j, t in zip(_variants(jcfg), _variants(tcfg)):
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert t.vmem_footprint_bytes() == j.vmem_footprint_bytes()
        assert t.describe() == j.describe()


BAD = [
    ("SchedulerConfig", dict(batch_size=3)),
    ("SchedulerConfig", dict(batch_size=1024)),
    ("SchedulerConfig", dict(timeout_cycles=2)),
    ("CacheConfig", dict(num_lines=1000)),
    ("CacheConfig", dict(associativity=3)),
    ("CacheConfig", dict(write_policy="write_around")),
    ("CacheConfig", dict(line_width_bits=128)),
    ("ChannelConfig", dict(num_channels=3)),
    ("ChannelConfig", dict(policy="random")),
    ("DRAMSchedConfig", dict(policy="lifo")),
    ("DRAMSchedConfig", dict(t_rfc=10, t_refi=5)),
    ("FaultConfig", dict(transient_ber=1.5)),
    ("FaultConfig", dict(outage_windows=((0, 5, 5),))),
    ("FaultConfig", dict(failed_channels=(1, 1))),
    ("DMAConfig", dict(num_parallel_dma=9)),
    ("MemoryControllerConfig", dict(num_pes=0)),
    ("MemoryControllerConfig", dict(ctrl_overhead_cycles=11)),
]


@pytest.mark.parametrize("name,kwargs", BAD)
def test_same_bad_inputs_raise(name, kwargs):
    with pytest.raises(ValueError):
        getattr(jcfg, name)(**kwargs)
    with pytest.raises(ValueError):
        getattr(tcfg, name)(**kwargs)


@pytest.mark.parametrize("m", [jcfg, tcfg], ids=["jax", "torch"])
def test_cross_field_validation_raises(m):
    with pytest.raises(ValueError):
        m.MemoryControllerConfig(
            scheduler=m.SchedulerConfig(enabled=False),
            cache=m.CacheConfig(enabled=False),
            dma=m.DMAConfig(enabled=False))
    with pytest.raises(ValueError):
        m.MemoryControllerConfig(faults=m.FaultConfig(failed_channels=(0,)))


@pytest.mark.parametrize("batch", [4, 16, 64, 512])
def test_sort_stages_and_eq1_equal(batch):
    assert tcfg.scheduler_sort_stages(batch) == jcfg.scheduler_sort_stages(
        batch)
    assert ttiming.t_schedule(batch) == jtiming.t_schedule(batch)
    for n_batches, service in [(0, 0.0), (1, 10.0), (7, 500.0), (64, 1e5)]:
        assert (ttiming.t_overlapped_schedule(batch, n_batches, service)
                == jtiming.t_overlapped_schedule(batch, n_batches, service))


@pytest.mark.parametrize("name", ["DDR4_2400", "HBM_V5E"])
def test_timing_presets_equal(name):
    j, t = getattr(jtiming, name), getattr(ttiming, name)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert (t.clock_ratio, t.t_mem_seq(), t.t_mem_rand()) == (
        j.clock_ratio, j.t_mem_seq(), j.t_mem_rand())
    assert t.row_of(123456789) == j.row_of(123456789)
    assert t.bank_of(123456789) == j.bank_of(123456789)


def test_config_crosses_through_convert():
    j = jcfg.MemoryControllerConfig(
        channels=jcfg.ChannelConfig(num_channels=4),
        faults=jcfg.FaultConfig(transient_ber=1e-3, failed_channels=(2,),
                                outage_windows=((1, 10, 20),)))
    t = convert.config_from_dict(dataclasses.asdict(j))
    assert isinstance(t, tcfg.MemoryControllerConfig)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.vmem_footprint_bytes() == j.vmem_footprint_bytes()
    assert convert.config_from_dict(
        dataclasses.asdict(jcfg.PAPER_EVAL_CONFIG)) == tcfg.PAPER_EVAL_CONFIG
