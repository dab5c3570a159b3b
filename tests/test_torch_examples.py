"""The port's examples (``examples/torch_*.py``) on the CPU at smoke size.

Each example's ``main`` runs with ``--device cpu`` (few steps where it
trains) and must do what its reference example does: the controller's
gather value-identical to the plain one, every request served, the losses
finite. Where an example reports the modeled-timing simulator's numbers,
they equal the reference package's for the same requests. No example
imports ``jax`` or ``repro``.
"""

import ast
import dataclasses
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.core import MemoryController as JMC
from repro.core import MemoryControllerConfig as JMCConfig
from repro.core import PAPER_COMBINED_CONFIG as J_COMBINED
from repro.core import PAPER_EVAL_CONFIG as J_EVAL
from repro.core import simulate_dram_access as j_simulate_dram_access
from repro.core.cache_engine import hit_rate_oracle as j_hit_rate_oracle
from repro.core.config import CacheConfig as JCache
from repro.core.config import ChannelConfig as JChannel
from repro.core.config import DMAConfig as JDMA
from repro.core.config import SchedulerConfig as JSched
from repro.core.scheduler import form_batches as j_form_batches
from repro_torch.configs import get_arch

ROOT = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = sorted((ROOT / "examples").glob("torch_*.py"))


def _load(name: str):
    path = ROOT / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"_example_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_the_four_examples_are_there():
    assert [p.name for p in EXAMPLES] == [
        "torch_gather_acceleration.py", "torch_quickstart.py",
        "torch_serve_batched.py", "torch_train_100m.py"]


@pytest.mark.parametrize("path", EXAMPLES, ids=lambda p: p.stem)
def test_example_imports_neither_jax_nor_the_reference(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add((node.module or "").split(".")[0])
    assert not names & {"jax", "jaxlib", "repro"}, names
    assert "repro_torch" in names


@pytest.mark.parametrize("path", EXAMPLES, ids=lambda p: p.stem)
def test_example_runs_on_the_gpu_by_default(path, tmp_path):
    """Without ``--device`` an example asks for the GPU; with none there
    it raises and never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device would run")
    argv = (["--ckpt-dir", str(tmp_path / "ckpt")]
            if path.stem == "torch_train_100m" else [])
    with pytest.raises((AssertionError, RuntimeError),
                       match="CUDA|cuda"):
        _load(path.stem).main(argv)


def test_quickstart(one_thread, capsys):
    out = _load("torch_quickstart").main(["--device", "cpu",
                                          "--train-steps", "3"])
    # the controller's modeled cycles: the reference's for the same ids
    cfg = JMCConfig(scheduler=JSched(batch_size=64, timeout_cycles=16),
                    cache=JCache(num_lines=4096, associativity=4),
                    dma=JDMA(num_parallel_dma=4),
                    channels=JChannel(num_channels=4))
    ids = np.random.default_rng(1).integers(0, 4096, 1024)
    res = JMC(cfg).simulate(None, ids, None, 256)
    ctrl = out["controller"]
    assert ctrl["naive_cycles"] == j_simulate_dram_access(
        ids * 256).total_fpga_cycles
    assert ctrl["controller_cycles"] == res.makespan_fpga_cycles
    assert ctrl["cache_hit_rate"] == res.cache_hit_rate
    train = out["train"]
    assert len(train["history"]) == 3
    assert all(np.isfinite(train["history"]))
    assert out["serve"]["requests"] == 3
    assert all(len(o) == 4 for o in out["serve"]["outputs"])
    assert "value identity" not in capsys.readouterr().err


def test_serve_batched(one_thread):
    out = _load("torch_serve_batched").main(["--device", "cpu"])
    # admission as the reference's batch former on the same arrivals
    rng = np.random.default_rng(0)
    arrivals, t = [], 0
    for size in (4, 6, 2):
        for _ in range(size):
            rng.integers(0, 256, rng.integers(8, 20))
            arrivals.append(t)
            t += 1
        t += 50
    want = j_form_batches(addrs=list(range(len(arrivals))),
                          rw=[0] * len(arrivals), arrival_cycle=arrivals,
                          config=JSched(batch_size=4, timeout_cycles=8))
    assert out["batch_sizes"] == [len(b) for b in want] == [4, 4, 2, 2]
    assert out["requests"] == 12 and out["batches"] == 4
    assert all(len(o) == 6 and all(0 <= x < 256 for x in o)
               for o in out["outputs"])
    assert out["decode_steps"] == 4 * 6


def test_train_100m_smoke(one_thread, tmp_path):
    out = _load("torch_train_100m").main(
        ["--device", "cpu", "--smoke", "--steps", "3", "--batch", "2",
         "--seq", "32", "--ckpt-dir", str(tmp_path / "ckpt")])
    assert len(out["history"]) == 3
    assert all(np.isfinite(out["history"]))
    # three steps: windows of one loss each, which do not overlap
    assert out["first"] == out["history"][0]
    assert out["last"] == out["history"][-1]
    assert out["params"] > 0 and out["median_step_s"] > 0


def test_train_100m_model_is_the_reference_examples():
    mod, ref = _load("torch_train_100m"), _load("train_100m")
    assert mod.OVERRIDES == ref.OVERRIDES
    cfg = dataclasses.replace(get_arch("yi-34b"), **mod.OVERRIDES)
    want = dataclasses.replace(j_get_arch("yi-34b"), **ref.OVERRIDES)
    assert cfg.param_count() == want.param_count() == 92_583_040


def test_gather_acceleration(one_thread):
    out = _load("torch_gather_acceleration").main(["--device", "cpu"])
    rng = np.random.default_rng(0)
    rng.standard_normal((16_384, 256))
    dst = ((rng.zipf(1.15, 100_000) - 1) % 16_384).astype(np.int32)
    assert out["naive_cycles"] == j_simulate_dram_access(
        dst.astype(np.int64) * 1024).total_fpga_cycles
    assert out["controller_cycles"] == JMC(J_EVAL).modeled_gather_time(
        dst, row_bytes=1024).total_fpga_cycles
    res = JMC(J_COMBINED).simulate(None, dst, None, 1024)
    assert out["makespan_cycles"] == res.makespan_fpga_cycles
    assert out["combined_hit_rate"] == res.cache_hit_rate
    assert out["lru_hit_rate"] == j_hit_rate_oracle(J_EVAL.cache, dst)[1]
    assert 0 < out["hot_hit_rate"] < 1
    assert set(out["wall_ms"]) == {"plain", "controller"}
