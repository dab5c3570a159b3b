"""Package rules of the port: ``repro_torch`` and ``chip_smoke.py`` import
neither JAX nor the reference package, import without ``nvcc`` or
``triton``, run on the GPU unless asked for the CPU, and never fall back
from a kernel to its plain version for a tensor off the CPU."""

import ast
import inspect
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core import (CacheConfig, MemoryController,
                              PAPER_EVAL_CONFIG, init_cache)
from repro_torch.kernels import _build
from repro_torch.kernels.bitonic_sort import kernel as bs_kernel
from repro_torch.kernels.cache_lookup import kernel as cl_kernel
from repro_torch.kernels.cache_lookup import ops as cl_ops
from repro_torch.kernels.dma_copy import kernel as dc_kernel
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.sorted_gather import kernel as sg_kernel
from repro_torch.kernels.sorted_scatter import kernel as ss_kernel

LIBS = (bs_kernel.LIB, sg_kernel.LIB, ss_kernel.LIB, dc_kernel.LIB,
        cl_kernel.LIB, fa_kernel.LIB, cl_kernel.RW_LIB, cl_kernel.RESOLVE_LIB)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"


def _modules():
    return sorted(
        ".".join(p.relative_to(PKG.parent).with_suffix("").parts).removesuffix(
            ".__init__")
        for p in PKG.rglob("*.py"))


def _run(code, env=None, cwd=ROOT):
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), **extra)
    env.pop("CUDA_HOME", None)
    return env


def test_no_module_imports_jax_or_the_reference_package():
    """Import every module of the port (and chip_smoke.py) in a fresh
    interpreter, and run a trace capture of the hybrid and the VLM on the
    CPU (its imports are lazy): neither ``jax`` nor any ``repro`` module
    is loaded."""
    mods = _modules()
    assert {"repro_torch.kernels._build", "repro_torch.configs.yi_34b",
            "repro_torch.models.lm", "repro_torch.launch.serve",
            "repro_torch.kernels.flash_attention.kernel",
            "repro_torch.core.pipeline", "repro_torch.core.channels",
            "repro_torch.data.model_traces",
            "repro_torch.data.synthetic", "repro_torch.optim.adamw",
            "repro_torch.checkpoint.store", "repro_torch.runtime.watchdog",
            "repro_torch.launch.train", "repro_torch.compat",
            "repro_torch.models.sharding", "repro_torch.models.moe_ep",
            "repro_torch.launch.mesh", "repro_torch.launch.dryrun",
            "repro_torch.launch.roofline", "repro_torch.launch.report",
            "repro_torch.kernels.dma_copy.ref"} <= set(mods)
    assert len(mods) > 15
    code = (
        "import importlib, sys\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        f"for m in {mods!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "from repro_torch.data.model_traces import capture_model_trace\n"
        "for a in ('jamba_v0p1_52b', 'internvl2_76b'):\n"
        "    capture_model_trace(a, seq=16, decode_steps=1, device='cpu')\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m == 'repro'\n"
        "             or m.startswith(('jax.', 'repro.')))\n"
        "print(bad)\n")
    res = _run(code, env=_env())
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]"


def test_no_source_names_jax_or_the_reference_package():
    for path in [*PKG.rglob("*.py"), ROOT / "chip_smoke.py",
                 ROOT / "serve_repeat.py", ROOT / "kernel_repeat.py"]:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "repro"), (path, name)


def _decorator_name(node) -> str:
    """``given`` for ``@given(...)``, ``@hypothesis.given`` and the like."""
    if isinstance(node, ast.Call):
        node = node.func
    return node.attr if isinstance(node, ast.Attribute) else getattr(
        node, "id", "")


def test_port_property_tests_draw_fixed_examples():
    """Every Hypothesis test of the port's test files (``@given``) has a
    ``@settings(..., derandomize=True)``: the same examples on every run,
    so that a pass on one tree is a pass on the next."""
    found = 0
    for path in sorted((ROOT / "tests").glob("test_torch_*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            decos = {_decorator_name(d): d for d in node.decorator_list}
            if "given" not in decos:
                continue
            found += 1
            settings = decos.get("settings")
            fixed = isinstance(settings, ast.Call) and any(
                kw.arg == "derandomize" and isinstance(kw.value, ast.Constant)
                and kw.value.value is True for kw in settings.keywords)
            assert fixed, f"{path.name}::{node.name}: no derandomize=True"
    assert found >= 8


@pytest.mark.parametrize("call", ["simulate", "simulate_open_loop",
                                  "sched_fast", "arrivals_fast",
                                  "faults_fast"])
def test_lifecycle_trace_waits_for_its_slice(call):
    """Per-request lifecycle tracing, which this test once found refused,
    is ported: every entry point that takes ``trace=`` records events into
    the port's own recorder, and the traced result equals the untraced
    one."""
    from repro_torch.core import DRAMSchedConfig, DDR4_2400, trace_engine
    from repro_torch.core.config import FaultConfig
    from repro_torch.core.telemetry import ChannelTrace, TraceRecorder
    rows = np.arange(64, dtype=np.int64) % 7
    sched = DRAMSchedConfig(policy="frfcfs", reorder_window=4)

    def run(trace):
        if call.startswith("simulate"):
            arr = np.arange(64.0) if call.endswith("open_loop") else None
            return MemoryController(PAPER_EVAL_CONFIG).simulate(
                None, rows, None, 4096, arrival_cycle=arr, trace=trace)
        trace = None if trace is None else ChannelTrace()
        kw = {"faults": FaultConfig(seed=1, transient_ber=0.1)} \
            if call == "faults_fast" else {}
        fast = {"sched_fast": trace_engine.simulate_dram_sched_fast,
                "arrivals_fast": trace_engine.simulate_arrivals_fast,
                "faults_fast": trace_engine.simulate_faults_fast}[call]
        res = fast(rows * 4096, DDR4_2400, sched, trace=trace, **kw)
        return res, trace

    rec = TraceRecorder()
    traced, base = run(rec), run(None)
    if call.startswith("simulate"):
        assert rec.n_events > 0
        assert traced.makespan_fpga_cycles == base.makespan_fpga_cycles
        assert traced.breakdown() == base.breakdown()
    else:
        assert len(traced[1]) > 0
        assert traced[0].total_fpga_cycles == base[0].total_fpga_cycles
        assert np.array_equal(traced[0].service_order,
                              base[0].service_order)


def test_imports_without_nvcc_or_triton(tmp_path):
    """With no ``nvcc`` on PATH, no CUDA_HOME and ``triton`` unimportable,
    the package imports, builds nothing, and asking for a build raises."""
    code = (
        "import sys\n"
        "class NoTriton:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] == 'triton':\n"
        "            raise ImportError('no triton')\n"
        "sys.meta_path.insert(0, NoTriton())\n"
        "import repro_torch, repro_torch.convert, repro_torch.launch.serve\n"
        "from repro_torch.kernels import _build\n"
        "from repro_torch.kernels.sorted_gather import kernel\n"
        "from repro_torch.kernels.flash_attention import kernel as fa\n"
        "for lib in (kernel.LIB, fa.LIB):\n"
        "    assert lib._lib is None and lib.launches == 0\n"
        "try:\n"
        "    _build.nvcc_path()\n"
        "except RuntimeError as e:\n"
        "    print('raised', 'nvcc' in str(e))\n")
    res = _run(code, env=_env(PATH=str(tmp_path)))
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "raised True"


def test_controller_runs_on_the_gpu_unless_asked():
    mc = MemoryController(PAPER_EVAL_CONFIG)
    assert mc.device == "cuda" and mc.use_kernels
    table, idx = torch.zeros((8, 4)), torch.tensor([1, 2])
    cache_ids = torch.tensor([1], dtype=torch.int32)
    with pytest.raises(ValueError, match="cuda"):
        mc.gather(table, idx)
    with pytest.raises(ValueError, match="cuda"):
        mc.scatter(table, idx, torch.zeros((2, 4)))
    with pytest.raises(ValueError, match="cuda"):
        mc.scatter(table, idx, torch.zeros((2, 4)), mode="add")
    from repro_torch.core import HotRowCache
    with pytest.raises(ValueError, match="cuda"):
        mc.cached_gather(table, idx, HotRowCache(cache_ids, table[:1]))
    with pytest.raises(ValueError, match="cuda"):
        mc.bulk_read(table)
    with pytest.raises(ValueError, match="cuda"):
        mc.bulk_write(table, torch.ones(4), offset_elems=3)
    assert inspect.signature(init_cache).parameters["device"].default \
        == "cuda"
    cpu = MemoryController(PAPER_EVAL_CONFIG, device="cpu")
    assert torch.equal(cpu.gather(table, idx), table[idx])
    assert torch.equal(cpu.bulk_read(table), table)
    assert torch.equal(cpu.bulk_write(table, torch.ones(4), offset_elems=3)
                       .reshape(-1)[3:7], torch.ones(4))


@pytest.mark.parametrize("call", ["sort", "gather", "scatter_set",
                                  "scatter_add", "dma_copy", "cache_probe",
                                  "cache_probe_rw", "row_resolve",
                                  "cache_service", "flash_attention"])
def test_wrappers_take_the_plain_version_only_on_the_cpu(call):
    """For a tensor on another device than the CPU the wrappers launch the
    kernel or raise. On the ``meta`` device (no data, no kernel) the
    kernels of the model path, B1, B2, B3 and B6, give their plain
    versions' result shapes (the dry run counts the model's work on
    ``meta`` tensors) and launch nothing; the others raise rather than
    run the plain version."""
    dev = torch.device("meta")
    i32 = torch.zeros((1, 8), dtype=torch.int32, device=dev)
    table = torch.zeros((8, 4), device=dev)
    sidx = torch.zeros((3,), dtype=torch.int32, device=dev)
    vals = torch.zeros((3, 4), device=dev)
    if call in ("sort", "gather", "scatter_set", "scatter_add",
                "flash_attention"):
        if call == "sort":
            out = bs_kernel.bitonic_sort_batched(i32, i32)
            want = [((1, 8), torch.int32)] * 3
        elif call == "gather":
            out = [sg_kernel.gather_rows(table, sidx)]
            want = [((3, 4), torch.float32)]
        elif call == "flash_attention":
            q = torch.zeros((1, 8, 4, 16), device=dev)
            out = [fa_kernel.flash_attention_fwd(q, q[:, :, :2],
                                                 q[:, :, :2])]
            want = [((1, 8, 4, 16), torch.float32)]
        else:
            out = [ss_kernel.scatter_rows(table, sidx, vals,
                                          mode=call.removeprefix("scatter_"))]
            want = [((8, 4), torch.float32)]
        assert [(tuple(t.shape), t.dtype) for t in out] == want
        assert all(t.device.type == "meta" for t in out)
        assert [lib.launches for lib in LIBS] == [0] * len(LIBS)
        return
    with pytest.raises(ValueError, match="no kernel for device meta"):
        if call == "row_resolve":
            cl_kernel.row_resolve(sidx.long(), vals, vals, vals)
        elif call == "dma_copy":
            dc_kernel.staged_copy(table.reshape(-1), vals.new_zeros(32),
                                  chunk_elems=128, channels=4)
        else:
            state = init_cache(CacheConfig(num_lines=256), 4, device=dev)
            if call == "cache_probe":
                cl_kernel.cache_probe(sidx, state.tags, state.age,
                                      state.age, state.clock)
            elif call == "cache_probe_rw":
                cl_kernel.cache_probe_rw(sidx, sidx, state.tags, state.age,
                                         state.age, state.age, state.clock,
                                         write_back=True, rows=8)
            else:
                cl_ops.cache_service(table, sidx, state)
    assert [lib.launches for lib in LIBS] == [0] * len(LIBS)


def test_model_entry_points_run_on_the_gpu_unless_asked():
    from repro_torch.launch.serve import Server
    from repro_torch.models import LM, build_lm
    from repro_torch.models.params import init_params
    from repro_torch.data.model_traces import capture_model_trace
    for fn in (Server, build_lm, init_params, capture_model_trace):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    assert LM.__dataclass_fields__["device"].default == "cuda"


def test_build_command_targets_hopper():
    cmd = _build.nvcc_command("sorted_gather", pathlib.Path("out.so"))
    assert cmd[cmd.index("-gencode") + 1] == "arch=compute_90a,code=sm_90a"
    for flag in ("-O3", "-shared", "-fPIC"):
        assert flag in cmd
    assert _build.BUILD_DIR == ROOT / "build" / "kernels"
    assert "flash_attention" in _build.SOURCES
    assert {p.stem for p in _build.CSRC.glob("*.cu")} == set(_build.SOURCES)


def test_convert_carries_bf16_bits():
    """numpy's bfloat16 is refused by ``torch.from_numpy``; ``to_tensor``
    carries its bits as uint16."""
    import ml_dtypes
    a = np.asarray([1.0, -2.5, 3.140625, 65280.0], ml_dtypes.bfloat16)
    with pytest.raises(TypeError):
        torch.from_numpy(a)
    from repro_torch import convert
    t = convert.to_tensor(a, "cpu")
    assert t.dtype == torch.bfloat16
    assert t.float().tolist() == a.astype(np.float32).tolist()


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_gpu_or_the_repo(alone, tmp_path):
    """``chip_smoke.py`` exits non-zero and prints no result where
    ``torch.cuda.is_available()`` is false, from the checkout and from a
    directory that holds the script alone."""
    script = ROOT / "chip_smoke.py"
    cwd = ROOT
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = tmp_path / "chip_smoke.py", tmp_path
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    res = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_serve_repeat_fails_without_a_gpu():
    """``serve_repeat.py`` exits non-zero and serves nothing where
    ``torch.cuda.is_available()`` is false."""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    res = subprocess.run([sys.executable, str(ROOT / "serve_repeat.py"),
                          "--repeats", "1"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert "prefill_s" not in res.stdout


def test_kernel_repeat_fails_without_a_gpu():
    """``kernel_repeat.py`` exits non-zero and times nothing where
    ``torch.cuda.is_available()`` is false."""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    res = subprocess.run([sys.executable, str(ROOT / "kernel_repeat.py")],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode != 0
    assert '"kernel"' not in res.stdout


def test_kernel_repeat_times_the_package_it_is_given(tmp_path):
    """``--src`` decides which ``repro_torch`` ``chip_smoke.py``'s timing
    functions run on, though ``chip_smoke`` puts this checkout's ``src``
    first on the path when it is imported."""
    other = tmp_path / "src"
    shutil.copytree(PKG, other / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = (
        "import sys\n"
        f"sys.path.insert(0, {str(other)!r})\n"
        f"sys.path.insert(1, {str(ROOT)!r})\n"
        "import repro_torch\n"
        "import chip_smoke\n"
        "from repro_torch.kernels.sorted_gather import kernel\n"
        "print(chip_smoke.sg_kernel is kernel, kernel.__file__)\n")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    res = _run(code, env=env)
    assert res.returncode == 0, res.stderr
    same, where = res.stdout.split()
    assert same == "True" and where.startswith(str(other))
