"""Build and bind the port's CUDA kernels: ``nvcc`` → shared library → ``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles on its own
into ``build/kernels/lib<name>.so`` at the checkout's root, on first use
(or all together, one ``nvcc`` process per source, through :func:`build`).
Nothing is compiled or loaded at import time, so ``import repro_torch``
works on a machine without ``nvcc`` or a GPU.

Binding rules: every pointer and the stream are ``c_void_p`` (ctypes would
otherwise pass a Python int as a 32-bit ``int`` and cut the pointer), and
every C entry returns ``cudaGetLastError()`` after its launches, which
:meth:`CudaLibrary.launch` turns into a ``RuntimeError``.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("bitonic_sort", "sorted_gather", "sorted_scatter", "dma_copy",
           "cache_lookup", "flash_attention")
# ``sm_90a`` (not ``sm_90``): the Hopper-only target.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

P = ctypes.c_void_p
I32 = ctypes.c_int
I64 = ctypes.c_longlong
F32 = ctypes.c_float


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.access(os.path.join(CUDA_HOME, "bin", "nvcc"),
                               os.X_OK):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found (neither on PATH nor under CUDA_HOME): the CUDA "
        "kernels of repro_torch are built from source on first use")


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def nvcc_command(name: str, out: Path, nvcc: str = "nvcc") -> list[str]:
    return [nvcc, *NVCC_FLAGS, "-o", str(out), str(CSRC / f"{name}.cu")]


def _stale(name: str) -> bool:
    lib = library_path(name)
    if not lib.exists():
        return True
    newest = max(p.stat().st_mtime for p in
                 (CSRC / f"{name}.cu", CSRC / "common.cuh"))
    return lib.stat().st_mtime < newest


def build(names=SOURCES) -> dict[str, str]:
    """Compile the named sources that have no library newer than their
    source, one ``nvcc`` each, all started together.

    Returns each compiled source's compiler output (``-Xptxas=-v``
    register and shared-memory report). Raises ``RuntimeError`` with the
    compiler's output if any build fails; every started process is waited
    for.
    """
    todo = [n for n in names if _stale(n)]
    if not todo:
        return {}
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in todo:
        tmp = BUILD_DIR / f"lib{name}.so.tmp{os.getpid()}"
        procs[name] = (tmp, subprocess.Popen(
            nvcc_command(name, tmp, nvcc), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    reports, failed = {}, []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        reports[name] = out
        if proc.returncode == 0:
            os.replace(tmp, library_path(name))
        else:
            failed.append(f"--- {name}.cu (exit {proc.returncode}):\n{out}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return reports


class CudaLibrary:
    """One kernel's shared library: its C entries and its launch counts.

    ``launches`` rises by one for each successful ``launch`` call — one
    per wrapper call that ran the kernel on the GPU — and nowhere else;
    ``entry_launches[entry]`` counts the calls per C entry (a route),
    also those of a wrapper's preparing entry, which it launches with
    ``count=False`` beside the one it counts.
    """

    def __init__(self, name: str, entries: dict[str, tuple]):
        self.name = name
        self.entries = entries
        self.launches = 0
        self.entry_launches = dict.fromkeys(entries, 0)
        self._fns: dict[str, ctypes._CFuncPtr] = {}
        self._lib = None

    def _load(self) -> None:
        if _stale(self.name):
            build((self.name,))
        lib = ctypes.CDLL(str(library_path(self.name)))
        for entry, argtypes in self.entries.items():
            fn = getattr(lib, entry)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
            self._fns[entry] = fn
        lib.error_string.argtypes = [ctypes.c_int]
        lib.error_string.restype = ctypes.c_char_p
        self._lib = lib

    def launch(self, entry: str, *args, count: bool = True) -> None:
        if self._lib is None:
            self._load()
        err = self._fns[entry](*args)
        if err:
            msg = self._lib.error_string(err).decode()
            raise RuntimeError(f"{self.name}.{entry}: CUDA error {err}: {msg}")
        self.launches += count
        self.entry_launches[entry] += 1

    def reset_launches(self) -> None:
        self.launches = 0
        self.entry_launches = dict.fromkeys(self.entries, 0)
