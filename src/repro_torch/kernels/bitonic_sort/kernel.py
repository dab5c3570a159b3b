"""Bitonic sorting network — the scheduler's reordering engine (paper Fig. 2).

``bitonic_sort_batched`` sorts each row of ``(G, N)`` int32 keys with an
int32 payload, comparing ``(key, arrival_id)`` so the network is a total
order and equals a stable sort. On a CUDA tensor it launches the kernels
of ``csrc/bitonic_sort.cu`` by ``stage_plan(N, default_chunk(N))``: every
stage whose stride fits a chunk runs inside one block (in shared memory
and registers), so a row of N <= DEFAULT_CHUNK is one launch; on a CPU
tensor it runs ``sort_network``, the same network stage by stage (every
plan runs the network's stages in the network's order), as a loop of
reshapes and ``torch.where``s. Counterpart of
``repro.kernels.bitonic_sort.kernel``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels._build import I32, P, CudaLibrary

LIB = CudaLibrary("bitonic_sort", {
    "bitonic_sort_rows": (P, P, P, P, P, I32, I32, I32, P, I32, P)})
# Elements of one chunk sorted in one block's shared memory, at 12 bytes
# (key, id, payload) an element: 16384 is 192 KB of the 227 KB a block may
# have.
MAX_CHUNK = 16384
# The chunk ``bitonic_sort_batched`` takes for a row longer than it, one
# block per chunk: parallelism against launches. A block sorts its chunk
# alone, so a few large chunks leave most of the card idle (1 x 32768 at
# 16384 is 3 launches on 2 blocks), while every global stage is one more
# launch (at 1024, 21 launches on 32 blocks). chip_smoke.py times the
# 1 x 32768 row at 1024, 2048, 4096 and 16384 (PERF.md has the readings):
# 2048, 15 launches on 16 blocks, comes near the fastest device time (at
# 1024) with six launches fewer.
DEFAULT_CHUNK = 2048


def stage_plan(n: int, chunk: int) -> list[tuple[str, int, int]]:
    """The launches that sort rows of ``n`` (a power of two) with chunks of
    ``min(chunk, n)`` elements, in order: ``("local", k_first, k_last)``
    runs stages k = k_first..k_last, j = min(k, c)-1..0 inside each chunk
    of 2^c elements; ``("global", k, j)`` runs one stage over whole rows."""
    m = n.bit_length() - 1
    c = min(chunk, n).bit_length() - 1
    plan = [("local", 1, c)]
    for k in range(c + 1, m + 1):
        plan += [("global", k, j) for j in range(k - 1, c - 1, -1)]
        plan.append(("local", k, k))
    return plan


@functools.lru_cache(maxsize=64)
def _plan_array(n: int, chunk: int):
    """``stage_plan`` as the C entry's int32 triples (0 global, 1 local)."""
    flat = [x for kind, a, b in stage_plan(n, chunk)
            for x in ((kind == "local"), a, b)]
    return (ctypes.c_int * len(flat))(*flat), len(flat) // 3


def _compare_exchange(keys, ids, vals, j_exp: int, k_exp: int):
    """One network stage on (G, N) rows: stride 2^j_exp within direction
    blocks of 2^k_exp."""
    g, n = keys.shape
    j = 1 << j_exp
    shape = (g, n // (2 * j), 2, j)

    def split(x):
        return x.reshape(shape).unbind(2)

    ka, kb = split(keys)
    ia, ib = split(ids)
    va, vb = split(vals)
    # Direction of the sub-block each pair lives in: the pair's first slot
    # is c*2j + t; its K-block is (c*2j) >> k_exp.
    c = torch.arange(shape[1], device=keys.device).view(1, -1, 1)
    ascending = ((c * 2 * j) >> k_exp) % 2 == 0
    gt = (ka > kb) | ((ka == kb) & (ia > ib))   # composite (key, id) order
    swap = torch.where(ascending, gt, ~gt)

    def merge(a, b):
        lo = torch.where(swap, b, a)
        hi = torch.where(swap, a, b)
        return torch.stack([lo, hi], dim=2).reshape(g, n)

    return merge(ka, kb), merge(ia, ib), merge(va, vb)


def sort_network(keys, ids, vals):
    """The plain network on (G, N) rows, N a power of two: stages k =
    1..log2 N, j = k-1..0, in order."""
    for k_exp in range(1, keys.shape[-1].bit_length()):
        for j_exp in range(k_exp - 1, -1, -1):
            keys, ids, vals = _compare_exchange(keys, ids, vals, j_exp, k_exp)
    return keys, ids, vals


def default_chunk(n: int) -> int:
    return min(n, DEFAULT_CHUNK)


def bitonic_sort_batched(keys: torch.Tensor, vals: torch.Tensor):
    """Sort each row of ``keys (G, N)`` with payload ``vals``; returns
    (sorted_keys, perm, sorted_vals), all int32.

    Both inputs are contiguous int32 tensors of one shape on one device,
    and N is a power of two >= 2. Anything else raises ``ValueError``. The
    kernel's launches are ``stage_plan(N, default_chunk(N))``. CPU tensors
    take the plain version; ``meta`` tensors (the dry run's, which hold no
    data) get the results' shapes from one stable ``torch.sort``.
    """
    if keys.dtype != torch.int32 or vals.dtype != torch.int32:
        raise ValueError(f"keys and vals must be int32, got {keys.dtype} "
                         f"and {vals.dtype}")
    if keys.ndim != 2 or keys.shape != vals.shape:
        raise ValueError(f"keys {tuple(keys.shape)} and vals "
                         f"{tuple(vals.shape)} must be one (G, N) shape")
    g, n = keys.shape
    if n < 2 or n & (n - 1):
        raise ValueError(f"row length {n} must be a power of two >= 2")
    if keys.device != vals.device:
        raise ValueError(f"keys on {keys.device}, vals on {vals.device}")
    if not (keys.is_contiguous() and vals.is_contiguous()):
        raise ValueError("keys and vals must be contiguous")
    if keys.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"no kernel for device {keys.device}")
    if keys.device.type == "meta":
        # shapes only: one stable sort stands in for the network's
        # log2(N)^2 / 2 stages, which hold no FLOPs for the dry run to count
        skeys, perm = torch.sort(keys, dim=-1, stable=True)
        return skeys, perm.to(torch.int32), torch.empty_like(vals)
    if keys.device.type == "cpu":
        ids = torch.arange(n, dtype=torch.int32).expand(g, n).contiguous()
        return sort_network(keys, ids, vals)
    if g * n >= 1 << 31:
        raise ValueError(f"{g} x {n} keys exceed the kernel's int32 grid")
    return _sort_on_card(keys, vals, default_chunk(n))


def _sort_on_card(keys, vals, chunk: int):
    """The kernels on checked CUDA inputs, by ``stage_plan(N, chunk)``;
    ``chunk`` a power of two in [2, min(N, MAX_CHUNK)]. Only the wrapper
    and a measurement of other chunks call it."""
    g, n = keys.shape
    if chunk < 2 or chunk & (chunk - 1) or chunk > min(n, MAX_CHUNK):
        raise ValueError(f"chunk {chunk} must be a power of two in "
                         f"[2, {min(n, MAX_CHUNK)}]")
    # One allocation for the three outputs (views of one (3, G, N) block).
    out_keys, ids, out_vals = torch.empty((3, g, n), dtype=torch.int32,
                                          device=keys.device).unbind(0)
    plan, steps = _plan_array(n, chunk)
    LIB.launch("bitonic_sort_rows", keys.data_ptr(), vals.data_ptr(),
               out_keys.data_ptr(), ids.data_ptr(), out_vals.data_ptr(), g,
               n, chunk.bit_length() - 1, ctypes.addressof(plan), steps,
               torch.cuda.current_stream(keys.device).cuda_stream)
    return out_keys, ids, out_vals
