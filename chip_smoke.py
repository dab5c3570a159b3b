#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and check every kernel.

Run from the repository root on a machine with an NVIDIA Hopper GPU and
``nvcc``:  ``python3 chip_smoke.py``

Phases (a failing phase raises and the script exits non-zero):

1. device — a CUDA device is present; the card's name and power limit.
2. build  — every kernel of ``src/repro_torch/kernels/csrc`` that has no
   library in ``build/kernels`` newer than its source (in a fresh
   checkout, all of them) is compiled, one ``nvcc`` per source, all
   started together.
3. kernels — each kernel against its plain-torch version on the card, at
   the main paths' shapes and at the edge cases: sort, gather, ``set``,
   the DMA copy and the cache probe must be bit-equal (the probe over its
   whole trajectory: hits, ways, tags, valid bits, ages, clock), ``add``
   within float32 reassociation (rtol = atol = 1e-5) for float32 and
   float64 tables and within one bf16 or f16 ulp for those; float32
   values summed into a bf16 or f16 table are held by ``check_mixed_add``.
4. slice — three main paths, each through the entry points a user calls,
   with every launch counter zeroed just before it and read just after;
   each of its kernels must have run:
   - scheduler: the controller's data plane at the yi-34b embedding table
     (vocab 64000 x d_model 7168, bf16, random from a seed) under a
     prefill batch of 8 x 4096 Zipf(1.1) token ids:
     ``MemoryController.gather``, ``cached_gather`` (4096 hottest ids
     pinned), ``scatter`` set and add (the embedding-gradient write, in
     bf16 and in float32), ``cached_scatter``, and ``sort_requests`` as
     64 x 512 scheduler batches and as one 1-D row. Outputs are held to
     ``table[idx]`` and the plain paths, and a small case to a numpy
     oracle.
   - bulk: ``bulk_read`` of one yi-34b FFN weight (7168 x 20480 bf16) and
     ``bulk_write`` of one layer's prefill K and V into one sequence's
     KV cache (60 x 2 x 4096 x 8 x 128 bf16) at layer 30, held to the
     source, the plain path and a flat slice assignment.
   - cache: ``cache_service`` of the embedding table as 512-byte lines
     through the Table I maximum cache (32768 lines, 16-way), for the
     28 lines of each token of sequence 0 of the prefill batch; lines
     held to ``table[line_ids]``, hits to the numpy ``hit_rate_oracle``,
     the new state to the plain probe and a plain last-writer scatter.
5. timing — per kernel at the main paths' shapes: the CUDA-event median
   of the kernel's wrapper, its plain version and one PyTorch library
   call computing the same function (none for the cache probe: no
   PyTorch call runs an LRU), beside the least time the card could take
   (bytes over 3.35 TB/s, or operations over the peak rate).

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.core import (CacheConfig, DMAConfig, HotRowCache,  # noqa: E402
                              MemoryController, PAPER_EVAL_CONFIG,
                              dma_engine, hit_rate_oracle, init_cache)
from repro_torch.core.controller import scatter_set_last  # noqa: E402
from repro_torch.core.scheduler import sort_requests  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.bitonic_sort import kernel as bs_kernel  # noqa: E402
from repro_torch.kernels.bitonic_sort import ops as bs_ops  # noqa: E402
from repro_torch.kernels.cache_lookup import kernel as cl_kernel  # noqa: E402
from repro_torch.kernels.cache_lookup import ops as cl_ops  # noqa: E402
from repro_torch.kernels.dma_copy import kernel as dc_kernel  # noqa: E402
from repro_torch.kernels.dma_copy import ops as dc_ops  # noqa: E402
from repro_torch.kernels.sorted_gather import kernel as sg_kernel  # noqa: E402
from repro_torch.kernels.sorted_scatter import kernel as ss_kernel  # noqa: E402

LIBS = {"bitonic_sort": bs_kernel.LIB, "sorted_gather": sg_kernel.LIB,
        "sorted_scatter": ss_kernel.LIB, "dma_copy": dc_kernel.LIB,
        "cache_lookup": cl_kernel.LIB}
REPLACES = {"bitonic_sort": "src/repro/kernels/bitonic_sort/kernel.py:85",
            "sorted_gather": "src/repro/kernels/sorted_gather/kernel.py:34",
            "sorted_scatter": "src/repro/kernels/sorted_scatter/kernel.py:38",
            "dma_copy": "src/repro/kernels/dma_copy/kernel.py:69",
            "cache_lookup": "src/repro/kernels/cache_lookup/kernel.py:63"}
# The main path that drives each kernel (phase 4); its launches are the
# ones reported.
PATH_OF = {"bitonic_sort": "scheduler", "sorted_gather": "scheduler",
           "sorted_scatter": "scheduler", "dma_copy": "bulk",
           "cache_lookup": "cache"}
SEED = 0
VOCAB, D_MODEL = 64000, 7168     # yi-34b (src/repro/configs/yi_34b.py), bf16
BATCH, SEQ = 8, 4096             # one prefill batch of token ids
ZIPF_S = 1.1
HOT_ROWS = 4096
SCHED_BATCH = 512                # the scheduler's largest batch (Table I)
FFN_SHAPE = (D_MODEL, 20480)     # one yi-34b FFN weight (d_model x d_ff)
# One sequence's yi-34b KV cache: layers x (K, V) x seq x kv heads x
# head_dim; a prefill flushes one layer's K and V at a time.
KV_SHAPE = (60, 2, SEQ, 8, 128)
KV_LAYER = 30
# The cache engine at the Table I maximum: 32768 lines of 512 bytes (256
# bf16), 16-way; a token's embedding row is 28 lines.
CACHE_CFG = CacheConfig(line_width_bits=4096, num_lines=32768,
                        associativity=16)
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
NONTENSOR_OPS_PER_S = 67e12      # H100 SXM float32 rate outside tensor cores
WARMUP, REPS = 3, 20


def say(**fields) -> None:
    print(json.dumps(fields), flush=True)


def time_ms(fn, reps: int = REPS) -> float:
    """Median CUDA-event time of one call, after warm-up."""
    for _ in range(min(WARMUP, reps)):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def ulps(a: torch.Tensor, b: torch.Tensor) -> float:
    """Max |a - b| in units of one ulp (of a's dtype, bf16 or f16) of the
    larger magnitude."""
    bits, floor = {torch.bfloat16: (8, -133), torch.float16: (11, -24)}[a.dtype]
    a, b = a.float(), b.float()
    _, exp = torch.frexp(torch.maximum(a.abs(), b.abs()))
    ulp = torch.ldexp(torch.ones_like(a), (exp - bits).clamp(min=floor))
    return float(((a - b).abs() / ulp).max())


def check_mixed_add(got, want, got32, want32) -> dict:
    """Hold an ``add`` of float32 values into a bf16 or f16 table.

    ``got`` and ``want`` are the kernel's and the plain version's results;
    ``got32`` and ``want32`` are theirs for the same values added into the
    table converted to float32 (exact), where the kernel sums each run in
    the same order. The kernel's result must be its float32 sum rounded
    once, bit for bit, and that sum must agree with the plain version's
    within float32 reassociation (rtol = atol = 1e-5, as for float32
    tables). Where a row and its run cancel to near zero one bf16 ulp is
    far below that reassociation, so ``got`` and ``want`` are not held to
    each other in ulps; their raw disagreement is returned, with the
    plain result's magnitude where it is largest."""
    assert same_bits(got, got32.to(got.dtype)), \
        f"add into {got.dtype}: not the kernel's float32 sum rounded once"
    assert torch.allclose(got32, want32, rtol=1e-5, atol=1e-5), \
        f"add into {got.dtype}: float32 sums differ beyond reassociation"
    diff = (got.double() - want.double()).abs().reshape(-1)
    at = int(diff.argmax())
    return dict(max_abs_err=float(diff[at]),
                plain_there=float(want.reshape(-1)[at]),
                ulps=ulps(got, want),
                f32_sum_max_abs_err=float(
                    (got32.double() - want32.double()).abs().max()))


def zipf_ids(rng: np.random.Generator, shape) -> np.ndarray:
    """Zipf(ZIPF_S) token ids over the vocabulary, ranks scattered over
    the table by a random permutation."""
    p = np.arange(1, VOCAB + 1, dtype=np.float64) ** -ZIPF_S
    token_of_rank = rng.permutation(VOCAB)
    return token_of_rank[rng.choice(VOCAB, size=shape, p=p / p.sum())]


def prefill_ids() -> np.ndarray:
    """The main path's prefill batch of token ids, (BATCH, SEQ)."""
    return zipf_ids(np.random.default_rng(SEED), (BATCH, SEQ))


def line_elems() -> int:
    return CACHE_CFG.line_bytes // 2             # bf16 elements of a line


def token_lines(tokens: np.ndarray) -> np.ndarray:
    """Each token's embedding row as its consecutive cache lines, in
    order: the line ids the cache engine serves for a token sequence."""
    per_row = D_MODEL // line_elems()
    return (tokens[:, None] * per_row + np.arange(per_row)).reshape(-1)


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))


def probe_bytes(n: int, sets: int, ways: int) -> int:
    """Bytes the cache probe must move: the line ids read, the state
    (tags, valid bits, ages, clock) read and written, hits and ways
    written."""
    return 4 * n + 2 * (3 * 4 * sets * ways + 4) + 8 * n


def check_dma(dev, gen) -> None:
    """B4, the staged copy, bit for bit against its plain version."""
    def rand(dtype, shape):
        if dtype.is_floating_point:
            return torch.randn(shape, generator=gen, device=dev).to(dtype)
        hi = 256 if dtype == torch.uint8 else 1 << 30
        return torch.randint(0, hi, shape, generator=gen, device=dev,
                             dtype=dtype)

    def both(src, chunk, channels):
        got = dc_kernel.staged_copy(torch.empty_like(src), src,
                                    chunk_elems=chunk, channels=channels)
        want = dc_kernel.staged_copy_plain(torch.empty_like(src), src)
        assert same_bits(got, want), \
            f"dma_copy {src.dtype} n={src.numel()} chunk={chunk} " \
            f"channels={channels}"

    # Dtypes x channels x transaction sizes (256 B to the Table I maximum
    # of 256 KB); 1,000,003 elements leave a ragged last chunk.
    for dtype in (torch.bfloat16, torch.float32, torch.int32, torch.uint8):
        src = rand(dtype, (1_000_003,))
        for channels in (1, 4, 8):
            for txn in (256, 16384, 262144):
                both(src, dc_ops.chunk_elems(DMAConfig(
                    max_transaction_bytes=txn), src.element_size()),
                    channels)
    # More channels than chunks: 100 elements, one chunk, eight slots.
    both(rand(torch.float32, (100,)), 65536, 8)
    # The main path's shape: one FFN weight at PAPER_EVAL_CONFIG.
    w = rand(torch.bfloat16, FFN_SHAPE)
    cfg = PAPER_EVAL_CONFIG.dma
    assert same_bits(dc_ops.dma_copy(w, config=cfg), w), \
        "dma_copy at the FFN weight"
    # A bulk write at an odd bf16 offset: a 2-byte aligned destination,
    # and a float32 source cast to bf16 first.
    dst, src = rand(torch.bfloat16, (3, 1000, 7)), rand(torch.float32, (5001,))
    for offset in (777, 15_998):
        got = dma_engine.bulk_write(dst, src, config=cfg, offset_elems=offset,
                                    use_kernels=True)
        want = dma_engine.bulk_write(dst, src, config=cfg,
                                     offset_elems=offset, use_kernels=False)
        assert same_bits(got, want), f"bulk_write at offset {offset}"


def check_cache(dev) -> None:
    """B5, the cache probe, against its plain version over the whole
    trajectory: hits, ways, tags', valid', age' and clock'."""
    rng = np.random.default_rng(SEED + 3)
    names = ("hits", "ways", "tags", "valid", "age", "clock")

    def both(ids_np, state):
        ids = torch.from_numpy(ids_np.astype(np.int32)).to(dev)
        got = cl_kernel.cache_probe(ids, *state)
        want = cl_kernel.cache_probe_plain(ids, *state)
        for name, g, w in zip(names, got, want):
            assert g.dtype == w.dtype and torch.equal(g, w), \
                f"cache_probe {name}, {state[0].shape}, n={ids.numel()}"
        return got[2:]                  # the new state, to go on from

    def empty(cfg):
        st0 = init_cache(cfg, 1, device=dev)
        return st0.tags, st0.valid.to(torch.int32), st0.age, \
            st0.clock.reshape(1)

    main = token_lines(prefill_ids()[0])
    other = token_lines(prefill_ids()[1])
    for cfg in (PAPER_EVAL_CONFIG.cache, CACHE_CFG):
        # The main path's stream, then a second sequence from the state it
        # left (a non-empty starting state).
        both(other, both(main, empty(cfg)))
        # A stream that hammers one set: 40 tags of set 7, in random order.
        sets = cfg.num_sets
        both(7 + sets * rng.integers(0, 40, 6000), empty(cfg))


def check_kernels(dev, gen):
    """Phase 3: every kernel against its plain version, on the card.
    Returns each kernel's max_abs_err and the mixed-dtype adds' readings."""
    errs = {"bitonic_sort": 0.0, "sorted_gather": 0.0, "sorted_scatter": 0.0}
    mixed = {}
    rng = np.random.default_rng(SEED + 1)
    i32max = torch.iinfo(torch.int32).max

    def ints(lo, hi, shape):
        if hi == "zipf":        # the main path's token ids
            return torch.from_numpy(zipf_ids(rng, shape).astype(
                np.int32)).to(dev)
        return torch.from_numpy(rng.integers(lo, hi, shape).astype(
            np.int32)).to(dev)

    n_main = BATCH * SEQ
    # B1: the network, kernel vs the plain stage loop, then the padded op
    # vs torch's stable sort (duplicates, real INT32_MAX keys, odd N).
    for shape, hi in [((n_main // SCHED_BATCH, SCHED_BATCH), "zipf"),
                      ((1, n_main), "zipf"), ((3, 1024), 4), ((1, 2), 2)]:
        keys, vals = ints(0, hi, shape), ints(0, 1 << 30, shape)
        ids = torch.arange(shape[1], dtype=torch.int32,
                           device=dev).expand(shape).contiguous()
        got = bs_kernel.bitonic_sort_batched(keys, vals)
        want = bs_kernel.sort_network(keys, ids, vals)
        for g, w in zip(got, want):
            assert torch.equal(g, w), f"bitonic_sort {shape} != plain"
    for n in (1000, 32768 - 5, 1):
        keys = ints(0, 8, (n,))
        keys[rng.integers(0, n, max(1, n // 10))] = i32max
        skeys, perm = bs_ops.sort_with_indices(keys)
        ref_keys, ref_perm = torch.sort(keys, stable=True)
        assert torch.equal(skeys, ref_keys), f"sort keys n={n}"
        assert torch.equal(perm.long(), ref_perm), f"sort perm n={n}"

    # B2: gather at the main path's shape (the full table, the prefill
    # batch's Zipf ids), then over dtypes and row pitches (access widths
    # 16 .. 1).
    for dtype, rows, d, n, hi in [
            (torch.bfloat16, VOCAB, D_MODEL, n_main, "zipf"),
            (torch.float32, 1000, 33, 5000, 1000),
            (torch.bfloat16, 300, 7, 5000, 300),
            (torch.int32, 200, 3, 5000, 200), (torch.uint8, 50, 5, 5000, 50)]:
        if dtype.is_floating_point:
            table = torch.randn((rows, d), generator=gen, device=dev,
                                dtype=dtype)
        else:
            table = ints(0, 100, (rows, d)).to(dtype)
        sidx = torch.sort(ints(0, hi, (n,))).values
        got = sg_kernel.gather_rows(table, sidx)
        assert torch.equal(got, sg_kernel.gather_rows_plain(table, sidx)), \
            f"gather {dtype} d={d}"

    # B3: set bit-equal; add within the stated tolerance; first at the main
    # path's shape, where a hot token's run is thousands of rows long.
    for dtype, rows, d, n, hi in [(torch.bfloat16, VOCAB, D_MODEL, n_main,
                                   "zipf"),
                                  (torch.bfloat16, 4096, D_MODEL, 8192, 512),
                                  (torch.float32, 2048, 256, 8192, 64),
                                  (torch.float64, 64, 33, 2000, 8),
                                  (torch.float16, 128, 70, 500, 16),
                                  (torch.int32, 100, 3, 300, 10)]:
        if dtype.is_floating_point:
            table = torch.randn((rows, d), generator=gen, device=dev,
                                dtype=dtype)
            vals = torch.randn((n, d), generator=gen, device=dev,
                               dtype=dtype)
        else:
            table = ints(0, 100, (rows, d))
            vals = ints(0, 100, (n, d))
        sidx = torch.sort(ints(0, hi, (n,))).values
        got = ss_kernel.scatter_rows(table, sidx, vals, mode="set")
        want = ss_kernel.scatter_rows_plain(table, sidx, vals, mode="set")
        assert torch.equal(got, want), f"scatter set {dtype}"
        if not dtype.is_floating_point:
            continue
        got = ss_kernel.scatter_rows(table, sidx, vals, mode="add")
        want = ss_kernel.scatter_rows_plain(table, sidx, vals, mode="add")
        err = float((got.double() - want.double()).abs().max())
        if dtype in (torch.bfloat16, torch.float16):
            assert ulps(got, want) <= 1.0, f"scatter add {dtype} > 1 ulp"
        else:
            assert torch.allclose(got, want, rtol=1e-5, atol=1e-5), \
                f"scatter add {dtype}"
        errs["sorted_scatter"] = max(errs["sorted_scatter"], err)
    # B3 add with values of another dtype than the table (the repaired
    # path): float32 gradients into bf16 and f16 tables, int32 and float32
    # values into an int32 table (integer-valued, so every sum is exact
    # and the truncation toward zero is the same on both).
    for tdtype, vdtype, rows, d, n, hi in [
            (torch.bfloat16, torch.float32, VOCAB, D_MODEL, n_main, "zipf"),
            (torch.float16, torch.float32, 128, 70, 500, 16),
            (torch.int32, torch.int32, 100, 3, 300, 10),
            (torch.int32, torch.float32, 100, 3, 300, 10)]:
        if tdtype.is_floating_point:
            table = torch.randn((rows, d), generator=gen, device=dev,
                                dtype=tdtype)
            vals = (torch.randn((n, d), generator=gen, device=dev)
                    * 1e-2).to(vdtype)
        else:
            table = ints(-100, 100, (rows, d))
            vals = ints(-100, 100, (n, d)).to(vdtype)
        sidx = torch.sort(ints(0, hi, (n,))).values
        got = ss_kernel.scatter_rows(table, sidx, vals, mode="add")
        want = ss_kernel.scatter_rows_plain(table, sidx, vals, mode="add")
        if tdtype == torch.int32:
            assert torch.equal(got, want), f"scatter add {vdtype} -> int32"
        else:
            t32 = table.float()
            mixed[f"{vdtype} -> {tdtype} {rows}x{d} n={n}"] = check_mixed_add(
                got, want,
                ss_kernel.scatter_rows(t32, sidx, vals, mode="add"),
                ss_kernel.scatter_rows_plain(t32, sidx, vals, mode="add"))
        errs["sorted_scatter"] = max(errs["sorted_scatter"], float(
            (got.double() - want.double()).abs().max()))
    check_dma(dev, gen)
    check_cache(dev)
    errs["dma_copy"] = errs["cache_lookup"] = 0.0   # bit-equal, asserted
    torch.cuda.synchronize()
    return errs, mixed


def run_slice(dev, gen) -> dict:
    """Phase 4: the main path at full width, through the user's entry
    points, with every launch counter zeroed before and read after."""
    ids_np = prefill_ids()
    idx = torch.from_numpy(ids_np).to(dev)
    uniq, counts = np.unique(ids_np, return_counts=True)
    hot_ids = uniq[np.argsort(-counts, kind="stable")[:HOT_ROWS]]
    table = torch.randn((VOCAB, D_MODEL), generator=gen, device=dev,
                        dtype=torch.bfloat16)
    vals = torch.randn((BATCH, SEQ, D_MODEL), generator=gen, device=dev,
                       dtype=torch.bfloat16)
    grads32 = torch.randn((BATCH, SEQ, D_MODEL), generator=gen,
                          device=dev) * 1e-2
    grads = grads32.to(torch.bfloat16)
    mc = MemoryController(PAPER_EVAL_CONFIG, device=dev)   # kernels on
    hot = HotRowCache.build(table, hot_ids)
    torch.cuda.synchronize()

    zero_launches()
    t0 = time.perf_counter()
    out = mc.gather(table, idx)
    cached = mc.cached_gather(table, idx, hot)
    t_set = mc.scatter(table, idx, vals)
    t_add = mc.scatter(table, idx, grads, mode="add")
    t_cached, hot2 = mc.cached_scatter(table, idx, grads, hot, mode="add")
    t_add32 = mc.scatter(table, idx, grads32, mode="add")
    batches = sort_requests(idx.reshape(-1, SCHED_BATCH))
    stream = sort_requests(idx.reshape(-1))
    torch.cuda.synchronize()
    slice_s = time.perf_counter() - t0
    launches = read_launches("scheduler")

    ref = table[idx]
    assert out.shape == (BATCH, SEQ, D_MODEL) and torch.equal(out, ref), \
        "gather != table[idx]"
    assert torch.equal(cached, ref), "cached_gather != table[idx]"
    assert bool(torch.isfinite(out).all()), "gather: non-finite rows"
    plain = MemoryController(PAPER_EVAL_CONFIG, use_kernels=False, device=dev)
    assert torch.equal(t_set, plain.scatter(table, idx, vals)), \
        "scatter set != plain path"
    add_ref = plain.scatter(table, idx, grads, mode="add")
    add_ulps = ulps(t_add, add_ref)
    assert add_ulps <= 1.0, f"scatter add off by {add_ulps} bf16 ulp"
    assert torch.equal(t_cached, t_add), "cached_scatter != scatter"
    table32 = table.float()
    add32 = check_mixed_add(
        t_add32, plain.scatter(table, idx, grads32, mode="add"),
        mc.scatter(table32, idx, grads32, mode="add"),
        plain.scatter(table32, idx, grads32, mode="add"))
    del table32
    assert torch.equal(hot2.hot_data, t_add[hot.hot_ids.long()]), \
        "cached_scatter did not re-pin"
    assert bool(torch.isfinite(t_add.float()).all()), "scatter add: non-finite"
    for (skeys, perm, inv), keys in [(batches, idx.reshape(-1, SCHED_BATCH)),
                                     (stream, idx.reshape(-1))]:
        want_keys, want_perm = torch.sort(keys, stable=True)
        assert torch.equal(skeys.long(), want_keys), "sort_requests keys"
        assert torch.equal(perm.long(), want_perm), "sort_requests perm"
        assert torch.equal(torch.gather(perm, -1, inv.long()).long(),
                           torch.arange(keys.shape[-1], device=dev).expand(
                               keys.shape)), "inv_perm is not the inverse"

    # A small case against a numpy oracle of the in-order write stream.
    small = np.random.default_rng(SEED + 2)
    tab = small.standard_normal((50, 6)).astype(np.float32)
    ix = small.integers(0, 50, 200)
    vx = small.standard_normal((200, 6)).astype(np.float32)
    want_set, want_add = tab.copy(), tab.astype(np.float64)
    for i, r in enumerate(ix):
        want_set[r] = vx[i]
        want_add[r] += vx[i]
    tt, it, vt = (torch.from_numpy(a).to(dev) for a in (tab, ix, vx))
    assert np.array_equal(mc.gather(tt, it).cpu().numpy(), tab[ix])
    assert np.array_equal(mc.scatter(tt, it, vt).cpu().numpy(), want_set)
    np.testing.assert_allclose(mc.scatter(tt, it, vt, mode="add").cpu().numpy(),
                               want_add, rtol=1e-5, atol=1e-5)

    sidx, perm = torch.sort(idx.reshape(-1), stable=True)
    return dict(table=table, idx=idx, sidx=sidx, svals=vals.reshape(-1, D_MODEL)[perm],
                sgrads=grads.reshape(-1, D_MODEL)[perm],
                sgrads32=grads32.reshape(-1, D_MODEL)[perm], launches=launches,
                slice_s=slice_s, add_ulps=add_ulps, add32=add32,
                distinct=int(uniq.size), hot_hits=int(
                    hot.hit_mask(idx).sum()))


def zero_launches() -> None:
    for lib in LIBS.values():
        lib.launches = 0


def read_launches(path: str) -> dict:
    """Every kernel's count since ``zero_launches``; each kernel of
    ``path`` must have run."""
    launches = {name: lib.launches for name, lib in LIBS.items()}
    for name, of in PATH_OF.items():
        assert of != path or launches[name] > 0, \
            f"kernel {name} did not run on the {path} path"
    return launches


def run_bulk(dev, gen) -> dict:
    """Phase 4, bulk path: ``bulk_read`` of an FFN weight and
    ``bulk_write`` of one layer's prefill K and V into a KV cache."""
    w = torch.randn(FFN_SHAPE, generator=gen, device=dev, dtype=torch.bfloat16)
    kv = torch.randn(KV_SHAPE, generator=gen, device=dev, dtype=torch.bfloat16)
    layer_kv = torch.randn(KV_SHAPE[1:], generator=gen, device=dev,
                           dtype=torch.bfloat16)
    offset = KV_LAYER * layer_kv.numel()
    mc = MemoryController(PAPER_EVAL_CONFIG, device=dev)
    torch.cuda.synchronize()

    zero_launches()
    t0 = time.perf_counter()
    w_out = mc.bulk_read(w)
    kv_out = mc.bulk_write(kv, layer_kv, offset_elems=offset)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches("bulk")

    assert same_bits(w_out, w) and w_out.data_ptr() != w.data_ptr(), \
        "bulk_read != its source"
    plain = MemoryController(PAPER_EVAL_CONFIG, use_kernels=False, device=dev)
    assert same_bits(kv_out, plain.bulk_write(kv, layer_kv,
                                              offset_elems=offset)), \
        "bulk_write != plain path"
    flat = kv.clone()
    flat.view(-1)[offset:offset + layer_kv.numel()] = layer_kv.view(-1)
    assert same_bits(kv_out, flat), "bulk_write != flat slice assignment"
    assert same_bits(kv_out[KV_LAYER], layer_kv), "layer not written"
    return dict(w=w, kv=kv, layer_kv=layer_kv, offset=offset,
                launches=launches, seconds=seconds)


def run_cache(dev, table) -> dict:
    """Phase 4, cache path: ``cache_service`` of the embedding table's
    lines for sequence 0 of the prefill batch."""
    lines_tab = table.view(-1, line_elems())
    ids_np = token_lines(prefill_ids()[0])
    ids = torch.from_numpy(ids_np.astype(np.int32)).to(dev)
    state = init_cache(CACHE_CFG, line_elems(), torch.bfloat16, device=dev)
    torch.cuda.synchronize()

    zero_launches()
    t0 = time.perf_counter()
    lines, hits, new = cl_ops.cache_service(lines_tab, ids, state)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches("cache")

    ids64 = ids.long()
    assert same_bits(lines, lines_tab[ids64]), "lines != table[line_ids]"
    want_hits, rate = hit_rate_oracle(CACHE_CFG, ids_np)
    assert np.array_equal(hits.cpu().numpy(), want_hits), \
        "hits != hit_rate_oracle"
    p = cl_kernel.cache_probe_plain(ids, state.tags,
                                    state.valid.to(torch.int32), state.age,
                                    state.clock)
    assert torch.equal(hits, p[0] != 0) and torch.equal(new.tags, p[2]) \
        and torch.equal(new.valid, p[3] != 0) and torch.equal(new.age, p[4]) \
        and int(new.clock) == int(p[5]) == ids.numel(), \
        "cache state != the plain probe's"
    sets, ways = state.tags.shape
    slot = (ids64 % sets) * ways + p[1].long()
    data = scatter_set_last(state.data.view(sets * ways, -1), slot,
                            lines_tab[ids64]).view(state.data.shape)
    assert same_bits(new.data, data), "Data RAM != last-writer scatter"
    assert not bool(new.dirty.any()), "a read stream left a dirty way"
    per_set = np.bincount(ids_np % sets, minlength=sets)
    return dict(lines_tab=lines_tab, ids=ids, state=state, launches=launches,
                seconds=seconds, hit_rate=rate,
                max_beats_per_set=int(per_set.max()))


def timings(dev, s) -> dict:
    """Phase 5: kernel, plain and library medians beside the bound."""
    table, sidx, svals, sgrads = s["table"], s["sidx"], s["svals"], s["sgrads"]
    n, rows = sidx.shape[0], table.shape[0]
    rb = table.shape[1] * table.element_size()
    distinct = s["distinct"]
    res = {}

    sort = {}
    for shape in [(BATCH * SEQ // SCHED_BATCH, SCHED_BATCH),
                  (1, BATCH * SEQ)]:
        keys = s["idx"].to(torch.int32).reshape(shape).contiguous()
        vals = torch.arange(n, dtype=torch.int32,
                            device=dev).reshape(shape).contiguous()
        ids = torch.arange(shape[1], dtype=torch.int32,
                           device=dev).expand(shape).contiguous()
        g, m = shape
        stages = (m.bit_length() - 1) * m.bit_length() // 2
        bytes_moved = 4 * g * m * 5
        ops = g * (m // 2) * stages
        bound = max(bytes_moved / HBM_BYTES_PER_S,
                    ops / NONTENSOR_OPS_PER_S) * 1e3
        sort[f"{g}x{m}"] = dict(
            ms=time_ms(lambda: bs_kernel.bitonic_sort_batched(keys, vals)),
            plain_ms=time_ms(lambda: bs_kernel.sort_network(keys, ids, vals)),
            library_ms=time_ms(lambda: torch.sort(keys, dim=-1, stable=True)),
            bound_ms=bound,
            bound_by=("bytes" if bytes_moved / HBM_BYTES_PER_S
                      >= ops / NONTENSOR_OPS_PER_S else "operations"),
            stages=stages)
    res["bitonic_sort"] = sort

    sidx32 = sidx.to(torch.int32)
    gather_bytes = 4 * n + distinct * rb + n * rb
    res["sorted_gather"] = {f"{n}x{table.shape[1]}": dict(
        ms=time_ms(lambda: sg_kernel.gather_rows(table, sidx32)),
        plain_ms=time_ms(lambda: sg_kernel.gather_rows_plain(table, sidx32)),
        library_ms=time_ms(lambda: torch.index_select(table, 0, sidx32)),
        bound_ms=gather_bytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes")}

    keep = ss_kernel.last_of_run(sidx32)
    last_rows, last_vals = sidx[keep], svals[keep]
    scatter = {}
    for mode, v in (("set", svals), ("add", sgrads)):
        # The function returns a new table: read it and write it once,
        # plus the indices, plus the winning rows (set) or every row (add).
        val_bytes = distinct * rb if mode == "set" else n * rb
        fn_bytes = 2 * rows * rb + 4 * n + val_bytes
        if mode == "set":
            lib = lambda: table.clone().index_copy_(0, last_rows, last_vals)
        else:
            lib = lambda: table.clone().index_add_(0, sidx, sgrads)
        work = table.clone()
        entry = "scatter_set_rows" if mode == "set" else "scatter_add_runs"
        code = ss_kernel.ADD_DTYPES[table.dtype]
        args = ((rb,) if mode == "set" else (table.shape[1], code, code))
        stream = torch.cuda.current_stream(dev).cuda_stream
        inplace_bytes = 4 * n + val_bytes + (2 if mode == "add" else 1) \
            * distinct * rb
        scatter[mode] = dict(
            ms=time_ms(lambda: ss_kernel.scatter_rows(table, sidx32, v,
                                                      mode=mode)),
            plain_ms=time_ms(lambda: ss_kernel.scatter_rows_plain(
                table, sidx32, v, mode=mode)),
            library_ms=time_ms(lib),
            bound_ms=fn_bytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
            inplace_ms=time_ms(lambda: ss_kernel.LIB.launch(
                entry, work.data_ptr(), sidx32.data_ptr(), v.data_ptr(), n,
                *args, stream)),
            inplace_bound_ms=inplace_bytes / HBM_BYTES_PER_S * 1e3)
    # The repaired add: float32 gradients into the bf16 table. The library
    # call computes the same function at float32 and rounds once.
    sg32 = s["sgrads32"]
    scatter["add_f32"] = dict(
        ms=time_ms(lambda: ss_kernel.scatter_rows(table, sidx32, sg32,
                                                  mode="add")),
        plain_ms=time_ms(lambda: ss_kernel.scatter_rows_plain(
            table, sidx32, sg32, mode="add")),
        library_ms=time_ms(lambda: table.float().index_add_(
            0, sidx, sg32).to(table.dtype)),
        bound_ms=(2 * rows * rb + 4 * n + sg32.numel() * 4)
        / HBM_BYTES_PER_S * 1e3, bound_by="bytes")
    res["sorted_scatter"] = scatter
    return res


def timings_bulk(dev, b) -> dict:
    """Phase 5, B4: ``bulk_read`` and ``bulk_write`` (the whole function,
    which returns a new KV cache, and its in-place staged copy)."""
    cfg = PAPER_EVAL_CONFIG.dma
    w, kv, layer_kv, offset = b["w"], b["kv"], b["layer_kv"], b["offset"]
    n = layer_kv.numel()
    w_bytes, kv_bytes = w.numel() * 2, kv.numel() * 2
    layer_bytes = n * 2

    def library_write():
        out = kv.clone()
        out.view(-1)[offset:offset + n].copy_(layer_kv.view(-1))
        return out

    region = kv.clone().view(-1)[offset:offset + n]
    src = layer_kv.reshape(-1)
    chunk = dc_ops.chunk_elems(cfg, 2)
    write = dict(
        ms=time_ms(lambda: dma_engine.bulk_write(
            kv, layer_kv, config=cfg, offset_elems=offset, use_kernels=True)),
        plain_ms=time_ms(lambda: dma_engine.bulk_write(
            kv, layer_kv, config=cfg, offset_elems=offset,
            use_kernels=False)),
        library_ms=time_ms(library_write),
        # The cache outside the region and the layer read once, the new
        # cache written once: twice the cache's bytes.
        bound_ms=2 * kv_bytes / HBM_BYTES_PER_S * 1e3,
        bound_by="bytes",
        inplace_ms=time_ms(lambda: dc_kernel.staged_copy(
            region, src, chunk_elems=chunk, channels=cfg.num_parallel_dma)),
        inplace_plain_ms=time_ms(lambda: dc_kernel.staged_copy_plain(
            region, src)),
        inplace_bound_ms=2 * layer_bytes / HBM_BYTES_PER_S * 1e3)
    read = dict(
        ms=time_ms(lambda: dma_engine.bulk_copy(w, config=cfg,
                                                use_kernels=True)),
        plain_ms=time_ms(lambda: dma_engine.bulk_copy(w, config=cfg,
                                                      use_kernels=False)),
        library_ms=time_ms(lambda: w.clone()),
        bound_ms=2 * w_bytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes")
    return {f"bulk_read {'x'.join(map(str, FFN_SHAPE))}": read,
            f"bulk_write {'x'.join(map(str, KV_SHAPE[1:]))} into "
            f"{'x'.join(map(str, KV_SHAPE))}": write}


def timings_cache(dev, c) -> dict:
    """Phase 5, B5: the probe (wrapper: grouping by set and the kernel;
    and the kernel alone) and ``cache_service`` at the cache path."""
    ids, state, lines_tab = c["ids"], c["state"], c["lines_tab"]
    args = (ids, state.tags, state.valid.to(torch.int32), state.age,
            state.clock)
    sets, ways = state.tags.shape
    n = ids.numel()
    order, start = cl_kernel.group_by_set(ids % sets, sets)
    order, start = order.to(torch.int32), start.to(torch.int32)
    outs = [torch.empty(n, dtype=torch.int32, device=dev) for _ in range(2)] \
        + [torch.empty_like(state.tags) for _ in range(3)] \
        + [torch.empty(1, dtype=torch.int32, device=dev)]
    stream = torch.cuda.current_stream(dev).cuda_stream
    raw = (ids.data_ptr(), order.data_ptr(), start.data_ptr(),
           *(a.data_ptr() for a in args[1:4]), args[4].data_ptr(),
           *(o.data_ptr() for o in outs), sets, ways, n, stream)
    nbytes = probe_bytes(n, sets, ways)
    return {f"probe {n} beats, {sets} sets x {ways} ways": dict(
        ms=time_ms(lambda: cl_kernel.cache_probe(*args)),
        plain_ms=time_ms(lambda: cl_kernel.cache_probe_plain(*args), reps=3),
        library_ms=None,
        bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        kernel_only_ms=time_ms(lambda: cl_kernel.LIB.launch(
            "cache_probe", *raw)),
        service_ms=time_ms(lambda: cl_ops.cache_service(lines_tab, ids,
                                                        state)),
        max_beats_per_set=c["max_beats_per_set"])}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on a CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    say(phase="device", kind=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda)
    run(torch.device("cuda", 0))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def run(dev) -> None:
    """Phases 2-5 on ``dev``; prints the ``{"kernels": [...]}`` line."""
    t0 = time.perf_counter()
    reports = _build.build()
    say(phase="build", seconds=time.perf_counter() - t0,
        kernels_built=sorted(reports))
    for name, text in reports.items():
        for line in text.splitlines():
            if "registers" in line or "error" in line.lower():
                print(f"  ptxas[{name}]: {line.strip()}", flush=True)

    gen = torch.Generator(device=dev).manual_seed(SEED)
    errs, mixed = check_kernels(dev, gen)
    say(phase="kernels_vs_plain", max_abs_err=errs, mixed_add=mixed)

    s = run_slice(dev, gen)
    say(phase="slice", path="scheduler", seconds=s["slice_s"],
        launches=s["launches"], distinct_rows=s["distinct"],
        hot_hits=s["hot_hits"], add_max_bf16_ulps=s["add_ulps"],
        add_f32=s["add32"],
        peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
    b = run_bulk(dev, gen)
    say(phase="slice", path="bulk", seconds=b["seconds"],
        launches=b["launches"],
        bytes_read=b["w"].numel() * 2, bytes_written=b["layer_kv"].numel() * 2)
    c = run_cache(dev, s["table"])
    say(phase="slice", path="cache", seconds=c["seconds"],
        launches=c["launches"], beats=c["ids"].numel(),
        hit_rate=c["hit_rate"], max_beats_per_set=c["max_beats_per_set"],
        peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
    launches = {"scheduler": s["launches"], "bulk": b["launches"],
                "cache": c["launches"]}
    launches = {name: launches[path][name] for name, path in PATH_OF.items()}

    t = timings(dev, s)
    t["dma_copy"] = timings_bulk(dev, b)
    t["cache_lookup"] = timings_cache(dev, c)
    for name, shapes in t.items():
        for shape, row in shapes.items():
            say(phase="timing", kernel=name, shape=shape,
                kernel_ms=row["ms"],
                **{k: v for k, v in row.items() if k != "ms"},
                launches=launches[name])

    main_row = {"bitonic_sort": t["bitonic_sort"][f"1x{BATCH * SEQ}"],
                "sorted_gather": t["sorted_gather"][f"{BATCH * SEQ}x{D_MODEL}"],
                "sorted_scatter": t["sorted_scatter"]["add"],
                "dma_copy": next(iter(t["dma_copy"].values())),
                "cache_lookup": next(iter(t["cache_lookup"].values()))}
    kernels = []
    for name in LIBS:
        row = main_row[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": errs[name], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "variants": t[name]})
    print(json.dumps({"kernels": kernels}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
