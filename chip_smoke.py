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
   the slice's shapes and at the edge cases: sort, gather and ``set`` must
   be bit-equal, ``add`` within float32 reassociation (rtol = atol = 1e-5)
   for float32 and float64 tables and within one bf16 ulp for bf16.
4. slice — the controller's data plane at the yi-34b embedding table
   (vocab 64000 x d_model 7168, bf16, random from a seed) under a prefill
   batch of 8 x 4096 Zipf(1.1) token ids: ``MemoryController.gather``,
   ``cached_gather`` (4096 hottest ids pinned), ``scatter`` set and add
   (the embedding-gradient write), ``cached_scatter``, and
   ``sort_requests`` as 64 x 512 scheduler batches and as one 1-D row.
   Every launch counter is zeroed just before and read just after; each
   kernel must have run. Outputs are held to ``table[idx]`` and the plain
   paths, and a small case to a numpy oracle.
5. timing — per kernel at the slice's shapes: the CUDA-event median of
   the kernel's wrapper, its plain version and one PyTorch library call
   computing the same function, beside the least time the card could
   take (bytes over 3.35 TB/s, or operations over the peak rate).

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

from repro_torch.core import HotRowCache, MemoryController, PAPER_EVAL_CONFIG  # noqa: E402
from repro_torch.core.scheduler import sort_requests  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.bitonic_sort import kernel as bs_kernel  # noqa: E402
from repro_torch.kernels.bitonic_sort import ops as bs_ops  # noqa: E402
from repro_torch.kernels.sorted_gather import kernel as sg_kernel  # noqa: E402
from repro_torch.kernels.sorted_scatter import kernel as ss_kernel  # noqa: E402

LIBS = {"bitonic_sort": bs_kernel.LIB, "sorted_gather": sg_kernel.LIB,
        "sorted_scatter": ss_kernel.LIB}
REPLACES = {"bitonic_sort": "src/repro/kernels/bitonic_sort/kernel.py:85",
            "sorted_gather": "src/repro/kernels/sorted_gather/kernel.py:34",
            "sorted_scatter": "src/repro/kernels/sorted_scatter/kernel.py:38"}
SEED = 0
VOCAB, D_MODEL = 64000, 7168     # yi-34b (src/repro/configs/yi_34b.py), bf16
BATCH, SEQ = 8, 4096             # one prefill batch of token ids
ZIPF_S = 1.1
HOT_ROWS = 4096
SCHED_BATCH = 512                # the scheduler's largest batch (Table I)
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
NONTENSOR_OPS_PER_S = 67e12      # H100 SXM float32 rate outside tensor cores
WARMUP, REPS = 3, 20


def say(**fields) -> None:
    print(json.dumps(fields), flush=True)


def time_ms(fn) -> float:
    """Median CUDA-event time of one call, after warm-up."""
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
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


def zipf_ids(rng: np.random.Generator, shape) -> np.ndarray:
    """Zipf(ZIPF_S) token ids over the vocabulary, ranks scattered over
    the table by a random permutation."""
    p = np.arange(1, VOCAB + 1, dtype=np.float64) ** -ZIPF_S
    token_of_rank = rng.permutation(VOCAB)
    return token_of_rank[rng.choice(VOCAB, size=shape, p=p / p.sum())]


def check_kernels(dev, gen) -> dict:
    """Phase 3: every kernel against its plain version, on the card."""
    errs = {"bitonic_sort": 0.0, "sorted_gather": 0.0, "sorted_scatter": 0.0}
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
    torch.cuda.synchronize()
    return errs


def run_slice(dev, gen) -> dict:
    """Phase 4: the main path at full width, through the user's entry
    points, with every launch counter zeroed before and read after."""
    rng = np.random.default_rng(SEED)
    ids_np = zipf_ids(rng, (BATCH, SEQ))
    idx = torch.from_numpy(ids_np).to(dev)
    uniq, counts = np.unique(ids_np, return_counts=True)
    hot_ids = uniq[np.argsort(-counts, kind="stable")[:HOT_ROWS]]
    table = torch.randn((VOCAB, D_MODEL), generator=gen, device=dev,
                        dtype=torch.bfloat16)
    vals = torch.randn((BATCH, SEQ, D_MODEL), generator=gen, device=dev,
                       dtype=torch.bfloat16)
    grads = (torch.randn((BATCH, SEQ, D_MODEL), generator=gen, device=dev)
             * 1e-2).to(torch.bfloat16)
    mc = MemoryController(PAPER_EVAL_CONFIG)          # kernels on, CUDA
    hot = HotRowCache.build(table, hot_ids)
    torch.cuda.synchronize()

    for lib in LIBS.values():
        lib.launches = 0
    t0 = time.perf_counter()
    out = mc.gather(table, idx)
    cached = mc.cached_gather(table, idx, hot)
    t_set = mc.scatter(table, idx, vals)
    t_add = mc.scatter(table, idx, grads, mode="add")
    t_cached, hot2 = mc.cached_scatter(table, idx, grads, hot, mode="add")
    batches = sort_requests(idx.reshape(-1, SCHED_BATCH))
    stream = sort_requests(idx.reshape(-1))
    torch.cuda.synchronize()
    slice_s = time.perf_counter() - t0
    launches = {name: lib.launches for name, lib in LIBS.items()}
    for name, count in launches.items():
        assert count > 0, f"kernel {name} did not run on the main path"

    ref = table[idx]
    assert out.shape == (BATCH, SEQ, D_MODEL) and torch.equal(out, ref), \
        "gather != table[idx]"
    assert torch.equal(cached, ref), "cached_gather != table[idx]"
    assert bool(torch.isfinite(out).all()), "gather: non-finite rows"
    plain = MemoryController(PAPER_EVAL_CONFIG, use_kernels=False)
    assert torch.equal(t_set, plain.scatter(table, idx, vals)), \
        "scatter set != plain path"
    add_ref = plain.scatter(table, idx, grads, mode="add")
    add_ulps = ulps(t_add, add_ref)
    assert add_ulps <= 1.0, f"scatter add off by {add_ulps} bf16 ulp"
    assert torch.equal(t_cached, t_add), "cached_scatter != scatter"
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
                sgrads=grads.reshape(-1, D_MODEL)[perm], launches=launches,
                slice_s=slice_s, add_ulps=add_ulps,
                distinct=int(uniq.size), hot_hits=int(
                    hot.hit_mask(idx).sum()))


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
        args = ((rb,) if mode == "set" else (table.shape[1], 1))
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
    res["sorted_scatter"] = scatter
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on a CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    dev = torch.device("cuda", 0)
    say(phase="device", kind=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda)

    t0 = time.perf_counter()
    reports = _build.build()
    say(phase="build", seconds=time.perf_counter() - t0,
        kernels_built=sorted(reports))
    for name, text in reports.items():
        for line in text.splitlines():
            if "registers" in line or "error" in line.lower():
                print(f"  ptxas[{name}]: {line.strip()}", flush=True)

    gen = torch.Generator(device=dev).manual_seed(SEED)
    errs = check_kernels(dev, gen)
    say(phase="kernels_vs_plain", max_abs_err=errs)

    s = run_slice(dev, gen)
    say(phase="slice", seconds=s["slice_s"], launches=s["launches"],
        distinct_rows=s["distinct"], hot_hits=s["hot_hits"],
        add_max_bf16_ulps=s["add_ulps"],
        peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9)

    t = timings(dev, s)
    for name, shapes in t.items():
        for shape, row in shapes.items():
            say(phase="timing", kernel=name, shape=shape,
                kernel_ms=row["ms"],
                **{k: v for k, v in row.items() if k != "ms"},
                launches=s["launches"][name])

    main_row = {"bitonic_sort": t["bitonic_sort"][f"1x{BATCH * SEQ}"],
                "sorted_gather": t["sorted_gather"][f"{BATCH * SEQ}x{D_MODEL}"],
                "sorted_scatter": t["sorted_scatter"]["add"]}
    kernels = []
    for name in LIBS:
        row = main_row[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": REPLACES[name], "launches": s["launches"][name],
            "max_abs_err": errs[name], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "variants": t[name]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
