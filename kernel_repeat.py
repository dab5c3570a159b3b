#!/usr/bin/env python3
"""Time the gather (B2), the scatter's ``add`` (B3), the DMA copy (B4), the
cache probe (B5), the set-parallel cache engine's calls and flash
attention (B6) at the main paths' shapes, as ``chip_smoke.py`` times them,
for one version of the port, so that two versions can be compared on one
card.

    python3 kernel_repeat.py [--src DIR]

``--src`` is the ``src`` directory whose ``repro_torch`` is timed (by
default this checkout's; another checkout's, e.g. an unpacked parent
commit, to compare). The timings are ``chip_smoke.py``'s own
(``timings_gather``, ``timings_scatter``, ``timings_bulk``,
``timings_cache``, ``timings_engine``, ``timings_attention``), run on
that package: the
wrapper's CUDA-event median, the device time and launches per call from
``torch.profiler`` and the kernel's own device time in that trace, the
library call's, the plain version's, the bound. B3 and B5 are timed
through their wrappers only (``full=False``), since their raw launches
differ between versions; the engine through its entry points (the read
trace, then the read/write trace under each write policy: device and host
time, launches, host syncs, the kernels' own device time, the bound);
B6 at its six shapes, both routes (the tensor-core route at the serve,
train, train_moe and train_vlm shapes, the float32 route at the
encoder's and at train_moe's), beside ``scaled_dot_product_attention``.
One process times one version: run it once per version, alternating
versions (A, B, B, A) on one machine. Needs one CUDA device;
builds that version's kernels first.

Prints the card's name and power limit, then one JSON line per kernel and
shape.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "src"))
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))
    import numpy as np
    import torch
    import repro_torch
    from repro_torch.core import init_cache, simulate_trace
    from repro_torch.kernels.cache_lookup import kernel as cl
    # chip_smoke.py names every kernel library when it is imported; a
    # version before the row resolve has no library of that name.
    if not hasattr(cl, "RESOLVE_LIB"):
        cl.RESOLVE_LIB = None
    # Imported after the package, so that its timing functions run on the
    # version loaded from --src.
    import chip_smoke as cs
    from repro_torch.kernels import _build

    if not torch.cuda.is_available():
        print("kernel_repeat: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    _build.build()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    table = torch.randn((cs.VOCAB, cs.D_MODEL), generator=gen, device=dev,
                        dtype=torch.bfloat16)
    idx = torch.from_numpy(cs.prefill_ids()).to(dev).reshape(-1)
    sidx32, perm = torch.sort(idx.to(torch.int32), stable=True)
    rows = {"sorted_gather": cs.timings_gather(table, sidx32)}
    grads32 = torch.randn((idx.numel(), cs.D_MODEL), generator=gen,
                          device=dev) * 1e-2
    svals = torch.randn((idx.numel(), cs.D_MODEL), generator=gen,
                        device=dev, dtype=torch.bfloat16)
    sgrads32 = grads32[perm]
    rows["sorted_scatter"] = cs.timings_scatter(
        table, sidx32, svals, sgrads32.to(torch.bfloat16), sgrads32,
        int(torch.unique_consecutive(sidx32).numel()), full=False)
    del svals, grads32, sgrads32
    lines = torch.from_numpy(cs.token_lines(cs.prefill_ids()[0]).astype(
        np.int32)).to(dev)
    rows["cache_lookup"] = cs.timings_cache(dev, dict(
        ids=lines, lines_tab=table.view(-1, cs.line_elems()),
        state=init_cache(cs.CACHE_CFG, cs.line_elems(), torch.bfloat16,
                         device=dev),
        max_beats_per_set=int(np.bincount(
            lines.cpu().numpy() % cs.CACHE_CFG.num_sets).max())), full=False)
    ct = cs.cache_trace_inputs(dev, table)
    ct["warm"] = simulate_trace(ct["state0"], ct["ids"], ct["lines_tab"],
                                engine="parallel")[0]
    rows["cache_trace_engine"] = cs.timings_engine(ct, reps=10)
    del table, ct
    w = torch.randn(cs.FFN_SHAPE, generator=gen, device=dev,
                    dtype=torch.bfloat16)
    kv = torch.randn(cs.KV_SHAPE, generator=gen, device=dev,
                     dtype=torch.bfloat16)
    layer_kv = torch.randn(cs.KV_SHAPE[1:], generator=gen, device=dev,
                           dtype=torch.bfloat16)
    rows["dma_copy"] = cs.timings_bulk(dev, dict(
        w=w, kv=kv, layer_kv=layer_kv,
        offset=cs.KV_LAYER * layer_kv.numel()))
    del w, kv, layer_kv
    rows["flash_attention"] = cs.timings_attention(dev, gen)
    for kernel, shapes in rows.items():
        for shape, row in shapes.items():
            print(json.dumps(dict(package=os.path.dirname(
                repro_torch.__file__), kernel=kernel, shape=shape, **row)),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
