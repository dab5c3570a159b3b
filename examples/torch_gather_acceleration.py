"""GCN-style gather acceleration on the PyTorch/CUDA port: the paper's
Fig. 7a scenario end to end.

A graph workload gathers vertex features (bulk) and adjacency rows
(cacheable) from a big table in device memory. The access stream runs
through the controller and through the naive path: modeled DRAM time (the
cycle-level simulator, numpy on the host), and the wall time of the
controller's sort -> gather -> unsort (B1 and B2 on the GPU) against the
plain ``index_select``, each timed between ``torch.cuda.synchronize()``
calls on a GPU. The wall times are of whatever device runs the example.

Run (the GPU by default):
  PYTHONPATH=src python examples/torch_gather_acceleration.py [--device cpu]
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.core import (HotRowCache, MemoryController,
                              PAPER_COMBINED_CONFIG, PAPER_EVAL_CONFIG)
from repro_torch.core.cache_engine import hit_rate_oracle
from repro_torch.core.timing import simulate_dram_access

N_VERT = 16_384
FEAT = 256
N_EDGES = 100_000


def wall_ms(fn, device: torch.device, reps: int = 10) -> float:
    """Mean wall time of ``fn`` over ``reps`` calls after one warm-up,
    the device synchronized before the clock starts and before it stops."""
    sync = (torch.cuda.synchronize if device.type == "cuda"
            else lambda: None)
    fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sync()
    return (time.perf_counter() - t0) / reps * 1e3


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    rng = np.random.default_rng(0)
    features = torch.from_numpy(rng.standard_normal(
        (N_VERT, FEAT)).astype(np.float32)).to(device)

    # power-law neighbor visits (hubs dominate — cacheable)
    dst_np = ((rng.zipf(1.15, N_EDGES) - 1) % N_VERT).astype(np.int32)
    dst = torch.from_numpy(dst_np).to(device)

    mc = MemoryController(PAPER_EVAL_CONFIG, device=device)

    # --- modeled DRAM access time (the paper's metric) ---
    base = simulate_dram_access(dst_np.astype(np.int64) * FEAT * 4)
    opt = mc.modeled_gather_time(dst_np, row_bytes=FEAT * 4)
    print(f"modeled access cycles : naive={base.total_fpga_cycles:,.0f} "
          f"controller={opt.total_fpga_cycles:,.0f} "
          f"({1 - opt.total_fpga_cycles / base.total_fpga_cycles:.0%} "
          "saved)")

    # --- full staged pipeline: cache + scheduler + 4 channels composed ---
    # (the headline configuration; per-stage breakdown sums to makespan)
    res = MemoryController(PAPER_COMBINED_CONFIG, device=device).simulate(
        None, dst_np, None, FEAT * 4)
    print(f"combined pipeline     : makespan="
          f"{res.makespan_fpga_cycles:,.0f} cycles "
          f"(cache hit rate {res.cache_hit_rate:.1%}, "
          f"{1 - res.makespan_fpga_cycles / base.total_fpga_cycles:.0%} "
          "saved vs naive)")
    print("  stage breakdown     :",
          {k: round(v) for k, v in res.breakdown().items()})

    # --- cache engine on the hub vertices ---
    hot = HotRowCache.build(features, np.argsort(np.bincount(
        dst_np, minlength=N_VERT))[-512:])
    hit = float(hot.hit_mask(dst).float().mean())
    print(f"hot-row cache hit rate on hubs: {hit:.1%}")
    _, lru = hit_rate_oracle(PAPER_EVAL_CONFIG.cache, dst_np)
    print(f"LRU cache-engine hit rate     : {lru:.1%}")

    # --- wall time: plain vs scheduler-path gather ---
    times = {}
    for name, fn in (("plain", lambda: features.index_select(0, dst)),
                     ("controller", lambda: mc.gather(features, dst))):
        times[name] = wall_ms(fn, device)
        print(f"wall time {name:11s}: {times[name]:.2f} ms/gather "
              f"on {device}")
    out = mc.gather(features, dst)
    assert torch.equal(out, features[dst.long()]), "value identity violated"
    print("value identity: OK")
    return dict(naive_cycles=base.total_fpga_cycles,
                controller_cycles=opt.total_fpga_cycles,
                makespan_cycles=res.makespan_fpga_cycles,
                combined_hit_rate=res.cache_hit_rate, hot_hit_rate=hit,
                lru_hit_rate=lru, wall_ms=times)


if __name__ == "__main__":
    main()
