"""Quickstart on the PyTorch/CUDA port: the memory controller and a model.

1. Configure a memory controller (the paper's Table I knobs).
2. Route an irregular gather through it: value-identical to the plain
   gather, sorted by row for locality (B1's sort, B2's gather on the GPU).
3. Train a reduced yi-34b-family model for a handful of steps.
4. Serve a few tokens from it.

Run (the GPU by default; ``--device cpu`` runs each kernel's plain
version):  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""

import argparse

import numpy as np
import torch

from repro_torch.core import (MemoryController, MemoryControllerConfig,
                              simulate_dram_access)
from repro_torch.core.config import (CacheConfig, ChannelConfig, DMAConfig,
                                     SchedulerConfig)
from repro_torch.launch.serve import Request, Server
from repro_torch.launch.train import Trainer, TrainerConfig


def demo_controller(device: str) -> dict:
    print("=== 1/3: programmable memory controller ===")
    cfg = MemoryControllerConfig(
        scheduler=SchedulerConfig(batch_size=64, timeout_cycles=16),
        cache=CacheConfig(num_lines=4096, associativity=4),
        dma=DMAConfig(num_parallel_dma=4),
        channels=ChannelConfig(num_channels=4),
    )
    print(cfg.describe())

    mc = MemoryController(cfg, device=device)
    table = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (4096, 64)).astype(np.float32)).to(device)
    idx = torch.from_numpy(np.random.default_rng(1).integers(
        0, 4096, 1024)).to(device)
    out = mc.gather(table, idx)                 # scheduler-path gather
    assert torch.equal(out, table[idx]), "value identity violated"

    # Full staged pipeline: arbiters -> address map -> cache filter ->
    # batch scheduler -> channel-parallel DRAM service -> DMA overlap.
    ids = idx.cpu().numpy()
    base = simulate_dram_access(ids * 256)
    res = mc.simulate(None, ids, None, 256)
    print(f"modeled DRAM cycles: {base.total_fpga_cycles:.0f} -> "
          f"{res.makespan_fpga_cycles:.0f} "
          f"({1 - res.makespan_fpga_cycles / base.total_fpga_cycles:.0%} "
          f"saved, cache hit rate {res.cache_hit_rate:.2f})")
    print("per-stage cycle breakdown:",
          {k: round(v) for k, v in res.breakdown().items()}, "\n")
    return dict(naive_cycles=base.total_fpga_cycles,
                controller_cycles=res.makespan_fpga_cycles,
                cache_hit_rate=res.cache_hit_rate)


def demo_train(device: str, steps: int) -> dict:
    print(f"=== 2/3: train a reduced yi-34b for {steps} steps ===")
    out = Trainer(TrainerConfig(arch="yi-34b", smoke=True, steps=steps,
                                batch_override=8, seq_override=64,
                                log_every=5, device=device)).run()
    assert all(np.isfinite(out["history"])), out["history"]
    print(f"final loss {out['final_loss']:.3f}\n")
    return {k: v for k, v in out.items() if k != "params"}


def demo_serve(device: str) -> dict:
    print("=== 3/3: serve ===")
    server = Server("yi-34b", smoke=True, device=device)
    reqs = [Request(rid=i, prompt=np.arange(8, dtype=np.int32) + i,
                    max_new_tokens=4) for i in range(3)]
    stats = server.serve(reqs)
    assert stats.requests == len(reqs)
    assert all(len(r.output) == 4 for r in reqs)
    print(f"{stats.requests} requests, outputs: "
          f"{[r.output for r in reqs]}")
    return dict(requests=stats.requests, outputs=[r.output for r in reqs])


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the GPU)")
    ap.add_argument("--train-steps", type=int, default=15)
    args = ap.parse_args(argv)
    return dict(controller=demo_controller(args.device),
                train=demo_train(args.device, args.train_steps),
                serve=demo_serve(args.device))


if __name__ == "__main__":
    main()
