"""Batched serving on the PyTorch/CUDA port, with scheduler-policy
admission (paper Fig. 2 applied to inference requests): bursts of
requests are batched under (batch_size, timeout) rules, prefilled
together, decoded in lockstep.

Run (the GPU by default):
  PYTHONPATH=src python examples/torch_serve_batched.py [--device cpu]
"""

import argparse

import numpy as np

from repro_torch.core.config import SchedulerConfig
from repro_torch.launch.serve import Request, Server


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)
    server = Server("mixtral-8x7b", smoke=True,
                    sched=SchedulerConfig(batch_size=4, timeout_cycles=8),
                    device=args.device)
    rng = np.random.default_rng(0)

    # three bursts of traffic with idle gaps longer than the timeout
    reqs = []
    t = 0
    for burst, size in enumerate((4, 6, 2)):
        for _ in range(size):
            reqs.append(Request(
                rid=len(reqs),
                prompt=rng.integers(0, server.cfg.vocab_size,
                                    rng.integers(8, 20)).astype(np.int32),
                max_new_tokens=6, arrival_cycle=t))
            t += 1
        t += 50                       # inter-burst gap > timeout

    batches = server.admit(reqs)
    print(f"admission: {len(reqs)} requests -> "
          f"{[len(b) for b in batches]} batches "
          "(batch_size=4, timeout=8 cycles)")
    stats = server.serve(reqs)
    assert stats.requests == len(reqs) and stats.batches == len(batches)
    assert all(len(r.output) == 6 for r in reqs)
    print(f"served {stats.requests} requests, "
          f"{stats.decode_steps} lockstep decode steps, "
          f"{stats.prefill_tokens} prefill tokens in {stats.wall_s:.1f}s")
    for r in reqs[:3]:
        print(f"  req{r.rid}: prompt[{len(r.prompt)}] -> {r.output}")
    return dict(batch_sizes=[len(b) for b in batches],
                requests=stats.requests, batches=stats.batches,
                decode_steps=stats.decode_steps,
                prefill_tokens=stats.prefill_tokens,
                outputs=[r.output for r in reqs])


if __name__ == "__main__":
    main()
