#!/usr/bin/env python3
"""Serve ``chip_smoke.py``'s request mix several times in one process and
print each serve's host-clock times, so that two versions of the port can
be compared on one card.

    python3 serve_repeat.py [--src DIR] [--repeats N]

``--src`` is the ``src`` directory whose ``repro_torch`` is served (by
default this checkout's; another checkout's, e.g. an unpacked parent
commit, to compare). One process serves one version: run it once per
version, alternating versions (A, B, B, A) inside one machine session.
The first serve builds the kernels and warms the libraries and is
reported as ``warm``, apart from the measured ones. Needs one CUDA device.

Prints the card's name and power limit, then one JSON line per serve:
prefill seconds, decode seconds per step, wall seconds of ``serve``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

# The serve path of chip_smoke.py: yi-34b at its full configuration
# (random weights from seed 0), 12 requests of 1024 uniform token ids, 16
# new tokens each, arriving every 3 cycles.
ARCH, REQUESTS, PROMPT, NEW = "yi-34b", 12, 1024, 16


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "src"))
    ap.add_argument("--repeats", type=int, default=4)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))
    import numpy as np
    import torch
    from repro_torch.launch.serve import Request, Server

    if not torch.cuda.is_available():
        print("serve_repeat: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    server = Server(ARCH, device=torch.device("cuda", 0))
    for i in range(args.repeats + 1):
        rng = np.random.default_rng(0)
        reqs = [Request(rid=r, prompt=rng.integers(
                    0, server.cfg.vocab_size, PROMPT).astype(np.int32),
                    max_new_tokens=NEW, arrival_cycle=r * 3)
                for r in range(REQUESTS)]
        stats = server.serve(reqs)
        torch.cuda.synchronize()
        print(json.dumps(dict(
            src=args.src, serve="warm" if i == 0 else i,
            prefill_s=stats.prefill_s,
            decode_s_per_step=stats.decode_s / stats.decode_steps,
            wall_s=stats.wall_s,
            outputs=[r.output for r in reqs[:2]])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
