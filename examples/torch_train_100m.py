"""End-to-end training on the PyTorch/CUDA port: train a ~100M-parameter LM
for a few hundred steps.

A scaled member of the yi/llama family (10 layers, d=640, GQA 8/4 heads,
32k vocab, 92.6M params) trained on the deterministic zipf pipeline with
the full production stack: memory-controller embedding path, AdamW,
cosine schedule, remat, async checkpointing, straggler watchdog.
``--smoke`` trains the yi-34b smoke configuration instead.

Run (the GPU by default):
  PYTHONPATH=src python examples/torch_train_100m.py [--steps 300] \
      [--device cpu] [--smoke]
"""

import argparse
import math
import os

from repro_torch.launch.train import Trainer, TrainerConfig
from repro_torch.optim.adamw import OptimizerConfig

# yi/llama family scaled to ~100M parameters
OVERRIDES = dict(num_layers=10, d_model=640, num_heads=8, num_kv_heads=4,
                 head_dim=80, d_ff=2048, vocab_size=32_000)
CKPT_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "build", "train_100m_ckpt")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=CKPT_DIR)
    ap.add_argument("--smoke", action="store_true",
                    help="the yi-34b smoke configuration, not ~100M")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)

    tc = TrainerConfig(
        arch="yi-34b", smoke=args.smoke,
        arch_overrides=None if args.smoke else OVERRIDES, steps=args.steps,
        batch_override=args.batch, seq_override=args.seq,
        ckpt_dir=args.ckpt_dir, ckpt_every=100, log_every=10,
        opt=OptimizerConfig(peak_lr=1e-3, warmup_steps=30,
                            total_steps=args.steps),
        device=args.device)
    trainer = Trainer(tc)
    n_params = trainer.cfg.param_count()
    print(f"[100m] model: {n_params / 1e6:.0f}M params "
          f"({trainer.cfg.num_layers}L d={trainer.cfg.d_model} "
          f"ff={trainer.cfg.d_ff})")
    out = trainer.run()
    history = out["history"]
    assert len(history) == args.steps and all(
        math.isfinite(x) for x in history), history
    # the mean of the first and of the last ten losses, halves that do
    # not overlap below twenty steps
    n = max(1, min(10, len(history) // 2))
    first, last = sum(history[:n]) / n, sum(history[-n:]) / n
    print(f"[100m] loss {first:.3f} -> {last:.3f} over {args.steps} steps "
          f"({trainer.watchdog.median_step_s * 1e3:.0f} ms/step median)")
    return dict(params=n_params, history=history, first=first, last=last,
                median_step_s=trainer.watchdog.median_step_s)


if __name__ == "__main__":
    main()
