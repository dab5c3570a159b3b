"""Training driver: data → step → checkpoint → restart.

Counterpart of ``repro.launch.train``, on one device. Fault-tolerance
posture:
  * batches are pure functions of (seed, step) — no pipeline state;
  * async checkpoints every ``--ckpt-every`` steps, atomic rename;
  * on start, the driver resumes from the latest complete checkpoint;
  * a step-time watchdog flags stragglers.
Meshes, sharded states and rescaling onto a new mesh come with the device
mesh (ROADMAP A9).

The gradient is torch autograd through ``LM.loss``: the embedding lookup's
backward is the controller's gradient write (B1's sort and B3's ``add``,
``models.layers.EmbedLookup``) and attention's is autograd through B6's
plain version (``kernels.flash_attention.kernel.FlashAttention``).

Usage (CPU smoke; without ``--device cpu`` it runs on the GPU):
  python -m repro_torch.launch.train --arch h2o-danube-1.8b --smoke \\
      --steps 5 --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Any, Dict, Optional

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import SHAPES, ShapeConfig, get_arch
from repro_torch.data.synthetic import SyntheticDataset
from repro_torch.models.lm import build_lm
from repro_torch.models.params import leaves, map_tree
from repro_torch.optim.adamw import (OptimizerConfig, adamw_update,
                                     init_opt_state)
from repro_torch.runtime import StepWatchdog

# The batch and sequence of a smoke run that names neither (the
# reference's train_4k shape, 256 x 4096 tokens, is far beyond a smoke
# model on a CPU).
SMOKE_BATCH, SMOKE_SEQ = 8, 64


def loss_and_grads(lm, params, batch):
    """(loss, metrics, grads) of ``lm.loss`` at ``params``: grads a tree
    like ``params``, zero for a leaf the loss does not reach (as
    ``jax.grad`` gives)."""
    flat = [p.detach().requires_grad_() for p in leaves(params)]
    it = iter(flat)
    loss, metrics = lm.loss(map_tree(lambda _: next(it), params), batch)
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    it = iter(torch.zeros_like(p) if g is None else g
              for p, g in zip(flat, grads))
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            map_tree(lambda _: next(it), params))


def make_train_step(lm, opt_cfg: OptimizerConfig):
    def train_step(params, opt_state, batch):
        loss, metrics, grads = loss_and_grads(lm, params, batch)
        params, opt_state, om = adamw_update(grads, opt_state, params,
                                             opt_cfg)
        return params, opt_state, {"loss": loss, **metrics, **om}
    return train_step


@dataclasses.dataclass
class TrainerConfig:
    arch: str = "yi-34b"
    shape: str = "train_4k"
    smoke: bool = False
    steps: int = 100
    seed: int = 0
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    batch_override: Optional[int] = None
    seq_override: Optional[int] = None
    arch_overrides: Optional[dict] = None   # ArchConfig field replacements
    log_every: int = 10
    opt: OptimizerConfig = dataclasses.field(default_factory=OptimizerConfig)
    device: str = "cuda"


class Trainer:
    """Owns the model, state, data and the restart loop on
    ``tc.device``. ``params``, when given, replaces the seeded init (a
    tree like ``LM.init``'s, such as the reference's converted
    parameters)."""

    def __init__(self, tc: TrainerConfig, params=None):
        self.tc = tc
        cfg = get_arch(tc.arch, smoke=tc.smoke)
        if tc.arch_overrides:
            cfg = dataclasses.replace(cfg, **tc.arch_overrides)
        shape = SHAPES[tc.shape]
        if tc.seq_override or tc.batch_override:
            shape = ShapeConfig(
                name="custom", kind="train",
                seq_len=tc.seq_override or shape.seq_len,
                global_batch=tc.batch_override or shape.global_batch)
        self.shape = shape
        self.device = torch.device(tc.device)
        self.lm = build_lm(cfg, device=self.device)
        self.cfg = cfg
        self.params = params
        self.data = SyntheticDataset(cfg, shape, seed=tc.seed,
                                     batch_override=tc.batch_override)
        self.watchdog = StepWatchdog()
        self.ckpt = (CheckpointManager(tc.ckpt_dir, save_every=tc.ckpt_every)
                     if tc.ckpt_dir else None)
        self.step_fn = make_train_step(self.lm, tc.opt)

    # -- state ---------------------------------------------------------------
    def init_state(self):
        params = self.params if self.params is not None else self.lm.init(
            torch.Generator(self.device).manual_seed(self.tc.seed))
        return params, init_opt_state(params), 0

    def restore_or_init(self):
        params, opt_state, start = self.init_state()
        if self.ckpt:
            tree = {"params": params, "opt": opt_state}
            step, restored = self.ckpt.restore_latest(tree)
            if step is not None:
                print(f"[train] resumed from step {step}")
                return restored["params"], restored["opt"], step
        return params, opt_state, start

    def batch_at(self, step: int) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in self.data.batch_at(step).items()}

    # -- loop ----------------------------------------------------------------
    def run(self) -> Dict[str, Any]:
        params, opt_state, start = self.restore_or_init()
        history = []
        for step in range(start, self.tc.steps):
            batch = self.batch_at(step)
            self.watchdog.start()
            params, opt_state, metrics = self.step_fn(params, opt_state,
                                                      batch)
            loss = float(metrics["loss"])     # waits for the step
            alert = self.watchdog.stop(step)
            history.append(loss)
            if step % self.tc.log_every == 0:
                print(f"[train] step={step} loss={loss:.4f} "
                      f"gnorm={float(metrics['grad_norm']):.3f} "
                      f"lr={float(metrics['lr']):.2e}")
            if alert is not None:
                print(f"[train] STRAGGLER step={alert.step} "
                      f"x{alert.ratio:.1f} baseline "
                      f"{alert.baseline_s * 1e3:.0f}ms")
            if self.ckpt:
                self.ckpt.maybe_save(step + 1,
                                     {"params": params, "opt": opt_state})
        if self.ckpt:
            self.ckpt.wait()
        return {"final_loss": history[-1] if history else None,
                "history": history,
                "median_step_s": self.watchdog.median_step_s,
                "params": params}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-34b")
    ap.add_argument("--shape", default="train_4k", choices=list(SHAPES))
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-runnable); "
                         f"batch {SMOKE_BATCH} x seq {SMOKE_SEQ} unless "
                         "--batch or --seq is given")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)
    batch, seq = args.batch, args.seq
    if args.smoke and batch is None and seq is None:
        batch, seq = SMOKE_BATCH, SMOKE_SEQ
    tc = TrainerConfig(arch=args.arch, shape=args.shape, smoke=args.smoke,
                       steps=args.steps, batch_override=batch,
                       seq_override=seq, ckpt_dir=args.ckpt_dir,
                       ckpt_every=args.ckpt_every, seed=args.seed,
                       device=args.device)
    out = Trainer(tc).run()
    print(f"[train] done: final_loss={out['final_loss']:.4f} "
          f"median_step={out['median_step_s'] * 1e3:.0f}ms")


if __name__ == "__main__":
    main()
