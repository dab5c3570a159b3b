"""Training driver: data → step → checkpoint → restart.

Counterpart of ``repro.launch.train``, on one device or a device mesh.
Fault-tolerance posture:
  * batches are pure functions of (seed, step) — no pipeline state;
  * async checkpoints every ``--ckpt-every`` steps, atomic rename;
  * on start, the driver resumes from the latest complete checkpoint,
    re-sharded onto the trainer's mesh;
  * a step-time watchdog flags stragglers, and on a mesh prints the
    rescale plan (``runtime.elastic.plan_rescale``).
On a mesh, parameters and moments are DTensors laid out by
``param_specs`` and ``opt_state_specs``, and each gradient is reduced to
its parameter's layout before the update. The trainer's step takes over
its state leaf by leaf, as the reference's jitted step donates it, so a
step holds one copy of the weights and moments, not two.

The gradient is torch autograd through ``LM.loss``: the embedding lookup's
backward is the controller's gradient write (B1's sort and B3's ``add``,
``models.layers.EmbedLookup``) and attention's is autograd through B6's
plain version (``kernels.flash_attention.kernel.FlashAttention``).

Usage (CPU smoke; without ``--device cpu`` it runs on the GPU):
  python -m repro_torch.launch.train --arch h2o-danube-1.8b --smoke \\
      --steps 5 --device cpu
On a mesh, one process per device (gloo on the CPU, NCCL on GPUs):
  torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.train \\
      --smoke --mesh 2x2 --device cpu
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
from repro_torch.models.sharding import distribute, full, is_dtensor
from repro_torch.optim.adamw import (OptimizerConfig, adamw_update,
                                     init_opt_state, opt_state_specs)
from repro_torch.runtime import StepWatchdog, plan_rescale

# The batch and sequence of a smoke run that names neither (the
# reference's train_4k shape, 256 x 4096 tokens, is far beyond a smoke
# model on a CPU).
SMOKE_BATCH, SMOKE_SEQ = 8, 64


def loss_and_grads(lm, params, batch):
    """(loss, metrics, grads) of ``lm.loss`` at ``params``: grads a tree
    like ``params``, zero for a leaf the loss does not reach (as
    ``jax.grad`` gives); on a mesh each in its parameter's layout (a
    partial sum over the batch shards is reduced here)."""
    flat = [p.detach().requires_grad_() for p in leaves(params)]
    it = iter(flat)
    loss, metrics = lm.loss(map_tree(lambda _: next(it), params), batch)
    with lm._on_mesh():
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else
             g.redistribute(p.device_mesh, p.placements) if is_dtensor(g)
             else g for p, g in zip(flat, grads)]
    it = iter(grads)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            map_tree(lambda _: next(it), params))


def make_train_step(lm, opt_cfg: OptimizerConfig, donate: bool = False):
    """``train_step(params, opt_state, batch)`` -> (params, opt_state,
    metrics). With ``donate`` the step takes over the state it is given
    (``adamw_update``'s ``donate``): the caller's trees then hold the new
    state and must not be read for the old one."""
    def train_step(params, opt_state, batch):
        loss, metrics, grads = loss_and_grads(lm, params, batch)
        with lm._on_mesh():
            params, opt_state, om = adamw_update(grads, opt_state, params,
                                                 opt_cfg, donate=donate)
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
    ``tc.device``, or on ``mesh`` (a ``DeviceMesh`` with named dims; its
    device type then wins). ``params``, when given, replaces the seeded
    init (a tree like ``LM.init``'s, such as the reference's converted
    parameters; on a mesh every rank passes the same plain tree and keeps
    its shards)."""

    def __init__(self, tc: TrainerConfig, params=None, mesh=None):
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
        self.mesh = mesh
        self.device = torch.device(mesh.device_type if mesh is not None
                                   else tc.device)
        self.lm = build_lm(cfg, mesh, global_batch=shape.global_batch,
                           device=self.device)
        self.cfg = cfg
        self.params = params
        self.data = SyntheticDataset(cfg, shape, seed=tc.seed,
                                     batch_override=tc.batch_override)
        self.watchdog = StepWatchdog()
        self.ckpt = (CheckpointManager(tc.ckpt_dir, save_every=tc.ckpt_every)
                     if tc.ckpt_dir else None)
        # the state is the trainer's own (a given tree is copied dict by
        # dict in init_state), so each step takes it over
        self.step_fn = make_train_step(self.lm, tc.opt, donate=True)

    # -- state ---------------------------------------------------------------
    def init_state(self):
        params = self.params
        if params is None:
            params = self.lm.init(
                torch.Generator(self.device).manual_seed(self.tc.seed))
        elif self.mesh is None:
            params = map_tree(lambda p: p, params)
        else:
            it = iter(leaves(self.lm.param_specs()))
            params = map_tree(lambda p: p if is_dtensor(p) else distribute(
                p.to(self.device), self.mesh, next(it)), params)
        return params, init_opt_state(params), 0

    def state_specs(self):
        """Specs of the ``{"params", "opt"}`` checkpoint tree (None off a
        mesh)."""
        if self.mesh is None:
            return None
        p = self.lm.param_specs()
        return {"params": p, "opt": opt_state_specs(p)}

    def restore_or_init(self):
        params, opt_state, start = self.init_state()
        if self.ckpt:
            tree = {"params": params, "opt": opt_state}
            step, restored = self.ckpt.restore_latest(
                tree, mesh=self.mesh, specs=self.state_specs())
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
            loss = float(full(metrics["loss"]))     # waits for the step
            alert = self.watchdog.stop(step)
            history.append(loss)
            if step % self.tc.log_every == 0:
                print(f"[train] step={step} loss={loss:.4f} "
                      f"gnorm={float(full(metrics['grad_norm'])):.3f} "
                      f"lr={float(full(metrics['lr'])):.2e}")
            if alert is not None:
                print(f"[train] STRAGGLER step={alert.step} "
                      f"x{alert.ratio:.1f} baseline "
                      f"{alert.baseline_s * 1e3:.0f}ms — checkpoint + "
                      "rescale plan:")
                if self.mesh is not None:
                    print("[train]   " + self.rescale_plan().describe())
            if self.ckpt:
                self.ckpt.maybe_save(step + 1,
                                     {"params": params, "opt": opt_state})
        if self.ckpt:
            self.ckpt.wait()
        return {"final_loss": history[-1] if history else None,
                "history": history,
                "median_step_s": self.watchdog.median_step_s,
                "params": params}

    def rescale_plan(self):
        """The elastic plan for the mesh onto the devices of the job."""
        import torch.distributed as dist
        return plan_rescale(tuple(self.mesh.shape),
                            tuple(self.mesh.mesh_dim_names),
                            available_devices=dist.get_world_size(),
                            global_batch=self.shape.global_batch)


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
    ap.add_argument("--mesh", default=None, metavar="DxM",
                    help="a (data, model) mesh over the processes of a "
                         "torchrun launch (gloo on the CPU, NCCL on GPUs)")
    args = ap.parse_args(argv)
    batch, seq = args.batch, args.seq
    if args.smoke and batch is None and seq is None:
        batch, seq = SMOKE_BATCH, SMOKE_SEQ
    tc = TrainerConfig(arch=args.arch, shape=args.shape, smoke=args.smoke,
                       steps=args.steps, batch_override=batch,
                       seq_override=seq, ckpt_dir=args.ckpt_dir,
                       ckpt_every=args.ckpt_every, seed=args.seed,
                       device=args.device)
    if not args.mesh:
        _report(Trainer(tc).run())
        return
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_test_mesh
    shape = tuple(int(n) for n in args.mesh.lower().split("x"))
    dist.init_process_group("gloo" if args.device == "cpu" else "nccl")
    try:
        if args.device != "cpu":
            torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
        mesh = make_test_mesh(shape,
                              device_type=torch.device(args.device).type)
        _report(Trainer(tc, mesh=mesh).run())
    finally:
        dist.destroy_process_group()


def _report(out) -> None:
    print(f"[train] done: final_loss={out['final_loss']:.4f} "
          f"median_step={out['median_step_s'] * 1e3:.0f}ms")


if __name__ == "__main__":
    main()
