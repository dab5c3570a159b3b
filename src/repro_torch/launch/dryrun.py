"""Dry run: count every (arch x shape x mesh) cell's step on fake devices.

Counterpart of ``repro.launch.dryrun``. Host-only by design, as the
reference's 512 placeholder host devices are: a ``fake`` process group
(``torch.testing._internal.distributed.fake_pg``; collectives do nothing)
of 256 ranks backs the 16x16 single-pod mesh and one of 512 the 2x16x16
multi-pod mesh, and this process plays rank 0. Parameters, optimizer
state, batches and caches are DTensors on ``meta`` tensors, laid out by
the same specs as a real run; the kernels take their plain versions on
``meta`` (as on the CPU), so the counters see their work.

Per cell this driver:
  1. builds the entry point (train step = loss, gradients and AdamW;
     prefill; one decode step) with its inputs laid out by the specs,
  2. runs it once under the counters (``count_step``): per-device FLOPs,
     memory bytes and collective bytes (``launch.roofline``). A step that
     runs proves the layouts coherent, as the reference's compile does;
     there is no compile, so the compile fields are null,
  3. extrapolates over layer groups as the reference does: the 1- and
     2-group models are counted and
         total = cost(G1) + (num_groups - 1) * (cost(G2) - cost(G1)).
     The port's layer walk is unrolled and counted exactly, so this equals
     the full model's count; it keeps the dry run quick at full depth.

What the FLOP count includes: every matrix product of each rank's local
shards, forward and backward, the remat recompute, and B6's plain blocked
loop over the KV blocks it does not skip (a causal or window mask skips
the blocks that hold no live key; a block that holds some is counted
whole, masked entries included). The sort networks, gathers and scatters
count no FLOPs, only bytes.

Usage:
  python -m repro_torch.launch.dryrun --arch h2o-danube-1.8b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--out results.jsonl]
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import time
from typing import Any, Dict

import torch
from torch.utils._pytree import tree_flatten

from repro_torch.configs import SHAPES, get_arch, supported_shapes
from repro_torch.configs.registry import ARCH_IDS, canonical
from repro_torch.data.synthetic import batch_specs
from repro_torch.launch import roofline
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.train import loss_and_grads
from repro_torch.models.lm import build_lm
from repro_torch.models.params import map_tree
from repro_torch.models.sharding import (Spec, distribute, mesh_shape,
                                         serving_weight_overrides)
from repro_torch.optim.adamw import (OptimizerConfig, abstract_opt_state,
                                     adamw_update, opt_state_specs)

MARGIN = 256   # decode cache slack; multiple of 256 keeps seq-sharding even


@contextlib.contextmanager
def fake_world(world_size: int):
    """A ``fake`` process group of ``world_size`` ranks, this process rank
    0, for the span of the block (it must be the only group)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("the dry run needs a process of its own: a "
                           "process group is already initialized")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _leaves(tree) -> list:
    return tree_flatten(tree, is_leaf=lambda x: isinstance(x, Spec))[0]


def estimate_state_bytes_per_device(abstract_tree, spec_tree, mesh) -> float:
    """Analytic per-device bytes of a sharded tree (params/opt/cache)."""
    shape = mesh_shape(mesh)
    total = 0.0
    for leaf, spec in zip(_leaves(abstract_tree), _leaves(spec_tree)):
        shard_elems = float(math.prod(leaf.shape)) if leaf.shape else 1.0
        for axis_entry in spec:
            if axis_entry is None:
                continue
            axes = (axis_entry,) if isinstance(axis_entry, str) \
                else axis_entry
            for ax in axes:
                shard_elems /= shape[ax]
        total += shard_elems * leaf.element_size()
    return total


def _place(abstract_tree, spec_tree, mesh):
    """``meta`` DTensors of an abstract tree, laid out by its specs."""
    flat = iter(_leaves(spec_tree))
    return map_tree(lambda t: distribute(t, mesh, next(flat)), abstract_tree)


def build_cell(arch_name: str, shape_name: str, mesh, *,
               moe_strategy: str = "tp", overrides: Dict[str, Any] = None,
               sharding_overrides: Dict[str, Any] = None):
    """Returns (step_fn, args, state_bytes_per_device, cfg, shape):
    ``args()`` lays the cell's ``meta`` inputs out on ``mesh``, and
    ``step_fn(*args())`` runs the cell's entry point once."""
    cfg = get_arch(arch_name)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = SHAPES[shape_name]
    lm = build_lm(cfg, mesh, global_batch=shape.global_batch,
                  moe_strategy=moe_strategy)
    if sharding_overrides is None and shape.kind == "decode":
        # production serving layout (see sharding.serving_weight_overrides)
        sharding_overrides = serving_weight_overrides(
            cfg, shape.global_batch, mesh)
    if sharding_overrides:
        lm.rules = dataclasses.replace(lm.rules, **sharding_overrides)
    pspecs = lm.param_specs()
    aparams = lm.abstract_params()
    state_bytes = estimate_state_bytes_per_device(aparams, pspecs, mesh)

    def params():
        return _place(aparams, pspecs, mesh)

    if shape.kind == "train":
        opt_cfg = OptimizerConfig()
        ospecs = opt_state_specs(pspecs)
        aopt = abstract_opt_state(aparams)
        bshapes, _ = batch_specs(cfg, shape, lm.rules)
        state_bytes += estimate_state_bytes_per_device(aopt, ospecs, mesh)

        def train_step(p, opt, batch):
            loss, metrics, grads = loss_and_grads(lm, p, batch)
            with lm._on_mesh():
                return adamw_update(grads, opt, p, opt_cfg)

        def args():
            return (params(), {"m": _place(aopt["m"], ospecs["m"], mesh),
                               "v": _place(aopt["v"], ospecs["v"], mesh),
                               "step": torch.zeros((), dtype=torch.int32,
                                                   device="meta")},
                    bshapes)
        fn = train_step

    elif shape.kind == "prefill":
        bshapes, _ = batch_specs(cfg, shape, lm.rules)
        bshapes.pop("labels")

        def fn(p, batch):
            return lm.prefill(p, batch, max_len=shape.seq_len + MARGIN)

        def args():
            return params(), bshapes

    else:   # decode
        B = shape.global_batch
        state_bytes += estimate_state_bytes_per_device(
            lm.init_cache(B, shape.seq_len + MARGIN, abstract=True),
            lm.cache_specs(), mesh)

        def fn(p, token, cache, cur_len):
            return lm.decode_step(p, token, cache, cur_len)

        def args():
            return (params(), torch.empty((B,), dtype=torch.int32,
                                          device="meta"),
                    lm.init_cache(B, shape.seq_len + MARGIN), shape.seq_len)

    return fn, args, state_bytes, cfg, shape


def count_step(fn, args) -> roofline.StepCounts:
    """Run ``fn(*args())`` once, counting each device's work."""
    made = args()
    flops = roofline.LocalFlops()
    comm = roofline.CollectiveBytes()
    op_bytes = roofline.OpBytesMode()
    with flops, comm, op_bytes:
        fn(*made)
    return roofline.StepCounts(
        flops=float(flops.flops), hbm_bytes=float(op_bytes.bytes),
        collectives_detail=dict(comm.detail))


def run_cell(arch_name: str, shape_name: str, *, multi_pod: bool = False,
             moe_strategy: str = "tp",
             overrides: Dict[str, Any] = None,
             sharding_overrides: Dict[str, Any] = None) -> Dict[str, Any]:
    """The cell's record (the reference's fields; the compile ones null).
    Opens and closes its own fake process group."""
    arch_name = canonical(arch_name)
    chips = 512 if multi_pod else 256
    cell = f"{arch_name}/{shape_name}/{'2pod' if multi_pod else '1pod'}"
    rec: Dict[str, Any] = {"cell": cell, "chips": chips,
                           "moe_strategy": moe_strategy,
                           "lower_s": None, "compile_s": None,
                           "memory_analysis": None}
    with fake_world(chips):
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        t0 = time.perf_counter()
        _, _, state_bytes, cfg, shape = build_cell(
            arch_name, shape_name, mesh, moe_strategy=moe_strategy,
            overrides=overrides, sharding_overrides=sharding_overrides)
        rec["state_bytes_per_device"] = state_bytes
        period = cfg.scan_period
        groups = cfg.num_layers // period
        if groups <= 2:
            fn, args, _, _, _ = build_cell(
                arch_name, shape_name, mesh, moe_strategy=moe_strategy,
                overrides=overrides, sharding_overrides=sharding_overrides)
            c = count_step(fn, args)
            flops, hbm, det = c.flops, c.hbm_bytes, c.collectives_detail
        else:
            sub = {}
            for g in (1, 2):
                fn, args, _, _, _ = build_cell(
                    arch_name, shape_name, mesh, moe_strategy=moe_strategy,
                    overrides={**(overrides or {}),
                               "num_layers": g * period},
                    sharding_overrides=sharding_overrides)
                sub[g] = count_step(fn, args)
            flops = sub[1].flops + (groups - 1) * (sub[2].flops
                                                   - sub[1].flops)
            hbm = sub[1].hbm_bytes + (groups - 1) * (sub[2].hbm_bytes
                                                     - sub[1].hbm_bytes)
            det = {k: sub[1].collectives_detail[k] + (groups - 1) * (
                sub[2].collectives_detail[k] - sub[1].collectives_detail[k])
                for k in sub[1].collectives_detail}
        rec["count_s"] = time.perf_counter() - t0
    counts = roofline.StepCounts(flops, hbm, det)
    report = roofline.analyze(
        cell, counts, chips=chips,
        model_flops=roofline.model_flops_for(cfg, shape,
                                             cfg.active_param_count()),
        bytes_per_device=state_bytes)
    rec.update({
        "flops_per_device": flops,
        "hlo_flops": report.hlo_flops, "hbm_bytes": report.hbm_bytes,
        "collective_bytes": report.collective_bytes,
        "collectives_detail": det,
        "model_flops": report.model_flops,
        "compute_s": report.compute_s, "memory_s": report.memory_s,
        "collective_s": report.collective_s,
        "bottleneck": report.bottleneck,
        "useful_flops_ratio": report.useful_flops_ratio,
        "roofline_fraction": report.roofline_fraction,
    })
    return rec


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", type=str, default=None)
    ap.add_argument("--shape", type=str, default=None,
                    choices=list(SHAPES) + [None])
    ap.add_argument("--all", action="store_true",
                    help="run every supported (arch x shape) cell")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--moe-strategy", default="tp", choices=("tp", "ep"))
    ap.add_argument("--out", type=str, default=None,
                    help="append JSON records here")
    args = ap.parse_args()

    cells = []
    if args.all:
        for a in ARCH_IDS:
            for s in supported_shapes(get_arch(a)):
                cells.append((a, s))
    else:
        if not args.arch:
            ap.error("--arch or --all required")
        shapes = ([args.shape] if args.shape
                  else supported_shapes(get_arch(canonical(args.arch))))
        cells = [(args.arch, s) for s in shapes]

    meshes = [args.multi_pod]
    if args.both_meshes:
        meshes = [False, True]

    for arch, shp in cells:
        for mp in meshes:
            try:
                rec = run_cell(arch, shp, multi_pod=mp,
                               moe_strategy=args.moe_strategy)
                status = "OK"
            except Exception as e:   # noqa: BLE001 - report and continue
                rec = {"cell": f"{canonical(arch)}/{shp}/"
                               f"{'2pod' if mp else '1pod'}",
                       "error": f"{type(e).__name__}: {e}"}
                status = "FAIL"
            print(f"[{status}] {rec['cell']}: "
                  + (f"count={rec.get('count_s'):.1f}s "
                     f"flops={rec.get('hlo_flops', 0):.3e} "
                     f"bottleneck={rec.get('bottleneck')}"
                     if status == "OK" else rec["error"]))
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(rec) + "\n")


if __name__ == "__main__":
    main()
