"""Rank functions of the port's gloo tests (``tests/_torch_spawn.py``
runs them). They import torch and ``repro_torch`` only, so a spawned rank
loads no jax; the parent test compares their results with the
reference. Every result is a plain value or a numpy array."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import convert
from repro_torch.checkpoint import load_checkpoint
from repro_torch.configs import ShapeConfig, get_arch
from repro_torch.data.synthetic import make_batch
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.launch.train import Trainer, TrainerConfig, make_train_step
from repro_torch.models.lm import build_lm
from repro_torch.models.params import leaves
from repro_torch.models.sharding import full, placements
from repro_torch.optim import (OptimizerConfig, compressed_psum,
                               init_opt_state, init_residuals,
                               opt_state_specs)

ARCH = "yi-34b"
SEQ, BATCH = 32, 8
OPT = OptimizerConfig(warmup_steps=1)
TRAIN_STEPS = 2


def f32_cfg(arch=ARCH, **moe):
    cfg = get_arch(arch, smoke=True)
    cfg = dataclasses.replace(cfg, param_dtype="float32")
    if moe:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               **moe))
    return cfg


def trainer_config(ckpt_dir=None) -> TrainerConfig:
    return TrainerConfig(arch=ARCH, smoke=True, steps=TRAIN_STEPS,
                         batch_override=BATCH, seq_override=SEQ,
                         arch_overrides={"param_dtype": "float32"},
                         ckpt_dir=ckpt_dir, ckpt_every=1, opt=OPT,
                         device="cpu")


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| over the largest |a| (1 where a is all zero)."""
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / a.abs().max().clamp(min=1e-300)) \
        if a.numel() else 0.0


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


def train_step_4x2(rank, world, ckpt_dir, ref_params):
    """The (4,2) sharded train step against one device; the trainer on
    the mesh from the reference's init (``ref_params``, numpy), saving a
    checkpoint every step."""
    mesh = make_test_mesh((4, 2), device_type="cpu")
    cfg = f32_cfg()
    shape = ShapeConfig("t", seq_len=SEQ, global_batch=BATCH, kind="train")
    batch = {k: torch.from_numpy(v) for k, v in
             make_batch(cfg, shape, step=0).items()}

    lm1 = build_lm(cfg, device="cpu")
    p1 = lm1.init(torch.Generator().manual_seed(0))
    p1n, o1n, m1 = make_train_step(lm1, OPT)(p1, init_opt_state(p1), batch)

    lm2 = build_lm(cfg, mesh, global_batch=BATCH)
    p2 = lm2.init(torch.Generator().manual_seed(0))
    init_equal = all(_bits_equal(a, full(b)) for a, b in
                     zip(leaves(p1), leaves(p2)))
    p2n, o2n, m2 = make_train_step(lm2, OPT)(p2, init_opt_state(p2), batch)
    specs = lm2.param_specs()
    ospecs = opt_state_specs(specs)
    layout = all(tuple(t.placements) == placements(s, mesh)
                 for t, s in zip(leaves({"p": p2n, "m": o2n["m"]}),
                                 leaves({"p": specs, "m": ospecs["m"]})))
    errs = {name: max(_rel(a, full(b)) for a, b in zip(leaves(x), leaves(y)))
            for name, x, y in (("params", p1n, p2n), ("m", o1n["m"], o2n["m"]),
                               ("v", o1n["v"], o2n["v"]))}
    out = Trainer(trainer_config(ckpt_dir), mesh=mesh,
                  params=convert.lm_params(ref_params, "cpu")).run()
    return {"loss1": float(m1["loss"]), "loss2": float(full(m2["loss"])),
            "gnorm1": float(m1["grad_norm"]),
            "gnorm2": float(full(m2["grad_norm"])),
            "init_equal": init_equal, "layout": layout, "errs": errs,
            "history": out["history"],
            "plan": Trainer(trainer_config(), mesh=mesh)
            .rescale_plan().describe()}


def _restore_bits(ckpt_dir, step, target, specs, mesh):
    """(every restored leaf equal to the plain load, restored onto
    ``mesh`` in its spec's layout)."""
    on_mesh = load_checkpoint(ckpt_dir, step, target, mesh=mesh,
                              specs=specs)
    plain = load_checkpoint(ckpt_dir, step, target)
    equal = all(_bits_equal(full(a), b)
                for a, b in zip(leaves(on_mesh), leaves(plain)))
    laid = all(tuple(a.placements) == placements(s, mesh) and
               a.device_mesh == mesh
               for a, s in zip(leaves(on_mesh), leaves(specs)))
    return equal, laid


def serve_2x2(rank, world, ckpt_dir, ref_dir):
    """On a (2,2) mesh: restores of the (4,2) trainer's checkpoint and of
    one the reference wrote; prefill and decode against one device;
    ``compressed_psum`` over ``data``."""
    mesh = make_test_mesh((2, 2), device_type="cpu")
    cfg = f32_cfg()
    out = {}

    lm = build_lm(cfg, mesh, global_batch=BATCH)
    specs = lm.param_specs()
    params = lm.init(torch.Generator().manual_seed(1))
    tree = {"params": params, "opt": init_opt_state(params)}
    out["restore_4x2"] = _restore_bits(
        ckpt_dir, TRAIN_STEPS, tree,
        {"params": specs, "opt": opt_state_specs(specs)}, mesh)
    ref_cfg = get_arch(ARCH, smoke=True)
    ref_lm = build_lm(ref_cfg, mesh, global_batch=BATCH)
    out["restore_ref"] = _restore_bits(
        ref_dir, 0, {"params": ref_lm.init(torch.Generator().manual_seed(0))},
        {"params": ref_lm.param_specs()}, mesh)
    out.update(_serve(cfg, mesh))
    out["server_tokens"] = _server_tokens(mesh)
    out["psum"] = _psum(mesh, rank)
    return out


def _server_tokens(mesh):
    """Greedy outputs of ``Server`` (yi-34b smoke, 12 requests in batches
    of 8 and 4) on ``mesh`` and on one device."""
    from repro_torch.launch.serve import Request, Server
    out = {}
    for name, kw in (("one", dict(device="cpu")), ("mesh", dict(mesh=mesh))):
        rng = np.random.default_rng(0)
        server = Server(ARCH, smoke=True, **kw)
        reqs = [Request(rid=i, prompt=rng.integers(
            0, server.cfg.vocab_size, 16).astype(np.int32),
            max_new_tokens=4, arrival_cycle=i * 3) for i in range(12)]
        stats = server.serve(reqs)
        out[name] = ([r.output for r in reqs], stats.batches)
    return out


def _serve(cfg, mesh):
    """Prefill and 3 greedy decode steps on one device and on ``mesh``
    from the same init: the logits, the caches, and whether the cache the
    caller holds changed in place."""
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (4, 12)).astype(np.int32))
    runs = {}
    for name, lm in (("one", build_lm(cfg, device="cpu")),
                     ("mesh", build_lm(cfg, mesh, global_batch=4))):
        params = lm.init(torch.Generator().manual_seed(0))
        logits, cache, cur = lm.prefill(params, {"tokens": toks}, max_len=20)
        held = [x for sub in cache.values() for e in sub.values() for x in e]
        before = [full(x).clone() for x in held]
        outs = [full(logits)]
        tok = torch.argmax(outs[-1], -1).to(torch.int32)
        comm = None
        for i in range(3):
            if name == "mesh" and i == 0:
                from torch.distributed.tensor.debug import CommDebugMode
                with CommDebugMode() as cd:
                    logits, cache = lm.decode_step(params, tok, cache, cur)
                comm = {str(k).split(".")[-1]: v
                        for k, v in cd.get_comm_counts().items()}
            else:
                logits, cache = lm.decode_step(params, tok, cache, cur + i)
            outs.append(full(logits))
            tok = torch.argmax(outs[-1], -1).to(torch.int32)
        runs[name] = dict(logits=outs, held=[full(x) for x in held],
                          before=before, comm=comm,
                          kinds={type(x).__name__ for x in held})
    one, on = runs["one"], runs["mesh"]
    return {"logits_err": max(_rel(a, b) for a, b in zip(one["logits"],
                                                          on["logits"])),
            "cache_err": max(_rel(a, b) for a, b in zip(one["held"],
                                                        on["held"])),
            "cache_changed": any(not torch.equal(a, b) for a, b in
                                 zip(on["held"], on["before"])),
            "cache_kinds": sorted(on["kinds"]),
            "tokens_equal": all(torch.equal(a.argmax(-1), b.argmax(-1))
                                for a, b in zip(one["logits"],
                                                on["logits"])),
            "decode_comm": on["comm"]}


def psum_inputs(rank: int):
    """The gradient tree and residuals of ``rank`` for the
    ``compressed_psum`` check (seeded by rank)."""
    rng = np.random.default_rng(100 + rank)
    g = {"a": rng.standard_normal((6, 5)).astype(np.float32),
         "b": (rng.standard_normal(7) * 1e-3).astype(np.float32)}
    r = {"a": (rng.standard_normal((6, 5)) * 1e-2).astype(np.float32),
         "b": np.zeros(7, np.float32)}
    return g, r


def _psum(mesh, rank):
    g, r = psum_inputs(rank)
    g = {k: torch.from_numpy(v) for k, v in g.items()}
    r = {k: torch.from_numpy(v) for k, v in r.items()}
    res = {}
    for mode in ("int8", "bf16", "f32"):
        mean, resid = compressed_psum(g, r, "data", mesh=mesh, mode=mode)
        res[mode] = ({k: v.numpy() for k, v in mean.items()},
                     {k: v.numpy() for k, v in resid.items()})
    res["zero_residuals"] = {k: v.numpy()
                             for k, v in init_residuals(g).items()}
    return res


def ep_2x4(rank, world):
    """On a (2,4) mesh: ``moe_ffn_ep`` against the token-choice dispatch
    on one device (jamba smoke, float32, capacity factor 8), then an EP
    train step of the whole model."""
    from repro_torch.models import blocks
    from repro_torch.models.moe_ep import moe_ffn_ep
    from repro_torch.models.params import map_tree
    mesh = make_test_mesh((2, 4), device_type="cpu")
    cfg = f32_cfg("jamba-v0.1-52b", capacity_factor=8.0)
    params = build_lm(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    pos = next(k for k, v in params["layers"].items() if "moe" in v)
    p = map_tree(lambda t: t[0], params["layers"][pos]["moe"])
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (4, 16, cfg.d_model)).astype(np.float32))
    want, want_aux = blocks.moe_ffn(p, x, cfg)
    got, got_aux = moe_ffn_ep(p, x, cfg, mesh)
    out = {"err": _rel(want, full(got)),
           "aux_err": max(abs(float(want_aux[k]) - float(full(got_aux[k])))
                          for k in want_aux),
           "layout": [str(q) for q in got.placements]}

    base = get_arch("jamba-v0.1-52b", smoke=True)
    lm = build_lm(base, mesh, global_batch=8, moe_strategy="ep")
    params = lm.init(torch.Generator().manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, base.vocab_size, (8, 32)).astype(np.int32))
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}
    from repro_torch.launch.train import loss_and_grads
    loss, _, grads = loss_and_grads(lm, params, batch)
    p2, _, m = make_train_step(lm, OPT)(params, init_opt_state(params),
                                        batch)
    out["loss"] = float(full(loss))
    out["grads_finite"] = all(bool(torch.isfinite(full(g).float()).all())
                              for g in leaves(grads))
    out["expert_grads_nonzero"] = all(
        bool(full(grads["layers"][k]["moe"][w]).abs().sum() > 0)
        for k in grads["layers"] if "moe" in grads["layers"][k]
        for w in ("w_gate", "w_up", "w_down"))
    out["step_loss"] = float(full(m["loss"]))
    out["expert_layout"] = [str(q) for q in
                            params["layers"][pos]["moe"]["w_gate"].placements]
    return out
