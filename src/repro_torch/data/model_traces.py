"""Per-architecture workload zoo: captured model traces (ARCHITECTURE §13).

Counterpart of the reference's ``repro.data.model_traces``.
:func:`capture_model_trace` runs a registry architecture's *smoke*
configuration through a fixed exercise script with a
:class:`~repro_torch.core.capture.TraceCapture` active, and returns the
``(pe_id, row_id, rw, bytes, arrival)`` request stream the model actually
emitted. The script covers every controller-routed traffic class:

* **forward/train** — embedding gathers (``mc_embed``), MoE expert
  dispatch+combine (multi-port: expert = PE), audio/vision frontend
  streaming reads;
* **embedding-gradient update** — the irregular WRITE stream
  (``mc_scatter``, mode="add");
* **prefill + decode steps** — 1-D decode-token gathers, KV-page
  bulk-write appends (``mc_kv_append``), SSM state rewrites (mamba).

The port's layer walk is eager, so every hook sees concrete values; a
hook on the card copies its ids to the host. The pinned traces (one
representative per model family, ``tests/goldens/traces/``) are the
reference's and are regenerated by it (``scripts/regen_goldens.py
--traces``); here they are loaded as data for the golden harness
(``tests/core/golden_cases.py``) and the tuner.

The replay contract is closed-loop: ``TraceCapture.replay_arrays`` folds
ports onto ``config.num_pes`` and drops the logical arrival clock, so
``MemoryController.simulate`` keeps its cache + batch-scheduler stages
(nonzero arrivals would flip it into open-loop serving mode).
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.capture import TraceCapture

# Fixed zoo shape: big enough that scheduler batches, cache working sets
# and multi-port contention are non-degenerate; small enough that all 10
# architectures capture in seconds on CPU.
CAPTURE_BATCH = 4
CAPTURE_SEQ = 64
CAPTURE_DECODE_STEPS = 8
TRACE_SEED = 0
# Replay granularity: the capture is row-indexed; every row is priced at
# the goldens' canonical 4 KiB stride (per-request true transfer sizes
# stay available in ``TraceCapture.rows()['nbytes']``).
REPLAY_ROW_BYTES = 4096

# One pinned golden trace per model family (family -> registry id).
FAMILY_REPRESENTATIVE = {
    "dense": "yi_34b",
    "moe": "mixtral_8x7b",
    "ssm": "mamba2_2p7b",
    "hybrid": "jamba_v0p1_52b",
    "encoder": "hubert_xlarge",
    "vlm": "internvl2_76b",
}

TRACE_DIR = os.path.normpath(os.path.join(
    os.path.dirname(os.path.abspath(__file__)),
    "..", "..", "..", "tests", "goldens", "traces"))


def arch_families() -> dict:
    """registry id -> family string, for all 10 architectures."""
    return {a: registry.get_arch(a, smoke=True).family
            for a in registry.ARCH_IDS}


def pinned_trace_path(arch: str) -> str:
    return os.path.join(TRACE_DIR, f"{registry.canonical(arch)}.json")


def capture_model_trace(arch: str, *, params=None, seed: int = TRACE_SEED,
                        batch: int = CAPTURE_BATCH, seq: int = CAPTURE_SEQ,
                        decode_steps: int = CAPTURE_DECODE_STEPS,
                        device: str | torch.device = "cuda") -> TraceCapture:
    """Run the fixed exercise script for ``arch`` (smoke config) on
    ``device`` under an active recorder; returns the captured trace.

    ``params`` are the weights to run: the reference draws its own from
    ``jax.random.PRNGKey(seed)``, which torch cannot replay, so a caller
    that wants the reference's trace passes the reference's parameters
    (``repro_torch.convert.lm_params``); without them the port's seeded
    init (``torch.Generator`` seeded ``seed``) is used. The data is
    ``make_batch``'s, the same numpy draws as the reference's. Decode
    feeds back argmax tokens, so the decode gathers and the MoE routes
    depend on the weights' values and arithmetic (:func:`value_dependent`).
    Raises if any hooked op was skipped (the zoo must observe *all*
    traffic) or if the capture is empty.
    """
    from repro_torch.data.synthetic import make_batch
    from repro_torch.models.lm import build_lm

    cfg = registry.get_arch(arch, smoke=True)
    device = torch.device(device)
    lm = build_lm(cfg, device=device)
    if params is None:
        params = lm.init(torch.Generator(device).manual_seed(seed))
    shape = ShapeConfig(f"capture_{seq}x{batch}", seq, batch, "train")
    data = {k: torch.from_numpy(v).to(device)
            for k, v in make_batch(cfg, shape, step=0, seed=seed).items()}

    with TraceCapture() as cap:
        lm.forward(params, data)
        if "tokens" in data:
            tokens = data["tokens"]
            table = params["embed"]["table"]
            grad_rows = torch.ones((*tokens.shape, table.shape[-1]),
                                   dtype=table.dtype, device=device)
            lm.embedding_grad_update(params, tokens, grad_rows)
        if cfg.family != "encoder":
            serve = {k: v for k, v in data.items()
                     if k not in ("labels", "loss_mask")}
            logits, cache, cur = lm.prefill(params, serve,
                                            max_len=seq + decode_steps)
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
            for _ in range(decode_steps):
                logits, cache = lm.decode_step(params, tok, cache, cur)
                cur = cur + 1
                tok = torch.argmax(logits, dim=-1).to(torch.int32)
    if cap.n_skipped_traced:
        raise RuntimeError(
            f"{arch}: {cap.n_skipped_traced} capture hook(s) saw tensors "
            "without data — the zoo must run eagerly")
    if len(cap) == 0:
        raise RuntimeError(f"{arch}: captured trace is empty")
    return cap


@functools.lru_cache(maxsize=None)
def cached_capture(arch: str, seed: int = TRACE_SEED,
                   batch: int = CAPTURE_BATCH, seq: int = CAPTURE_SEQ,
                   decode_steps: int = CAPTURE_DECODE_STEPS,
                   device: str = "cuda") -> TraceCapture:
    """Memoized :func:`capture_model_trace` on the port's seeded params —
    tests and benchmarks share one capture per configuration. Treat the
    result as read-only."""
    return capture_model_trace(arch, seed=seed, batch=batch, seq=seq,
                               decode_steps=decode_steps, device=device)


def value_dependent(cap: TraceCapture) -> np.ndarray:
    """Per captured request, whether its row comes from the model's
    values rather than from the exercise script's data and shapes: the
    MoE dispatch and combine rows (the router's picks) and the gathers of
    the decode steps' tokens (argmax of logits), which are every
    ``embed_gather`` after the forward's and the prefill's. Two runs on
    the same inputs agree on every other row whatever their arithmetic."""
    r = cap.rows()
    labels = np.asarray(cap.op_labels + [""])
    op = labels[r["op"]]
    out = np.isin(op, ["moe_dispatch", "moe_combine"])
    gather = op == "embed_gather"
    stamps = np.unique(r["arrival_cycle"][gather])
    out |= gather & np.isin(r["arrival_cycle"], stamps[2:])
    return out


def load_pinned_trace(arch: str) -> TraceCapture:
    """The checked-in golden trace for ``arch`` (family representative)."""
    return TraceCapture.load(pinned_trace_path(arch))


def summarize(cap: TraceCapture) -> dict:
    """Machine-readable shape of a captured trace (benchmark payloads)."""
    r = cap.rows()
    return {
        "n_requests": int(r["row_id"].size),
        "n_ops": int(cap.n_ops),
        "n_ports": int(cap.n_ports),
        "n_rows_total": int(cap.n_rows_total),
        "write_fraction": float(r["rw"].mean()) if r["rw"].size else 0.0,
        "total_bytes": int(r["nbytes"].sum()),
        "unique_rows": int(np.unique(r["row_id"]).size),
        "op_counts": cap.op_counts(),
    }
