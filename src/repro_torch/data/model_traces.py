"""Per-architecture workload zoo: the pinned model traces (ARCHITECTURE §13).

Counterpart of the part of the reference's ``repro.data.model_traces``
that replays traces: the per-family representatives, the replay row
stride and the loader of the pinned traces that feed the golden harness
(``tests/core/golden_cases.py``). The traces are JSON under
``tests/goldens/traces/``, read as data through the port's own
``TraceCapture.load``; nothing is recaptured. Capturing a trace from a
model (the reference's ``capture_model_trace``) is ROADMAP A7.6.

The replay contract is closed-loop: ``TraceCapture.replay_arrays`` folds
ports onto ``config.num_pes`` and drops the logical arrival clock, so
``MemoryController.simulate`` keeps its cache + batch-scheduler stages
(nonzero arrivals would flip it into open-loop serving mode).
"""

from __future__ import annotations

import os

from repro_torch.configs import registry
from repro_torch.core.capture import TraceCapture

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


def load_pinned_trace(arch: str) -> TraceCapture:
    """The checked-in golden trace for ``arch`` (family representative)."""
    return TraceCapture.load(pinned_trace_path(arch))

