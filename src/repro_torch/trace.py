"""``python -m repro_torch.trace`` — trace one run, export Perfetto JSON +
cycle attribution.

The observability front door (ARCHITECTURE §11): run a workload through
``MemoryController.simulate`` with a
:class:`~repro_torch.core.telemetry.TraceRecorder` attached, then

* write the Chrome-trace-event / Perfetto JSON
  (``repro_torch.launch.tracing``) — open it at https://ui.perfetto.dev;
* write the :class:`~repro_torch.core.telemetry.CycleAttribution` rollup
  (component totals, per-tenant, top-K hot rows) as JSON;
* print the human-readable attribution summary.

The positional argument is a **JSON config path** describing a
synthetic workload::

      {"workload": "poisson",         // or "hog_victim"
       "n": 3000, "seed": 3, "rate": 0.05,
       "num_pes": 1, "arb": "round_robin", "weights": null,
       "policy": "frfcfs", "window": 16, "starvation_cap": 16,
       "t_rfc": 420, "t_refi": 9363}

Counterpart of the reference's ``python -m repro.trace``, which also
takes a golden case name from ``tests/core/golden_cases.py``; those cases
are built with the reference package, so the port refuses a name and
points to the JSON form (ROADMAP C16).

Example::

    python -m repro_torch.trace my_workload.json --out t.json --attr a.json
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def _run_golden(name: str, recorder):
    """A golden case name: not served by the port (ROADMAP C16). The cases
    live in ``tests/core/golden_cases.py``, which builds them with the
    reference package (it imports ``repro.core``), and the port imports
    nothing of that package."""
    raise SystemExit(
        f"{name!r}: golden case names are not served by repro_torch.trace "
        "— tests/core/golden_cases.py builds them with the reference "
        "package, which the port does not import; describe the workload "
        "in a JSON config and pass its path (see "
        "`python -m repro_torch.trace --help`)")


def _run_config(path: str, recorder):
    from repro_torch.core.config import (DRAMSchedConfig,
                                         MemoryControllerConfig,
                                         SchedulerConfig, CacheConfig)
    from repro_torch.core.controller import MemoryController
    from repro_torch.data import synthetic

    with open(path) as fh:
        cfg = json.load(fh)
    n = int(cfg.get("n", 3000))
    rng = np.random.default_rng(int(cfg.get("seed", 0)))
    workload = cfg.get("workload", "poisson")
    if workload == "hog_victim":
        rows, rw, pe, arr = synthetic.hog_victim_workload(
            rng, n_victim=n // 5, n_hog=n - n // 5,
            victim_rate=float(cfg.get("rate", 0.05)) / 5,
            hog_rate=float(cfg.get("rate", 0.05)))
        num_pes = max(2, int(cfg.get("num_pes", 2)))
    elif workload == "poisson":
        rows = (np.floor(np.minimum(np.clip(rng.random(n), 1e-12, 1.0)
                                    ** -5.0, 2.0 ** 62)).astype(np.int64)
                - 1) % 8192
        rw = (rng.random(n) < 0.1).astype(np.int32)
        arr = synthetic.poisson_arrivals(rng, n,
                                         float(cfg.get("rate", 0.05)))
        num_pes = int(cfg.get("num_pes", 1))
        pe = rng.integers(0, num_pes, n) if num_pes > 1 else None
    else:
        raise SystemExit(f"unknown workload {workload!r} "
                         "(poisson | hog_victim)")
    mc_config = MemoryControllerConfig(
        num_pes=num_pes,
        scheduler=SchedulerConfig(enabled=False),
        cache=CacheConfig(enabled=False),
        dram_sched=DRAMSchedConfig(
            policy=cfg.get("policy", "frfcfs"),
            reorder_window=int(cfg.get("window", 16)),
            starvation_cap=int(cfg.get("starvation_cap", 16)),
            t_rfc=int(cfg.get("t_rfc", 0)),
            t_refi=int(cfg.get("t_refi", 0))))
    weights = cfg.get("weights")
    return MemoryController(mc_config).simulate(
        pe, rows, rw, 4096,
        arbiter_policy=cfg.get("arb", "round_robin"),
        weights=None if weights is None else tuple(weights),
        arrival_cycle=arr, trace=recorder)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.trace",
        description="Trace one run; export Perfetto JSON + cycle "
                    "attribution.")
    ap.add_argument("case", help="JSON config path (a golden case name is "
                                 "refused: see ROADMAP C16)")
    ap.add_argument("--out", default=None,
                    help="Perfetto trace output path "
                         "(default <case>.trace.json)")
    ap.add_argument("--attr", default=None,
                    help="attribution JSON output path "
                         "(default <case>.attr.json)")
    ap.add_argument("--validate", action="store_true",
                    help="re-validate the exported JSON against the "
                         "trace-event schema and print the counts")
    ap.add_argument("--top-k", type=int, default=10,
                    help="hot rows to report (default 10)")
    ap.add_argument("--max-slices", type=int, default=None,
                    help="cap per-request sojourn slices in the export")
    args = ap.parse_args(argv)

    from repro_torch.core.telemetry import CycleAttribution, TraceRecorder
    from repro_torch.launch import tracing

    recorder = TraceRecorder()
    if args.case.endswith(".json") or os.path.sep in args.case:
        result = _run_config(args.case, recorder)
        stem = os.path.splitext(os.path.basename(args.case))[0]
    else:
        result = _run_golden(args.case, recorder)
        stem = args.case

    out = args.out or f"{stem}.trace.json"
    attr_path = args.attr or f"{stem}.attr.json"
    counts = tracing.write_chrome_trace(
        out, recorder, max_request_slices=args.max_slices)
    att = CycleAttribution.from_pipeline(result, recorder)
    tracing.write_attribution(attr_path, att, top_k=args.top_k)

    print(f"trace: {out} ({counts['X']} slices, {counts['C']} counter "
          f"samples, {recorder.n_events} recorded events)")
    print(f"attribution: {attr_path}")
    if args.validate:
        with open(out) as fh:
            counts = tracing.validate_chrome_trace(json.load(fh))
        print(f"validated: {counts}")
    print()
    print(att.summary_text(top_k=args.top_k))
    return 0


if __name__ == "__main__":
    sys.exit(main())
