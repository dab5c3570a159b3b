"""Render the §Dry-run and §Roofline tables from the dry-run JSONL
records.

Counterpart of ``repro.launch.report``, for the records of either
package: a field the port's dry run has no counterpart for (its compile
seconds, XLA's memory analysis) is null there and renders as "—".

Usage: python -m repro_torch.launch.report experiments_dryrun.jsonl
"""

from __future__ import annotations

import json
import sys
from typing import Dict, List


def load(path: str) -> List[Dict]:
    recs = []
    with open(path) as f:
        for line in f:
            recs.append(json.loads(line))
    # keep the latest record per cell
    by_cell = {}
    for r in recs:
        by_cell[r["cell"]] = r
    return list(by_cell.values())


def fmt_bytes(b: float) -> str:
    if b >= 1 << 30:
        return f"{b / (1 << 30):.2f}G"
    if b >= 1 << 20:
        return f"{b / (1 << 20):.1f}M"
    return f"{b / 1024:.0f}K"


def dryrun_table(recs: List[Dict]) -> str:
    rows = ["| cell | mesh | compile s | state B/dev | temp B/dev | "
            "HLO FLOPs (global) | collective B/dev (AG/AR/RS/A2A/CP) |",
            "|---|---|---|---|---|---|---|"]
    for r in sorted(recs, key=lambda x: x["cell"]):
        if "error" in r:
            rows.append(f"| {r['cell']} | — | FAILED: {r['error'][:60]} | "
                        "| | | |")
            continue
        ma = r.get("memory_analysis") or {}
        det = r.get("collectives_detail", {})
        coll = "/".join(fmt_bytes(det.get(k, 0)) for k in
                        ("all-gather", "all-reduce", "reduce-scatter",
                         "all-to-all", "collective-permute"))
        arch_shape, mesh = r["cell"].rsplit("/", 1)
        compile_s = ("—" if r.get("compile_s") is None
                     else f"{r['compile_s']:.0f}")
        temp = (None if r.get("memory_analysis") is None
                else ma.get("temp_size_in_bytes", 0))
        rows.append(
            f"| {arch_shape} | {mesh} | {compile_s} | "
            f"{fmt_bytes(r['state_bytes_per_device'])} | "
            f"{'—' if temp is None else fmt_bytes(temp)} | "
            f"{r['hlo_flops']:.3e} | {coll} |")
    return "\n".join(rows)


def roofline_table(recs: List[Dict], mesh: str = "1pod") -> str:
    rows = ["| arch/shape | compute s | memory s | collective s | "
            "bottleneck | MODEL/HLO flops | roofline frac |",
            "|---|---|---|---|---|---|---|"]
    for r in sorted(recs, key=lambda x: x["cell"]):
        if "error" in r or not r["cell"].endswith("/" + mesh):
            continue
        arch_shape = r["cell"].rsplit("/", 1)[0]
        rows.append(
            f"| {arch_shape} | {r['compute_s']:.4f} | {r['memory_s']:.4f} |"
            f" {r['collective_s']:.4f} | **{r['bottleneck']}** | "
            f"{r['useful_flops_ratio']:.2f} | "
            f"{r['roofline_fraction']:.3f} |")
    return "\n".join(rows)


def summary(recs: List[Dict]) -> str:
    ok = [r for r in recs if "error" not in r]
    fails = [r for r in recs if "error" in r]
    lines = [f"cells compiled OK: {len(ok)}; failed: {len(fails)}"]
    pods1 = [r for r in ok if r["cell"].endswith("1pod")]
    if pods1:
        worst = min(pods1, key=lambda r: r["roofline_fraction"])
        coll = max(pods1, key=lambda r: r["collective_s"]
                   / max(r["compute_s"] + r["memory_s"], 1e-30))
        lines.append(f"worst roofline fraction: {worst['cell']} "
                     f"({worst['roofline_fraction']:.3f})")
        lines.append(f"most collective-exposed: {coll['cell']} "
                     f"(coll {coll['collective_s']:.4f}s vs bound "
                     f"{max(coll['compute_s'], coll['memory_s']):.4f}s)")
    return "\n".join(lines)


def main() -> None:
    recs = load(sys.argv[1] if len(sys.argv) > 1
                else "experiments_dryrun.jsonl")
    print("## Summary\n")
    print(summary(recs))
    print("\n## Dry-run table\n")
    print(dryrun_table(recs))
    print("\n## Roofline (single-pod)\n")
    print(roofline_table(recs, "1pod"))
    print("\n## Roofline (multi-pod, 512 chips)\n")
    print(roofline_table(recs, "2pod"))


if __name__ == "__main__":
    main()
