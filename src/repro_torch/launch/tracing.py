"""Chrome-trace-event (Perfetto) export of a :class:`TraceRecorder`.

Renders the per-request lifecycle stream recorded by
``repro_torch.core.telemetry`` into the JSON object format every Chrome
``about:tracing`` / Perfetto build ingests (ARCHITECTURE §11):

* one *process* per memory channel (``pid = channel + 1``) holding a
  ``timeline`` thread (refresh windows, outage windows, idle gaps, bus
  turnarounds as duration slices) plus one ``bank b`` thread per
  touched bank (every DRAM issue as a slice — class, attempt and ECC
  outcome in ``args``);
* one ``ports`` process (``pid = PORTS_PID``) with a thread per port
  carrying each request's whole-sojourn slice (open-loop runs only —
  closed-loop runs have no arrival stamps);
* two counter tracks per channel — ``queue_depth`` (arrived/granted
  but not completed) and ``reorder_occupancy`` (inside the reorder
  window / in service);
* ``M``-phase metadata naming every process and thread.

Timestamps are nanoseconds-derived microseconds (the trace-event
unit): DRAM-clock events map through ``t_mem_ns`` plus the uniform
pre-DRAM pipeline shift, FPGA-cycle arrival stamps through
``t_fpga_ns`` — both land on one shared timeline, so a request's
arrival, issues and completion line up across tracks.

``validate_chrome_trace`` is a dependency-free structural validator
(the CI trace-smoke step runs it on an exported golden); it raises
``ValueError`` with the offending event on any violation and returns
per-phase counts on success.

Counterpart of the reference's ``repro.launch.tracing``, copied; the
exported object names this module as its ``generator``.
"""

from __future__ import annotations

import json

import numpy as np

#: pid of the synthetic "ports" process (channel pids are 1-based and
#: small, so this never collides).
PORTS_PID = 1000

_TIMELINE_TID = 0
_BANK_TID_BASE = 1


def _cat(kind: str) -> str:
    return {"refresh": "dram", "outage": "ras", "idle": "front",
            "turn": "dram", "issue": "dram"}.get(kind, "trace")


def to_chrome_trace(recorder, *, max_request_slices: int | None = None
                    ) -> dict:
    """Render ``recorder`` as a Chrome trace-event JSON object.

    ``max_request_slices`` truncates the per-request sojourn track (the
    only track that scales with request count rather than event count);
    ``None`` keeps every request. Truncation is recorded in
    ``otherData.request_slices_dropped`` — never silent.
    """
    if recorder.timings is None:
        raise ValueError("recorder was never finalized — run a "
                         "simulation with trace=<recorder> first")
    t_mem = float(recorder.timings.t_mem_ns)
    t_fpga = float(recorder.timings.t_fpga_ns)
    pre_ns = float(recorder.pre_fpga) * t_fpga

    def us_dram(t: float) -> float:
        return (t * t_mem + pre_ns) / 1000.0

    def us_fpga(t: float) -> float:
        return t * t_fpga / 1000.0

    ev_out: list[dict] = []
    meta: list[dict] = []

    def name_proc(pid: int, name: str) -> None:
        meta.append({"ph": "M", "name": "process_name", "pid": pid,
                     "tid": 0, "args": {"name": name}})

    def name_thread(pid: int, tid: int, name: str) -> None:
        meta.append({"ph": "M", "name": "thread_name", "pid": pid,
                     "tid": tid, "args": {"name": name}})

    complete_us: dict[int, float] = {}     # seq -> completion (us)
    outcome_by_seq: dict[int, str] = {}

    for k, ct in sorted(recorder.channels.items()):
        pid = k + 1
        name_proc(pid, f"channel {k}")
        name_thread(pid, _TIMELINE_TID, "timeline")
        banks_seen: set[int] = set()
        # counter deltas: (ts_us, d_queue, d_reorder)
        deltas: list[tuple[float, int, int]] = []
        for e in ct.events:
            kind = e[0]
            if kind in ("refresh", "outage", "idle"):
                t0, t1 = us_dram(e[1]), us_dram(e[2])
                ev_out.append({"ph": "X", "name": kind, "cat": _cat(kind),
                               "ts": t0, "dur": max(0.0, t1 - t0),
                               "pid": pid, "tid": _TIMELINE_TID})
            elif kind == "turn":
                t0 = us_dram(e[1])
                ev_out.append({"ph": "X", "name": f"turn:{e[2]}",
                               "cat": "dram", "ts": t0,
                               "dur": e[3] * t_mem / 1000.0,
                               "pid": pid, "tid": _TIMELINE_TID,
                               "args": {"penalty_dram_clocks": int(e[3])}})
            elif kind == "issue":
                _, t, req, bank, row, cls, cost, attempt, outcome = e
                b = int(bank)
                banks_seen.add(b)
                seq = ct.resolve(req)
                ev_out.append({
                    "ph": "X", "name": f"issue:{cls}", "cat": "dram",
                    "ts": us_dram(t), "dur": cost * t_mem / 1000.0,
                    "pid": pid, "tid": _BANK_TID_BASE + b,
                    "args": {"seq": seq, "row": int(row),
                             "attempt": int(attempt),
                             "outcome": outcome}})
                outcome_by_seq[seq] = outcome
            elif kind in ("grant", "window", "readmit"):
                deltas.append((us_dram(e[1]), 0, +1))
            elif kind in ("complete", "drop"):
                t_us = us_dram(e[1])
                deltas.append((t_us, -1, -1))
                complete_us[ct.resolve(e[2])] = t_us
                if kind == "drop":
                    outcome_by_seq[ct.resolve(e[2])] = "dropped"
        for b in sorted(banks_seen):
            name_thread(pid, _BANK_TID_BASE + b, f"bank {b}")
        # arrivals (open-loop) feed the channel's queue-depth counter
        if recorder.open_loop and ct.req_ids is not None \
                and recorder.arrival_fpga is not None:
            for s in ct.req_ids.tolist():
                deltas.append((us_fpga(float(recorder.arrival_fpga[s])),
                               +1, 0))
        deltas.sort(key=lambda d: d[0])
        q = r = 0
        for ts, dq, dr in deltas:
            if dq:
                q += dq
                ev_out.append({"ph": "C", "name": f"ch{k} queue_depth",
                               "ts": ts, "pid": pid,
                               "args": {"requests": q}})
            if dr:
                r += dr
                ev_out.append({"ph": "C",
                               "name": f"ch{k} reorder_occupancy",
                               "ts": ts, "pid": pid,
                               "args": {"requests": r}})

    dropped_slices = 0
    if recorder.open_loop and recorder.arrival_fpga is not None:
        name_proc(PORTS_PID, "ports")
        pe = recorder.pe_by_seq
        n = int(recorder.arrival_fpga.shape[0])
        ports_seen: set[int] = set()
        limit = n if max_request_slices is None else max_request_slices
        for s in range(n):
            if s >= limit:
                dropped_slices = n - limit
                break
            end = complete_us.get(s)
            if end is None:
                continue
            t0 = us_fpga(float(recorder.arrival_fpga[s]))
            port = int(pe[s]) if pe is not None else 0
            ports_seen.add(port)
            ev_out.append({
                "ph": "X", "name": "request", "cat": "request",
                "ts": t0, "dur": max(0.0, end - t0),
                "pid": PORTS_PID, "tid": port,
                "args": {"seq": s,
                         "outcome": outcome_by_seq.get(s, "ok")}})
        for p in sorted(ports_seen):
            name_thread(PORTS_PID, p, f"port {p}")

    return {
        "traceEvents": meta + ev_out,
        "displayTimeUnit": "ns",
        "otherData": {
            "generator": "repro_torch.launch.tracing",
            "num_channels": int(recorder.meta.get("num_channels", 0)),
            "open_loop": bool(recorder.open_loop),
            "n_events": int(recorder.n_events),
            "makespan_fpga_cycles": float(recorder.makespan_fpga),
            "request_slices_dropped": int(dropped_slices),
        },
    }


def validate_chrome_trace(obj) -> dict:
    """Structural validation against the trace-event JSON object format.

    Checks the envelope, then every event by phase: ``X`` slices need
    numeric non-negative ``ts``/``dur`` and integer ``pid``/``tid``;
    ``C`` counters need numeric-valued ``args``; ``M`` metadata must be
    ``process_name``/``thread_name`` with a string ``args.name``.
    Raises ``ValueError`` naming the first offending event; returns
    per-phase counts on success.
    """
    if not isinstance(obj, dict) or "traceEvents" not in obj:
        raise ValueError("trace must be a JSON object with 'traceEvents'")
    events = obj["traceEvents"]
    if not isinstance(events, list) or not events:
        raise ValueError("'traceEvents' must be a non-empty list")
    counts = {"X": 0, "C": 0, "M": 0}

    def bad(i, e, why):
        raise ValueError(f"traceEvents[{i}] {why}: {e!r}")

    for i, e in enumerate(events):
        if not isinstance(e, dict):
            bad(i, e, "is not an object")
        ph = e.get("ph")
        if ph not in counts:
            bad(i, e, f"has unsupported phase {ph!r}")
        if not isinstance(e.get("name"), str) or not e["name"]:
            bad(i, e, "needs a non-empty string 'name'")
        if not isinstance(e.get("pid"), int):
            bad(i, e, "needs an integer 'pid'")
        if ph == "X":
            for f in ("ts", "dur"):
                v = e.get(f)
                if not isinstance(v, (int, float)) or v < 0:
                    bad(i, e, f"needs numeric non-negative {f!r}")
            if not isinstance(e.get("tid"), int):
                bad(i, e, "needs an integer 'tid'")
        elif ph == "C":
            v = e.get("ts")
            if not isinstance(v, (int, float)) or v < 0:
                bad(i, e, "needs numeric non-negative 'ts'")
            args = e.get("args")
            if not isinstance(args, dict) or not args:
                bad(i, e, "needs a non-empty 'args' object")
            for key, val in args.items():
                if not isinstance(val, (int, float)):
                    bad(i, e, f"counter series {key!r} must be numeric")
        else:                                   # "M"
            if e["name"] not in ("process_name", "thread_name"):
                bad(i, e, "metadata name must be process_name/"
                          "thread_name")
            args = e.get("args")
            if not isinstance(args, dict) \
                    or not isinstance(args.get("name"), str):
                bad(i, e, "metadata needs args.name string")
        counts[ph] += 1
    if counts["X"] == 0:
        raise ValueError("trace has no duration slices")
    return counts


def write_chrome_trace(path, recorder, **kwargs) -> dict:
    """Export ``recorder`` to ``path`` (validated first); returns the
    validator's per-phase counts."""
    obj = to_chrome_trace(recorder, **kwargs)
    counts = validate_chrome_trace(obj)
    with open(path, "w") as fh:
        json.dump(obj, fh)
    return counts


def _to_jsonable(x):
    if isinstance(x, (np.integer,)):
        return int(x)
    if isinstance(x, (np.floating,)):
        return float(x)
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, dict):
        return {k: _to_jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_to_jsonable(v) for v in x]
    return x


def write_attribution(path, attribution, top_k: int = 10) -> dict:
    """Dump a :class:`~repro_torch.core.telemetry.CycleAttribution` rollup as
    JSON; returns the written object."""
    obj = _to_jsonable(attribution.as_dict(top_k=top_k))
    with open(path, "w") as fh:
        json.dump(obj, fh, indent=2)
    return obj
