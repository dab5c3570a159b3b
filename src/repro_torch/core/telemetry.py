"""Per-request lifecycle tracing for the staged simulator.

Every modeled number in this repo is an aggregate (makespan, stage
cycles, sojourn percentiles); this module adds the *per-request* lens —
where did each request's cycles go? — as an opt-in recorder threaded
through ``MemoryController.simulate(..., trace=...)``.

Design (docs/ARCHITECTURE.md §11):

* The **seq oracles** (``simulate_dram_sched_seq``,
  ``simulate_arrivals_seq``, ``simulate_faults_seq``) emit events
  natively — the event stream is part of THE specification.
* The **fast paths** stay event-free on the hot path; when a trace is
  requested they run unchanged and the ``replay_*_events`` functions
  here *reconstruct* the identical stream from their recorded outputs
  (``grant_order`` / ``granted_port`` / ``service_order`` plus the
  deterministic fault draws), property-tested event-for-event equal to
  the oracle. ``trace=None`` changes no code path — every golden and
  fast-path result stays bit-identical.

Event schema — plain tuples, kind first. Channel events
(:class:`ChannelTrace`; timestamps in DRAM command clocks on that
channel's clock, request ids are *local* to the simulated stream and
mapped to global ``seq`` via ``req_ids``):

====================================================  =====================
``("window",  t, req)``                               closed-loop reorder-
                                                      window entry
``("grant",   t, req, port)``                         serving admission
                                                      (= window entry in
                                                      the coupled model)
``("readmit", t, req)``                               replay re-admission
``("refresh", t0, t1)``                               refresh stall /
                                                      absorbed window
``("idle",    t0, t1)``                               idle gap (waiting
                                                      for arrivals)
``("outage",  t0, t1)``                               channel outage stall
``("turn",    t, dir, penalty)``                      bus turnaround
                                                      (dir "wtr"|"rtw")
``("issue",   t, req, bank, row, cls, cost,           DRAM issue; cls in
  attempt, outcome)``                                 first|hit|conflict,
                                                      outcome in ok|
                                                      corrected|silent|
                                                      failed
``("replay",  t, req, attempt, ready)``               failed issue queued
                                                      for replay
``("drop",    t, req, attempt)``                      out of attempts
``("complete", t, req)``                              service completion
====================================================  =====================

Stage events (:attr:`TraceRecorder.stage_events`; ordinal, no clock —
the closed-loop front-end stages are order-based):

``("grant_slot", channel, slot, seq, port)`` — closed-loop arbiter grant;
``("cache", channel, seq, "hit"|"miss")`` — cache filter verdict;
``("cache_wb", channel, seq)`` — victim write-back inserted;
``("batch", channel, seq, batch_idx)`` — batch assignment.

Arrival events are stored vectorized (``arrival_fpga`` / ``pe_by_seq``
arrays on the recorder — one ``("arrival", t, seq, port)`` per request
via :meth:`TraceRecorder.arrival_events`) rather than as per-event
tuples; they are pure inputs, so there is nothing to reconstruct.

On top of the recorder, :class:`CycleAttribution` decomposes each
request's sojourn into arrival-gating / arbitration / cache / batch /
reorder-slip / refresh / outage / replay / service components that sum
*exactly* (bit-for-bit, left-to-right) to ``ServingStats.sojourn`` —
property-tested — with per-tenant and top-K hot-row rollups.

Counterpart of the reference's ``repro.core.telemetry``, copied
expression for expression (numpy on the host; the event streams are held
to the reference's with ``==``).
"""

from __future__ import annotations

import dataclasses
import heapq

import numpy as np

from repro_torch.core.config import DRAMSchedConfig, FaultConfig

#: attribution components, in the documented left-to-right summation
#: order (the exact-sum identity is defined over this order).
COMPONENTS = ("gating", "arbitration", "cache", "batch", "reorder",
              "refresh", "outage", "replay", "service")


class ChannelTrace:
    """Event sink for one simulated channel stream.

    ``events`` holds the raw tuples (request ids local to the simulated
    stream); ``req_ids`` maps local index -> global ``seq`` (``None``
    = identity). Emission sites append directly to ``events`` — the
    recorder adds no per-event overhead beyond the list append.
    """

    __slots__ = ("channel", "events", "req_ids")

    def __init__(self, channel: int = 0, req_ids=None):
        self.channel = int(channel)
        self.events: list[tuple] = []
        self.req_ids = None if req_ids is None else \
            np.asarray(req_ids, np.int64)

    def resolve(self, local: int) -> int:
        """Global ``seq`` of a local request index (-1 = retired)."""
        if self.req_ids is None:
            return int(local)
        return int(self.req_ids[local])

    def __len__(self) -> int:
        return len(self.events)


class TraceRecorder:
    """Opt-in per-run event recorder (pass as
    ``MemoryController.simulate(..., trace=TraceRecorder())``).

    Collects one :class:`ChannelTrace` per memory channel plus the
    ordinal stage events, and — filled in by ``run_pipeline`` — the
    metadata the exporter and attribution need (timings, the uniform
    pre-DRAM shift, arrival/port arrays by ``seq``).
    """

    def __init__(self):
        self.meta: dict = {}
        self.timings = None
        self.stage_events: list[tuple] = []
        self.channels: dict[int, ChannelTrace] = {}
        self.arrival_fpga: np.ndarray | None = None   # by seq
        self.pe_by_seq: np.ndarray | None = None      # by seq
        self.pre_fpga: float = 0.0                    # uniform pre-DRAM shift
        self.makespan_fpga: float = 0.0
        self.open_loop: bool = False

    def channel(self, k: int, req_ids=None) -> ChannelTrace:
        ct = ChannelTrace(k, req_ids)
        self.channels[k] = ct
        return ct

    @property
    def n_events(self) -> int:
        return (sum(len(c) for c in self.channels.values())
                + len(self.stage_events))

    def arrival_events(self):
        """Yield ``("arrival", t_fpga, seq, port)`` per request (the
        vectorized arrival store rendered as lifecycle events)."""
        if self.arrival_fpga is None:
            return
        pe = self.pe_by_seq if self.pe_by_seq is not None else \
            np.zeros(self.arrival_fpga.shape[0], np.int64)
        for s in range(self.arrival_fpga.shape[0]):
            yield ("arrival", float(self.arrival_fpga[s]), s, int(pe[s]))

    def finalize(self, ctx, total: float) -> None:
        """Called by ``run_pipeline`` once the makespan is known."""
        self.timings = ctx.timings
        self.makespan_fpga = float(total)
        self.open_loop = ctx.serving_completion is not None
        if self.open_loop:
            self.pre_fpga = float(total - ctx.dram_makespan)
            self.arrival_fpga = ctx.serving_arrival
            self.pe_by_seq = ctx.serving_pe
        self.meta.setdefault("num_channels", ctx.num_channels)
        self.meta.setdefault("open_loop", self.open_loop)


# ---------------------------------------------------------------------------
# Fast-path event reconstruction — replays the oracle's loop structure
# with every *decision* read from the fast path's recorded outputs
# (no O(window) pick scans, no O(ports) arbiter scans).
# ---------------------------------------------------------------------------

def replay_sched_events(addrs, timings, sched, rw, result,
                        trace: ChannelTrace) -> None:
    """Reconstruct the closed-loop event stream of
    :func:`repro_torch.core.timing.simulate_dram_sched_seq` from a fast-path
    :class:`~repro_torch.core.timing.SchedSimResult` (its ``service_order``
    is the decision record). Appends into ``trace.events``."""
    addrs = np.asarray(addrs, dtype=np.int64).ravel()
    n = addrs.size
    if n == 0:
        return
    rows = timings.row_of(addrs).tolist()
    banks = timings.bank_of(addrs).tolist()
    rw_l = None if rw is None else np.asarray(rw, np.int32).ravel().tolist()
    w = sched.effective_window
    t_refi, t_rfc = sched.t_refi, sched.t_rfc
    order = np.asarray(result.service_order, np.int64).tolist()
    ev = trace.events

    open_row: dict[int, int] = {}
    npend = 0
    nxt = 0
    cycle = 0
    next_ref = t_refi
    last_dir = -1
    for idx in order:
        while nxt < n and npend < w:
            ev.append(("window", cycle, nxt))
            nxt += 1
            npend += 1
        if t_refi:
            while cycle >= next_ref:
                ev.append(("refresh", cycle, cycle + t_rfc))
                cycle += t_rfc
                open_row.clear()
                next_ref += t_refi
        npend -= 1
        b, r = banks[idx], rows[idx]
        if b not in open_row:
            cls = "first"
            cost = timings.t_rcd + timings.t_cl
        elif open_row[b] == r:
            cls = "hit"
            cost = timings.t_cl
        else:
            cls = "conflict"
            cost = timings.t_rp + timings.t_rcd + timings.t_cl
        open_row[b] = r
        cost += timings.t_burst
        if rw_l is not None:
            d = rw_l[idx]
            if last_dir == 1 and d == 0:
                cost += timings.t_wtr
                ev.append(("turn", cycle, "wtr", timings.t_wtr))
            elif last_dir == 0 and d == 1:
                cost += timings.t_rtw
                ev.append(("turn", cycle, "rtw", timings.t_rtw))
            last_dir = d
        ev.append(("issue", cycle, idx, b, r, cls, cost, 1, "ok"))
        cycle += cost
        ev.append(("complete", cycle, idx))


def replay_arrival_events(addrs, timings, sched, rw, *, arrival_fpga,
                          pe_id, num_ports, result,
                          trace: ChannelTrace) -> None:
    """Reconstruct the open-loop event stream of
    :func:`repro_torch.core.timing.simulate_arrivals_seq` from a fast-path
    :class:`~repro_torch.core.timing.ServingSimResult`.

    The oracle's arbiter decision at every admission slot is exactly
    ``grant_order`` / ``granted_port``; its pick at every service slot
    is ``service_order``. Replaying the same loop skeleton (admission
    until the window is full or the next-granted request has not yet
    arrived; idle-gap advance with refresh absorption; refresh-precedes-
    issue; classify + charge) with those recorded decisions, using the
    identical ``anchor + off`` clock expressions, lands on bit-identical
    timestamps — property-tested event-for-event against the oracle."""
    from repro_torch.core.timing import _serving_trace

    addrs, n, rw_arr, arr, ports, nports = _serving_trace(
        addrs, timings, rw, arrival_fpga, pe_id, num_ports)
    if n == 0:
        return
    rows = timings.row_of(addrs).tolist()
    banks = timings.bank_of(addrs).tolist()
    rw_l = None if rw_arr is None else rw_arr.tolist()
    arr_l = arr.tolist()
    w = sched.effective_window
    t_refi, t_rfc = sched.t_refi, sched.t_rfc
    go = np.asarray(result.grant_order, np.int64).tolist()
    gp = np.asarray(result.granted_port, np.int64).tolist()
    so = np.asarray(result.service_order, np.int64).tolist()
    ev = trace.events

    queues = [list(np.flatnonzero(ports == p)) for p in range(nports)]
    heads = [0] * nports
    open_row: dict[int, int] = {}
    npend = 0
    gi = 0
    anchor: float | int = 0
    off = 0
    next_ref = t_refi
    last_dir = -1
    served = 0
    si = 0
    while served < n:
        while npend < w and gi < n:
            idx = go[gi]
            if arr_l[idx] <= anchor + off:
                g = gp[gi]
                heads[g] += 1
                ev.append(("grant", anchor + off, idx, g))
                gi += 1
                npend += 1
            else:
                break
        if npend == 0:                       # -- idle-gap advance
            target = min(arr[queues[p][heads[p]]] for p in range(nports)
                         if heads[p] < len(queues[p]))
            now0 = anchor + off
            if t_refi:
                while next_ref <= target:
                    end = next_ref + t_rfc
                    ev.append(("refresh", next_ref, end))
                    open_row.clear()
                    next_ref += t_refi
                    if end > target:
                        target = end
            ev.append(("idle", now0, target))
            anchor, off = target, 0
            continue
        if t_refi:
            while anchor + off >= next_ref:
                ev.append(("refresh", anchor + off, anchor + off + t_rfc))
                off += t_rfc
                open_row.clear()
                next_ref += t_refi
        idx = so[si]
        si += 1
        npend -= 1
        now_t = anchor + off
        b, r = banks[idx], rows[idx]
        if b not in open_row:
            cls = "first"
            cost = timings.t_rcd + timings.t_cl
        elif open_row[b] == r:
            cls = "hit"
            cost = timings.t_cl
        else:
            cls = "conflict"
            cost = timings.t_rp + timings.t_rcd + timings.t_cl
        open_row[b] = r
        cost += timings.t_burst
        if rw_l is not None:
            d = rw_l[idx]
            if last_dir == 1 and d == 0:
                cost += timings.t_wtr
                ev.append(("turn", now_t, "wtr", timings.t_wtr))
            elif last_dir == 0 and d == 1:
                cost += timings.t_rtw
                ev.append(("turn", now_t, "rtw", timings.t_rtw))
            last_dir = d
        ev.append(("issue", now_t, idx, b, r, cls, cost, 1, "ok"))
        off += cost
        ev.append(("complete", anchor + off, idx))
        served += 1


def replay_fault_events(addrs, timings, sched, rw, *, faults, channel,
                        arrival_fpga, pe_id, num_ports, result,
                        trace: ChannelTrace) -> None:
    """Reconstruct the fault-injected event stream of
    :func:`repro_torch.core.timing.simulate_faults_seq` from a fast-path
    :class:`~repro_torch.core.timing.FaultSimResult`.

    Replays :func:`replay_arrival_events`' skeleton with the RAS layer
    woven back in: ``service_order`` carries one entry per *issue*
    (replays repeat the index), and because every fault draw is a pure
    function of ``(seed, channel, index, attempt)`` the error outcome,
    ECC correction charge, replay-queue schedule, retirement map and
    refresh escalation replay deterministically — no extra state needs
    to be recorded by the fast path."""
    from repro_torch.core import faults as F
    from repro_torch.core.timing import _serving_trace

    fc = faults if faults is not None else FaultConfig()
    addrs, n, rw_arr, arr, ports, nports = _serving_trace(
        addrs, timings, rw, arrival_fpga, pe_id, num_ports)
    if n == 0:
        return
    rows_a = timings.row_of(addrs)
    rows = rows_a.tolist()
    banks = timings.bank_of(addrs).tolist()
    rw_l = None if rw_arr is None else rw_arr.tolist()
    arr_l = arr.tolist()
    w = sched.effective_window
    t_refi, t_rfc = sched.t_refi, sched.t_rfc
    weak_flags = F.weak_rows(fc, channel, rows_a)
    wins = fc.outage_windows_for(channel)
    secded = fc.ecc == "secded"
    go = np.asarray(result.grant_order, np.int64).tolist()
    gp = np.asarray(result.granted_port, np.int64).tolist()
    so = np.asarray(result.service_order, np.int64).tolist()
    ev = trace.events

    queues = [list(np.flatnonzero(ports == p)) for p in range(nports)]
    heads = [0] * nports
    open_row: dict[int, int] = {}
    npend = 0
    gi = 0
    anchor: float | int = 0
    off = 0
    next_ref = t_refi
    t_refi_eff = t_refi
    esc_level = 0
    n_injected = 0
    last_dir = -1
    served = 0
    si = 0
    attempts = [0] * n
    replay_q: list[tuple[float, int, int]] = []
    rseq = 0
    retired: dict[int, int] = {}
    err_count: dict[int, int] = {}
    while served < n:
        while npend < w:                     # -- admission
            if replay_q and replay_q[0][0] <= anchor + off:
                _, _, ridx = heapq.heappop(replay_q)
                ev.append(("readmit", anchor + off, ridx))
                npend += 1
                continue
            if gi < n and arr_l[go[gi]] <= anchor + off:
                idx = go[gi]
                g = gp[gi]
                heads[g] += 1
                ev.append(("grant", anchor + off, idx, g))
                gi += 1
                npend += 1
                continue
            break
        if npend == 0:                       # -- idle-gap advance
            targets = [arr[queues[p][heads[p]]] for p in range(nports)
                       if heads[p] < len(queues[p])]
            if replay_q:
                targets.append(replay_q[0][0])
            target = min(targets)
            now0 = anchor + off
            if t_refi:
                while next_ref <= target:
                    end = next_ref + t_rfc
                    ev.append(("refresh", next_ref, end))
                    open_row.clear()
                    next_ref += t_refi_eff
                    if end > target:
                        target = end
            ev.append(("idle", now0, target))
            anchor, off = target, 0
            continue
        now = anchor + off
        jumped = False
        for s, e in wins:                    # -- outage window stall
            if s <= now < e:
                target = float(e)
                if t_refi:
                    while next_ref <= target:
                        end = next_ref + t_rfc
                        ev.append(("refresh", next_ref, end))
                        open_row.clear()
                        next_ref += t_refi_eff
                        if end > target:
                            target = end
                ev.append(("outage", now, target))
                anchor, off = target, 0
                jumped = True
                break
        if jumped:
            continue
        if t_refi:
            while anchor + off >= next_ref:
                ev.append(("refresh", anchor + off, anchor + off + t_rfc))
                off += t_rfc
                open_row.clear()
                next_ref += t_refi_eff
        idx = so[si]
        si += 1
        npend -= 1
        now_t = anchor + off
        b, r_nat = banks[idx], rows[idx]
        r = retired.get(r_nat, r_nat)
        if b not in open_row:
            cls = "first"
            cost = timings.t_rcd + timings.t_cl
        elif open_row[b] == r:
            cls = "hit"
            cost = timings.t_cl
        else:
            cls = "conflict"
            cost = timings.t_rp + timings.t_rcd + timings.t_cl
        open_row[b] = r
        cost += timings.t_burst
        tpen = None
        if rw_l is not None:
            d = rw_l[idx]
            if last_dir == 1 and d == 0:
                cost += timings.t_wtr
                tpen = ("wtr", timings.t_wtr)
            elif last_dir == 0 and d == 1:
                cost += timings.t_rtw
                tpen = ("rtw", timings.t_rtw)
            last_dir = d
        attempts[idx] += 1
        att = attempts[idx]
        weak = bool(weak_flags[idx]) and r == r_nat
        p_err = F.error_prob(fc, weak)
        errored = False
        u = 0.0
        if p_err > 0.0:
            u = F.error_uniform(fc, channel, idx, att)
            errored = u < p_err
        failed = False
        outcome = "ok"
        if errored:
            n_injected += 1
            if fc.row_retire_threshold and r < F.SPARE_ROW_BASE:
                c = err_count.get(r, 0) + 1
                err_count[r] = c
                if (c >= fc.row_retire_threshold
                        and r_nat not in retired
                        and len(retired) < fc.max_retired_rows):
                    retired[r_nat] = F.SPARE_ROW_BASE + r_nat
            if fc.refresh_escalate_threshold and t_refi:
                while (esc_level < fc.refresh_escalate_max
                       and n_injected >= fc.refresh_escalate_threshold
                       * (esc_level + 1)):
                    esc_level += 1
                    shrunk = t_refi >> esc_level
                    t_refi_eff = shrunk if shrunk > t_rfc else t_rfc + 1
            is_read = rw_l is None or rw_l[idx] == 0
            if is_read:
                if secded:
                    if u < p_err * fc.due_fraction:
                        failed = True
                        outcome = "failed"
                    else:
                        outcome = "corrected"
                        cost += fc.ecc_correction_clocks
                else:
                    outcome = "silent"
            else:
                if fc.write_crc:
                    failed = True
                    outcome = "failed"
                else:
                    outcome = "silent"
        if tpen is not None:
            ev.append(("turn", now_t, tpen[0], tpen[1]))
        ev.append(("issue", now_t, idx, b, r, cls, cost, att, outcome))
        off += cost
        if failed:
            if att > fc.max_replays:
                ev.append(("drop", anchor + off, idx, att))
                served += 1
            else:
                rseq += 1
                ready = anchor + off + fc.backoff_for(att)
                heapq.heappush(replay_q, (ready, rseq, idx))
                ev.append(("replay", anchor + off, idx, att, ready))
        else:
            ev.append(("complete", anchor + off, idx))
            served += 1


# ---------------------------------------------------------------------------
# Cycle attribution
# ---------------------------------------------------------------------------

def _merge_intervals(ivs: list[tuple[float, float]]):
    """Sorted, merged (start, end, cumulative-length-before) arrays."""
    if not ivs:
        e = np.empty(0, np.float64)
        return e, e, e
    ivs = sorted(ivs)
    ms, me = [ivs[0][0]], [ivs[0][1]]
    for s, e in ivs[1:]:
        if s <= me[-1]:
            me[-1] = max(me[-1], e)
        else:
            ms.append(s)
            me.append(e)
    s_arr = np.asarray(ms, np.float64)
    e_arr = np.asarray(me, np.float64)
    cum = np.concatenate([[0.0], np.cumsum(e_arr - s_arr)])[:-1]
    return s_arr, e_arr, cum


def _coverage(s_arr, e_arr, cum, x):
    """Total merged-interval length before point(s) ``x``."""
    x = np.asarray(x, np.float64)
    j = np.searchsorted(s_arr, x, side="right") - 1
    jj = np.clip(j, 0, max(0, s_arr.size - 1))
    if s_arr.size == 0:
        return np.zeros_like(x)
    inside = np.clip(x - s_arr[jj], 0.0, e_arr[jj] - s_arr[jj])
    return np.where(j >= 0, cum[jj] + inside, 0.0)


def _overlap(s_arr, e_arr, cum, a, b):
    """Per-request overlap of merged intervals with ``[a, b)``."""
    return np.maximum(
        _coverage(s_arr, e_arr, cum, np.maximum(b, a))
        - _coverage(s_arr, e_arr, cum, a), 0.0)


@dataclasses.dataclass
class CycleAttribution:
    """Decomposition of each request's sojourn into the nine
    :data:`COMPONENTS`, in FPGA cycles.

    The identity — enforced by construction and property-tested — is
    that the *left-to-right* sum of the component arrays equals
    ``ServingStats.sojourn_fpga_cycles`` bit-for-bit: the service
    component (last in the chain, so only one float addition follows
    it) absorbs the float-conversion residue of the DRAM-clock →
    FPGA-cycle telescoping (a few ULPs; every other component is its
    documented interval length exactly).

    Component semantics (per request):

    * ``gating``      — the uniform pre-DRAM pipeline fill (controller
      overhead + arbiter grant tree) every request crosses;
    * ``arbitration`` — arrival → port grant, minus refresh/outage
      stalls in that span (waiting for the arbiter / window slot);
    * ``cache`` / ``batch`` — front-end stage residence; the serving
      datapath bypasses both engines, so they are zero in open-loop
      runs (closed-loop runs report them in the aggregate view);
    * ``reorder``     — grant → first DRAM issue, minus refresh/outage
      stalls in that span (slip inside the reorder window);
    * ``refresh`` / ``outage`` — stall overlap with the request's
      pre-issue wait ([arrival, first issue)); refreshes absorbed
      *inside* an outage window count as outage, so the two never
      double-book a clock;
    * ``replay``      — first issue start → final issue start (earlier
      attempts' bus time, backoff and re-admission waits; includes any
      refresh during those waits);
    * ``service``     — the final issue's own bus occupancy (class cost
      + burst + turnaround + ECC correction), plus the ULP-scale float
      residue that makes the left-to-right sum land exactly on sojourn.
    """

    components: dict[str, np.ndarray]
    sojourn: np.ndarray
    pe_id: np.ndarray
    channel_by_seq: np.ndarray
    row_by_seq: np.ndarray
    dropped: np.ndarray
    aggregate_totals: dict[str, float] | None = None

    @property
    def n(self) -> int:
        return int(self.sojourn.shape[0])

    def ltr_sum(self) -> np.ndarray:
        """The documented left-to-right component sum (== sojourn)."""
        out = None
        for name in COMPONENTS:
            c = self.components[name]
            out = c.copy() if out is None else out + c
        return out

    def totals(self) -> dict[str, float]:
        if self.aggregate_totals is not None:
            return dict(self.aggregate_totals)
        return {k: float(v.sum()) for k, v in self.components.items()}

    def per_tenant(self) -> dict[int, dict[str, float]]:
        out: dict[int, dict[str, float]] = {}
        for p in np.unique(self.pe_id):
            m = self.pe_id == p
            rec = {k: float(v[m].sum()) for k, v in self.components.items()}
            rec["n"] = int(m.sum())
            rec["mean_sojourn"] = float(self.sojourn[m].mean())
            out[int(p)] = rec
        return out

    def top_rows(self, k: int = 10) -> list[dict]:
        """Top-``k`` (channel, row) keys by summed sojourn."""
        key = self.channel_by_seq.astype(np.int64) * (1 << 44) \
            + self.row_by_seq
        uniq, inv = np.unique(key, return_inverse=True)
        tot = np.bincount(inv, weights=self.sojourn)
        cnt = np.bincount(inv)
        top = np.argsort(tot)[::-1][:k]
        return [{"channel": int(uniq[i] >> 44),
                 "row": int(uniq[i] & ((1 << 44) - 1)),
                 "n_requests": int(cnt[i]),
                 "sojourn_fpga_cycles": float(tot[i])}
                for i in top]

    def as_dict(self, top_k: int = 10) -> dict:
        return {
            "n_requests": self.n,
            "components_total": self.totals(),
            "per_tenant": {str(p): rec
                           for p, rec in self.per_tenant().items()},
            "top_rows": self.top_rows(top_k),
            "n_dropped": int(self.dropped.sum()),
        }

    def summary_text(self, top_k: int = 5) -> str:
        tot = self.totals()
        grand = sum(tot.values()) or 1.0
        head = (f"aggregate cycle attribution "
                f"(makespan {grand:.0f} FPGA cycles)"
                if self.aggregate_totals is not None else
                f"cycle attribution over {self.n} requests "
                f"(total sojourn {grand:.0f} FPGA cycles)")
        lines = [head]
        for name in COMPONENTS:
            v = tot.get(name, 0.0)
            lines.append(f"  {name:<12} {v:>16.1f}  ({100 * v / grand:5.1f}%)")
        if self.aggregate_totals is None:
            for p, rec in sorted(self.per_tenant().items()):
                top = max(((k, rec[k]) for k in COMPONENTS),
                          key=lambda kv: kv[1])
                lines.append(
                    f"  tenant {p}: n={rec['n']} mean_sojourn="
                    f"{rec['mean_sojourn']:.1f} dominant={top[0]}")
            for r in self.top_rows(top_k):
                lines.append(
                    f"  hot row ch{r['channel']}/r{r['row']}: "
                    f"{r['n_requests']} reqs, "
                    f"{r['sojourn_fpga_cycles']:.0f} cycles")
        return "\n".join(lines)

    # -- builders ----------------------------------------------------------

    @classmethod
    def from_recorder(cls, recorder: TraceRecorder,
                      serving) -> "CycleAttribution":
        """Per-request attribution for an open-loop run, from the
        recorder's channel events + the run's ``ServingStats``."""
        n = serving.arrival_fpga_cycles.shape[0]
        ratio = recorder.timings.clock_ratio
        sojourn = serving.sojourn_fpga_cycles
        grant_t = np.zeros(n, np.float64)
        s1 = np.zeros(n, np.float64)        # first issue start
        sl = np.zeros(n, np.float64)        # last issue start
        last_cost = np.zeros(n, np.float64)
        end_t = np.zeros(n, np.float64)
        seen_issue = np.zeros(n, bool)
        dropped = np.zeros(n, bool)
        ch_of = np.zeros(n, np.int64)
        row_of = np.zeros(n, np.int64)
        arr_dram = np.zeros(n, np.float64)
        comp = {name: np.zeros(n, np.float64) for name in COMPONENTS}
        for k, ct in sorted(recorder.channels.items()):
            ref_iv: list[tuple[float, float]] = []
            out_iv: list[tuple[float, float]] = []
            members: list[int] = []
            for e in ct.events:
                kind = e[0]
                if kind == "refresh":
                    ref_iv.append((e[1], e[2]))
                elif kind == "outage":
                    out_iv.append((e[1], e[2]))
                elif kind == "grant":
                    s = ct.resolve(e[2])
                    grant_t[s] = e[1]
                    members.append(s)
                elif kind == "issue":
                    s = ct.resolve(e[2])
                    if not seen_issue[s]:
                        s1[s] = e[1]
                        seen_issue[s] = True
                    sl[s] = e[1]
                    last_cost[s] = e[6]
                    ch_of[s] = k
                    row_of[s] = e[4]
                elif kind in ("complete", "drop"):
                    s = ct.resolve(e[2])
                    end_t[s] = e[1]
                    if kind == "drop":
                        dropped[s] = True
            if not members:
                continue
            m = np.asarray(members, np.int64)
            arr_dram[m] = serving.arrival_fpga_cycles[m] / ratio
            # refresh and outage windows can nest (refreshes absorbed
            # inside an outage are emitted too) — subtract their UNION
            # from the wait spans, and attribute the overlap to outage
            # (refresh = union minus outage, always >= 0).
            us, ue, uc = _merge_intervals(ref_iv + out_iv)
            os_, oe, oc = _merge_intervals(out_iv)
            a, g, f1 = arr_dram[m], grant_t[m], s1[m]
            u1 = _overlap(us, ue, uc, a, g)
            u2 = _overlap(us, ue, uc, g, f1)
            o1 = _overlap(os_, oe, oc, a, g)
            o2 = _overlap(os_, oe, oc, g, f1)
            comp["arbitration"][m] = (g - a - u1) * ratio
            comp["reorder"][m] = (f1 - g - u2) * ratio
            comp["refresh"][m] = (u1 + u2 - o1 - o2) * ratio
            comp["outage"][m] = (o1 + o2) * ratio
            comp["replay"][m] = (sl[m] - f1) * ratio
            comp["service"][m] = (end_t[m] - sl[m]) * ratio
        comp["gating"][:] = recorder.pre_fpga
        # Exact-sum identity: service (last in the left-to-right chain,
        # so a single float addition follows it) absorbs the ULP-scale
        # residue of the per-component DRAM->FPGA conversion. Direct
        # solve lands exactly in practice; the nextafter loop covers the
        # one-rounding-step stragglers (the map x -> fl(prefix + x) is
        # onto, so an exact preimage always exists).
        prefix = None
        for name in COMPONENTS[:-1]:
            c = comp[name]
            prefix = c.copy() if prefix is None else prefix + c
        svc = sojourn - prefix
        for _ in range(64):
            cur = prefix + svc
            bad = cur != sojourn
            if not bad.any():
                break
            svc[bad] = np.nextafter(
                svc[bad], np.where(cur[bad] < sojourn[bad],
                                   np.inf, -np.inf))
        comp["service"] = svc
        return cls(components=comp, sojourn=sojourn,
                   pe_id=serving.pe_id, channel_by_seq=ch_of,
                   row_by_seq=row_of, dropped=dropped)

    @classmethod
    def from_pipeline(cls, result,
                      recorder: TraceRecorder | None = None
                      ) -> "CycleAttribution":
        """Attribution for any pipeline run: per-request when the run
        was open-loop and traced; otherwise the aggregate stage-cycle
        view (``breakdown()`` re-keyed onto the component names)."""
        if (result.serving is not None and recorder is not None
                and recorder.channels):
            return cls.from_recorder(recorder, result.serving)
        bd = result.breakdown()
        refresh = 0.0
        ratio = 1.0 if recorder is None or recorder.timings is None \
            else recorder.timings.clock_ratio
        for r in result.per_channel:
            refresh += getattr(r, "refresh_dram_cycles", 0) * ratio
        totals = {
            "gating": bd.get("ctrl_overhead", 0.0)
            + bd.get("address_map", 0.0),
            "arbitration": bd.get("port_arbiter", 0.0),
            "cache": bd.get("cache_filter", 0.0),
            "batch": bd.get("batch_scheduler", 0.0)
            + bd.get("dma_overlap", 0.0),
            "reorder": 0.0,
            "refresh": refresh,
            "outage": 0.0,
            "replay": 0.0,
            "service": bd.get("dram_service", 0.0) - refresh,
        }
        z = np.zeros(0, np.float64)
        zi = np.zeros(0, np.int64)
        return cls(components={k: z for k in COMPONENTS}, sojourn=z,
                   pe_id=zi, channel_by_seq=zi, row_by_seq=zi,
                   dropped=np.zeros(0, bool), aggregate_totals=totals)
