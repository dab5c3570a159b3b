"""Trace engine — the numpy fast paths of the DRAM command simulator.

Counterpart of the numpy half of the reference's
``repro.core.trace_engine``, copied expression for expression: the
chunked out-of-order command scheduler (:func:`simulate_dram_sched_fast`),
the open-loop serving loop (:func:`simulate_arrivals_fast`) and the
fault-injected one (:func:`simulate_faults_fast`), each bit-identical to
its ``*_seq`` oracle in ``repro_torch.core.timing``. They run on the host,
like the reference's.

The reference module's other half, the set-parallel cache engine
(``partition_by_set``, ``_tag_round``, ``simulate_trace(_rw)_parallel``,
``auto_parallel_ok``), runs on the accelerator and is ROADMAP A5.2; until
then ``cache_engine``'s ``engine="auto"`` runs the sequential walk, which
the reference holds bit-identical to it. Lifecycle tracing (``trace=``)
is ROADMAP A5.3: a ``trace`` that is not ``None`` raises
``NotImplementedError``.
"""

from __future__ import annotations

import numpy as np


# ---------------------------------------------------------------------------
# Out-of-order DRAM command scheduling — the chunked fast path
# ---------------------------------------------------------------------------

def simulate_dram_sched_fast(addrs, timings, sched, rw=None, *, trace=None):
    """Fast path of :func:`repro_torch.core.timing.simulate_dram_sched` —
    bit-identical to ``simulate_dram_sched_seq`` (property-tested over
    policy x window x cap x refresh x rw x timings).

    The oracle's window walk has one exploitable invariant, the same one
    the windowed baseline simulator uses: **open-row state changes only
    when a miss is serviced**. Between miss services, FR-FCFS issues the
    pending row-hits oldest-first — which is exactly the frontier scan
    order — so the walk decomposes into scan runs (hits issue in arrival
    order against frozen bank state, misses defer) punctuated by miss
    services and their drains (deferred requests the newly opened row
    converts into hits).

    Dispatch:

    * ``fifo``/``frfcfs`` run :func:`_sched_fast_nocap` — a segmented
      scan over per-(bank,row) drain buckets: every drain is an O(1)
      bucket pop instead of an O(window) pending scan, the miss-heavy
      regime runs a branch-light tight loop with no per-event python
      round trips, and hit-heavy phases escalate to chunked array scans
      that issue whole row-hit runs in single vector ops.
    * ``frfcfs_cap`` keeps the starvation-budget event walk
      (:func:`_sched_fast_cap`): forced picks interleave state changes
      mid-drain, which couples the drain order to the bypass counters.

    ``trace`` (the lifecycle event stream) is ROADMAP A5.3: one that is
    not ``None`` raises ``NotImplementedError``.
    """
    from repro_torch.core.timing import _sched_result, refuse_trace

    refuse_trace(trace)
    addrs = np.asarray(addrs, dtype=np.int64).ravel()
    n = addrs.size
    if n == 0:
        return _sched_result(0, 0, 0, 0, 0, 0, sched.t_rfc, timings, [])
    rows = timings.row_of(addrs)
    banks = timings.bank_of(addrs)
    rw_arr = None if rw is None else np.asarray(rw, np.int32).ravel()
    if sched.policy != "frfcfs_cap":
        key_span = int(rows.max()) + 2 if n else 2
        if key_span < (1 << 61) // max(int(timings.num_banks), 1):
            res = _sched_fast_nocap(n, rows, banks, timings, sched, rw_arr)
            return res
    return _sched_fast_cap(addrs, n, rows, banks, timings, sched, rw_arr)


def _sched_fast_nocap(n, rows, banks, timings, sched, rw_arr):
    """Bucketed segmented scan for ``fifo``/``frfcfs`` (no starvation
    cap) — bit-identical to the oracle's window walk.

    Without a cap the pick rule is static: oldest row-ready hit, else
    oldest miss. Three structural facts make the walk cheap:

    * deferred requests drain **only** when a miss opens exactly their
      (bank, row) — so the pending window is kept as per-(bank, row)
      *buckets* and a drain is one dict pop over exactly the converted
      requests (the oracle's O(window) rescan per event disappears);
    * the oldest pending miss is popped through an append-only arrival
      list with a lazy-deletion head (drained entries are flagged and
      skipped), so window-full events are O(1);
    * bank state changes only at miss services, so while the frontier
      streams row hits the state is frozen and whole runs classify in
      one vector compare against packed (bank, row) keys — the tight
      loop escalates to chunked array scans after a long hit streak and
      falls back when the stream turns miss-heavy.

    Refresh is absorbed exactly as the oracle does: checked before every
    pick (scan hit, miss service, and each drained hit), closing every
    bank and re-anchoring the next boundary; a refresh that lands mid
    drain re-queues the unserved bucket tail.
    """
    from repro_torch.core.timing import _sched_result

    w = sched.effective_window
    t_refi, t_rfc = sched.t_refi, sched.t_rfc
    t_wtr, t_rtw = timings.t_wtr, timings.t_rtw
    cost_hit = timings.t_cl + timings.t_burst
    cost_first = timings.t_rcd + timings.t_cl + timings.t_burst
    cost_conf = (timings.t_rp + timings.t_rcd + timings.t_cl
                 + timings.t_burst)
    nb = timings.num_banks

    key_span = int(rows.max()) + 2
    keys = banks * key_span + rows          # packed (bank, row) identity
    keys_l = keys.tolist()
    rw_l = None if rw_arr is None else rw_arr.tolist()
    cur = [-1] * nb                 # open packed key per bank, -1 closed
    buckets: dict[int, list[int]] = {}      # packed key -> deferred idxs
    order: list[int] = []           # deferred arrival order (append-only)
    head = 0                        # lazy-deletion read head into order
    drained = bytearray(n)          # 1 = served by a drain, skip on pop
    ndef = 0                        # live deferred count
    out_l: list[int] = []
    f = 0
    cycle = 0
    next_ref = t_refi if t_refi else float("inf")
    n_hit = n_conflict = n_first = n_ref = turn = 0
    last_dir = -1
    streak = 0                      # consecutive tight-loop scan hits
    STREAK = 192                    # escalate to array scans past this
    grow = max(64, 4 * w)

    while True:
        if f >= n and ndef == 0:
            break
        # refresh precedes the next pick (one always follows: not done)
        while cycle >= next_ref:
            cycle += t_rfc
            n_ref += 1
            cur = [-1] * nb
            next_ref += t_refi
        # ---- scan phase: serve frontier hits, defer misses ----------
        while f < n and ndef < w:
            if cycle >= next_ref:
                cycle += t_rfc
                n_ref += 1
                cur = [-1] * nb
                next_ref += t_refi
                streak = 0
                continue
            if streak >= STREAK:
                # -- array burst: bank state is frozen while the
                # frontier streams hits, so whole runs classify in one
                # vector compare; the run is truncated by the room-th
                # miss or the next refresh boundary, exactly like the
                # tight loop it replaces
                kb = np.asarray(cur, np.int64)
                while f < n and ndef < w:
                    room = w - ndef
                    chunk = min(max(32, 4 * room, grow), n - f)
                    sl = slice(f, f + chunk)
                    hm = kb[banks[sl]] == keys[sl]
                    miss_rel = np.flatnonzero(~hm)
                    if miss_rel.size >= room:
                        take = int(miss_rel[room - 1]) + 1
                        miss_rel = miss_rel[:room]
                    else:
                        take = chunk
                    hit_rel = np.flatnonzero(hm[:take])
                    tcosts = None
                    if rw_arr is not None and hit_rel.size:
                        dirs = rw_arr[f + hit_rel]
                        prev = np.concatenate(([last_dir], dirs[:-1]))
                        tcosts = np.where(
                            (prev == 1) & (dirs == 0), t_wtr,
                            np.where((prev == 0) & (dirs == 1),
                                     t_rtw, 0)).astype(np.int64)
                    if t_refi and hit_rel.size:
                        costs = (np.full(hit_rel.size, cost_hit, np.int64)
                                 if tcosts is None else cost_hit + tcosts)
                        pre = cycle + np.concatenate(
                            ([0], np.cumsum(costs[:-1])))
                        cross = np.flatnonzero(pre >= next_ref)
                        if cross.size:           # cross[0] >= 1: see top
                            kcut = int(cross[0])
                            take = int(hit_rel[kcut])
                            hit_rel = hit_rel[:kcut]
                            miss_rel = miss_rel[miss_rel < take]
                            if tcosts is not None:
                                tcosts = tcosts[:kcut]
                    k = hit_rel.size
                    if k:
                        n_hit += k
                        if tcosts is None:
                            cycle += k * cost_hit
                        else:
                            tsum = int(tcosts.sum())
                            turn += tsum
                            cycle += k * cost_hit + tsum
                            last_dir = int(rw_arr[f + hit_rel[-1]])
                        out_l.extend((f + hit_rel).tolist())
                    if miss_rel.size:
                        for m in (f + miss_rel).tolist():
                            kk = keys_l[m]
                            lst = buckets.get(kk)
                            if lst is None:
                                buckets[kk] = [m]
                            else:
                                lst.append(m)
                            order.append(m)
                        ndef += miss_rel.size
                    f += take
                    if take < chunk or cycle >= next_ref:
                        break
                    grow = min(chunk * 2, 1 << 20)
                streak = 0
                grow = max(64, 4 * w)
                continue
            k = keys_l[f]
            if cur[k // key_span] == k:
                c = cost_hit
                if rw_l is not None:
                    d = rw_l[f]
                    if d != last_dir:
                        if last_dir == 1:
                            c += t_wtr
                            turn += t_wtr
                        elif last_dir == 0:
                            c += t_rtw
                            turn += t_rtw
                        last_dir = d
                n_hit += 1
                cycle += c
                out_l.append(f)
                streak += 1
            else:
                lst = buckets.get(k)
                if lst is None:
                    buckets[k] = [f]
                else:
                    lst.append(f)
                order.append(f)
                ndef += 1
                streak = 0
            f += 1
        if ndef == 0:
            continue
        if cycle >= next_ref:
            continue
        # ---- event: pop the oldest deferred miss --------------------
        while drained[order[head]]:
            head += 1
        d = order[head]
        head += 1
        ndef -= 1
        k = keys_l[d]
        if cur[k // key_span] == -1:
            n_first += 1
            c = cost_first
        else:
            n_conflict += 1
            c = cost_conf
        cur[k // key_span] = k
        if rw_l is not None:
            dd = rw_l[d]
            if dd != last_dir:
                if last_dir == 1:
                    c += t_wtr
                    turn += t_wtr
                elif last_dir == 0:
                    c += t_rtw
                    turn += t_rtw
                last_dir = dd
        cycle += c
        out_l.append(d)
        streak = 0
        # ---- drain: the bucket holds exactly the converted hits -----
        lst = buckets.pop(k)        # lst[0] is d (oldest overall)
        for i in range(1, len(lst)):
            if cycle >= next_ref:
                buckets[k] = lst[i:]        # refresh mid-drain: re-queue
                break
            x = lst[i]
            c = cost_hit
            if rw_l is not None:
                dd = rw_l[x]
                if dd != last_dir:
                    if last_dir == 1:
                        c += t_wtr
                        turn += t_wtr
                    elif last_dir == 0:
                        c += t_rtw
                        turn += t_rtw
                    last_dir = dd
            n_hit += 1
            cycle += c
            out_l.append(x)
            drained[x] = 1
            ndef -= 1
    return _sched_result(n_first, n_hit, n_conflict, n, turn, n_ref,
                         t_rfc, timings, np.asarray(out_l, np.int64))


def _sched_fast_cap(addrs, n, rows, banks, timings, sched, rw_arr):
    """Starvation-budget event walk (``frfcfs_cap``, and the fallback
    for degenerate packed-key ranges): a vectorized frontier scan with
    one python event per serviced miss or forced pick. Forced picks
    interleave state changes mid-drain, which couples the drain order
    to the bypass counters — the reason this path keeps the explicit
    pending list the bucketed no-cap walk retires."""
    from repro_torch.core.timing import _sched_result

    w = sched.effective_window
    use_cap = sched.policy == "frfcfs_cap"
    cap = sched.starvation_cap
    t_refi, t_rfc = sched.t_refi, sched.t_rfc
    t_wtr, t_rtw = timings.t_wtr, timings.t_rtw
    cost_hit = timings.t_cl + timings.t_burst
    cost_first = timings.t_rcd + timings.t_cl + timings.t_burst
    cost_conf = (timings.t_rp + timings.t_rcd + timings.t_cl
                 + timings.t_burst)

    open_arr = np.zeros(timings.num_banks, np.int64)
    opened = np.zeros(timings.num_banks, bool)
    # python mirrors of the per-request decode and bank state: the
    # miss-heavy regime steps request-at-a-time below, and list reads
    # are ~10x cheaper than numpy scalar indexing there
    banks_l = banks.tolist()
    rows_l = rows.tolist()
    rw_l = None if rw_arr is None else rw_arr.tolist()
    open_l = [0] * timings.num_banks
    opened_l = [False] * timings.num_banks
    deferred: list[int] = []    # scanned misses, arrival order
    byp: list[int] = []         # younger issues past each, parallel list
    out = np.empty(n, np.int64)
    out_n = 0
    f = 0
    cycle = 0
    next_ref = t_refi
    n_hit = n_conflict = n_first = n_ref = turn = 0
    last_dir = -1
    grow = max(64, 4 * w)     # scan chunk; doubles through long hit runs
    MICRO = 96                # python-step budget in the miss-heavy mode

    def serve_scalar(idx: int) -> None:
        nonlocal n_hit, n_conflict, n_first, cycle, turn, last_dir, out_n
        b, r = banks_l[idx], rows_l[idx]
        if not opened_l[b]:
            n_first += 1
            c = cost_first
        elif open_l[b] == r:
            n_hit += 1
            c = cost_hit
        else:
            n_conflict += 1
            c = cost_conf
        opened_l[b] = True
        open_l[b] = r
        opened[b] = True
        open_arr[b] = r
        if rw_l is not None:
            d = rw_l[idx]
            if last_dir == 1 and d == 0:
                turn += t_wtr
                c += t_wtr
            elif last_dir == 0 and d == 1:
                turn += t_rtw
                c += t_rtw
            last_dir = d
        cycle += c
        out[out_n] = idx
        out_n += 1

    while f < n or deferred:
        if t_refi:
            while cycle >= next_ref:      # refresh precedes the issue
                cycle += t_rfc
                n_ref += 1
                opened[:] = False
                opened_l = [False] * timings.num_banks
                next_ref += t_refi
        if deferred and (len(deferred) >= w or f >= n
                         or (use_cap and byp[0] >= cap)):
            # -- event: issue the oldest pending miss, then drain the
            # deferred requests its open row converts into hits
            # (oldest-hit-first, interrupted by starvation forcing or a
            # refresh boundary exactly as the oracle's pick rule is)
            serve_scalar(deferred.pop(0))
            if use_cap:
                byp.pop(0)
                # scalar drain: starvation forcing can interleave state
                # changes (forced conflicts open new rows mid-drain)
                while deferred:
                    if t_refi and cycle >= next_ref:
                        break              # refresh re-evaluates state
                    if byp[0] >= cap:
                        i = 0              # oldest starved (byp sorted)
                    else:
                        d_arr = np.asarray(deferred, np.int64)
                        db = banks[d_arr]
                        cand = np.flatnonzero(
                            opened[db] & (open_arr[db] == rows[d_arr]))
                        if cand.size == 0:
                            break
                        i = int(cand[0])
                    serve_scalar(deferred.pop(i))
                    byp.pop(i)
                    for kk in range(i):    # older entries were bypassed
                        byp[kk] += 1
            elif deferred and len(deferred) <= 48:
                # hits never change state, so one pass over the (small)
                # window drains every conversion in age order
                cand_pos = [kk for kk, dd in enumerate(deferred)
                            if opened_l[banks_l[dd]]
                            and open_l[banks_l[dd]] == rows_l[dd]]
                if cand_pos:
                    served: list[int] = []
                    for kk in cand_pos:
                        if t_refi and cycle >= next_ref:
                            break
                        serve_scalar(deferred[kk])
                        served.append(kk)
                    if served:
                        drop = set(served)
                        deferred = [dd for kk, dd in enumerate(deferred)
                                    if kk not in drop]
            elif deferred:
                # same drain, vectorized for deep windows, cut only by
                # the refresh boundary
                d_arr = np.asarray(deferred, np.int64)
                db = banks[d_arr]
                cand = np.flatnonzero(
                    opened[db] & (open_arr[db] == rows[d_arr]))
                if cand.size:
                    idxs = d_arr[cand]
                    tcosts = None
                    if rw_arr is not None:
                        dirs = rw_arr[idxs]
                        prev = np.concatenate(([last_dir], dirs[:-1]))
                        tcosts = np.where(
                            (prev == 1) & (dirs == 0), t_wtr,
                            np.where((prev == 0) & (dirs == 1),
                                     t_rtw, 0)).astype(np.int64)
                    j = cand.size
                    if t_refi:
                        costs = (np.full(j, cost_hit, np.int64)
                                 if tcosts is None else cost_hit + tcosts)
                        pre = cycle + np.concatenate(
                            ([0], np.cumsum(costs[:-1])))
                        cross = np.flatnonzero(pre >= next_ref)
                        if cross.size:
                            j = int(cross[0])
                    if j:
                        n_hit += j
                        if tcosts is None:
                            cycle += j * cost_hit
                        else:
                            tsum = int(tcosts[:j].sum())
                            turn += tsum
                            cycle += j * cost_hit + tsum
                            last_dir = int(rw_arr[idxs[j - 1]])
                        out[out_n:out_n + j] = idxs[:j]
                        out_n += j
                        keep = np.ones(d_arr.size, bool)
                        keep[cand[:j]] = False
                        deferred = [d for d, m in zip(deferred, keep)
                                    if m]
            continue
        if f >= n:
            break
        if grow <= 32:
            # -- miss-heavy regime: python-step the frontier (the numpy
            # chunk overhead dwarfs its win on short hit runs). Exact
            # same semantics as the chunked scan below: serve hits in
            # arrival order, defer misses, stop on window-full /
            # starvation budget / refresh boundary / step budget.
            steps = 0
            while f < n and len(deferred) < w and steps < MICRO:
                if t_refi and cycle >= next_ref:
                    break
                if use_cap and byp and byp[0] >= cap:
                    break
                b, r = banks_l[f], rows_l[f]
                if opened_l[b] and open_l[b] == r:
                    c = cost_hit
                    if rw_l is not None:
                        d = rw_l[f]
                        if last_dir == 1 and d == 0:
                            turn += t_wtr
                            c += t_wtr
                        elif last_dir == 0 and d == 1:
                            turn += t_rtw
                            c += t_rtw
                        last_dir = d
                    n_hit += 1
                    cycle += c
                    out[out_n] = f
                    out_n += 1
                    if use_cap and byp:
                        byp = [x + 1 for x in byp]
                else:
                    deferred.append(f)
                    if use_cap:
                        byp.append(0)
                f += 1
                steps += 1
            if steps >= MICRO and len(deferred) < w:
                grow = 64          # long run — try the chunked scan
            continue
        # -- scan run: issue frontier hits, defer misses --------------
        room = w - len(deferred)
        chunk = min(max(32, 4 * room, grow), n - f)
        sl = slice(f, f + chunk)
        hm = opened[banks[sl]] & (open_arr[banks[sl]] == rows[sl])
        miss_rel = np.flatnonzero(~hm)
        if miss_rel.size >= room:
            take = int(miss_rel[room - 1]) + 1   # through the room-th miss
            miss_rel = miss_rel[:room]
        else:
            take = chunk
        hit_rel = np.flatnonzero(hm[:take])
        if use_cap and hit_rel.size:
            if deferred:
                # every hit here is younger than the oldest pending miss
                budget = cap - byp[0]            # >= 1: event checked above
                if hit_rel.size > budget:
                    take = int(hit_rel[budget])
                    hit_rel = hit_rel[:budget]
                    miss_rel = miss_rel[miss_rel < take]
            elif miss_rel.size:
                # only hits *after* the first new miss bypass it
                after = hit_rel[hit_rel > miss_rel[0]]
                if after.size > cap:
                    take = int(after[cap])
                    hit_rel = hit_rel[hit_rel < take]
                    miss_rel = miss_rel[miss_rel < take]
        tcosts = None
        if rw_arr is not None and hit_rel.size:
            dirs = rw_arr[f + hit_rel]
            prev = np.concatenate(([last_dir], dirs[:-1]))
            tcosts = np.where((prev == 1) & (dirs == 0), t_wtr,
                              np.where((prev == 0) & (dirs == 1),
                                       t_rtw, 0)).astype(np.int64)
        if t_refi and hit_rel.size:
            costs = (np.full(hit_rel.size, cost_hit, np.int64)
                     if tcosts is None else cost_hit + tcosts)
            pre = cycle + np.concatenate(([0], np.cumsum(costs[:-1])))
            cross = np.flatnonzero(pre >= next_ref)
            if cross.size:                       # cross[0] >= 1: see top
                kcut = int(cross[0])
                take = int(hit_rel[kcut])
                hit_rel = hit_rel[:kcut]
                miss_rel = miss_rel[miss_rel < take]
                if tcosts is not None:
                    tcosts = tcosts[:kcut]
        k = hit_rel.size
        if k:
            n_hit += k
            if tcosts is None:
                cycle += k * cost_hit
            else:
                tsum = int(tcosts.sum())
                turn += tsum
                cycle += k * cost_hit + tsum
                last_dir = int(rw_arr[f + hit_rel[-1]])
            out[out_n:out_n + k] = f + hit_rel
            out_n += k
        if use_cap:
            if k and byp:
                byp = [b + k for b in byp]
            if miss_rel.size:
                new_byp = k - np.searchsorted(hit_rel, miss_rel)
                byp.extend(int(b) for b in new_byp)
        if miss_rel.size:
            deferred.extend(int(m) for m in (f + miss_rel))
        f += take
        grow = chunk * 2 if take == chunk else 32
    res = _sched_result(n_first, n_hit, n_conflict, n, turn, n_ref,
                        t_rfc, timings, out)
    return res


def simulate_arrivals_fast(addrs, timings, sched, rw=None, *,
                           arrival_fpga=None, pe_id=None, num_ports=None,
                           arb_policy="round_robin", weights=None,
                           trace=None):
    """Fast path of :func:`repro_torch.core.timing.simulate_arrivals` —
    bit-identical to ``simulate_arrivals_seq`` (property-tested over
    arrival process x ports x arbiter policy x DRAM policy x window x
    cap x refresh x rw).

    Single-port streams admit in trace order, so the closed-loop
    chunked frontier scan of :func:`simulate_dram_sched_fast`
    generalizes: classify a frontier chunk against current bank state,
    issue every *arrived* hit in one array op and defer the arrived
    misses, with the run truncated by whichever binds first — the
    arrival gate (a request is admitted only once the clock reaches its
    stamp), the window filling with misses, the starvation budget, or
    the next refresh boundary — plus an idle-gap advance when the
    frontier itself is in the future. Multi-port streams couple
    admission to the arbiter's rotation state, where deferring a grant
    changes *which* port wins the slot, so they run an optimized
    event-at-a-time loop instead (python lists + anchored clock, same
    spec).

    Both paths track the clock as ``anchor + offset`` (float anchor set
    only at idle jumps, exact integer offset) exactly like the oracle,
    so batched integer cost sums land on bit-identical timestamps.

    ``trace`` (the lifecycle event stream) is ROADMAP A5.3: one that is
    not ``None`` raises ``NotImplementedError``.
    """
    from repro_torch.core.timing import (ServingSimResult, _serving_trace,
                                         _serving_weights, refuse_trace)

    refuse_trace(trace)
    addrs, n, rw_arr, arr, ports, nports = _serving_trace(
        addrs, timings, rw, arrival_fpga, pe_id, num_ports)
    _serving_weights(nports, arb_policy, weights)   # validate up front
    if n == 0:
        return ServingSimResult(total_fpga_cycles=0.0, row_hits=0,
                                row_conflicts=0, first_accesses=0)
    if nports == 1:
        if sched.policy != "frfcfs_cap":
            rows_v = timings.row_of(addrs)
            key_span = int(rows_v.max()) + 2 if n else 2
        if (sched.policy != "frfcfs_cap"
                and key_span < (1 << 61) // max(int(timings.num_banks), 1)):
            res = _arrivals_fast_single_nocap(addrs, n, timings, sched,
                                              rw_arr, arr, ServingSimResult)
        else:
            res = _arrivals_fast_single(addrs, n, timings, sched, rw_arr,
                                        arr, ServingSimResult)
    else:
        res = _arrivals_fast_multi(addrs, n, timings, sched, rw_arr, arr,
                                   ports, nports, arb_policy, weights,
                                   ServingSimResult)
    return res


def _arrivals_fast_single_nocap(addrs, n, timings, sched, rw_arr, arr,
                                result_cls):
    """Arrival-gated bucketed segmented scan (single admission queue,
    ``fifo``/``frfcfs``) — the open-loop sibling of
    :func:`_sched_fast_nocap`: per-(bank, row) drain buckets and a
    lazy-deletion pending list replace the O(window) pending rescan per
    event, with the scan additionally truncated by the arrival gate (a
    request is admitted only once the clock reaches its stamp) and an
    idle-gap advance (refreshes completing inside the gap overlap with
    idleness; one in progress at the target delays the next issue to
    its end — the oracle's absorb rule). The clock is ``anchor + off``
    (float anchor set only at idle jumps, exact integer offset), so
    batched cost sums land on bit-identical timestamps."""
    rows = timings.row_of(addrs)
    banks = timings.bank_of(addrs)
    w = sched.effective_window
    t_refi, t_rfc = sched.t_refi, sched.t_rfc
    t_wtr, t_rtw = timings.t_wtr, timings.t_rtw
    cost_hit = timings.t_cl + timings.t_burst
    cost_first = timings.t_rcd + timings.t_cl + timings.t_burst
    cost_conf = (timings.t_rp + timings.t_rcd + timings.t_cl
                 + timings.t_burst)
    nb = timings.num_banks

    key_span = int(rows.max()) + 2
    keys = banks * key_span + rows
    keys_l = keys.tolist()
    rw_l = None if rw_arr is None else rw_arr.tolist()
    arr_l = arr.tolist()
    cur = [-1] * nb
    buckets: dict[int, list[int]] = {}
    order: list[int] = []
    head = 0
    drained = bytearray(n)
    ndef = 0
    out = np.empty(n, np.int64)
    out_n = 0
    completion = np.zeros(n, np.float64)
    service = np.zeros(n, np.int64)
    f = 0
    anchor = 0                  # float once the channel has idled
    off = 0                     # exact integer clocks since anchor
    next_ref = t_refi if t_refi else float("inf")
    n_hit = n_conflict = n_first = n_ref = turn = 0
    last_dir = -1
    streak = 0
    STREAK = 192
    grow = max(64, 4 * w)
    idle = 0.0

    while True:
        if f >= n and ndef == 0:
            break
        if ndef == 0 and arr_l[f] > anchor + off:
            # idle-gap advance with the oracle's refresh-absorb rule
            target = arr_l[f]
            if t_refi:
                while next_ref <= target:
                    n_ref += 1
                    cur = [-1] * nb
                    end = next_ref + t_rfc
                    next_ref += t_refi
                    if end > target:
                        target = end
            idle += target - (anchor + off)
            anchor, off = target, 0
            streak = 0
        while anchor + off >= next_ref:     # refresh precedes the pick
            off += t_rfc
            n_ref += 1
            cur = [-1] * nb
            next_ref += t_refi
        # ---- scan phase: serve arrived hits, defer arrived misses ---
        while f < n and ndef < w and arr_l[f] <= anchor + off:
            if anchor + off >= next_ref:
                off += t_rfc
                n_ref += 1
                cur = [-1] * nb
                next_ref += t_refi
                streak = 0
                continue
            if streak >= STREAK:
                # -- array burst: state frozen while hits stream; runs
                # truncated by the arrival gate, the room-th miss, or
                # the refresh boundary
                kb = np.asarray(cur, np.int64)
                while f < n and ndef < w and arr_l[f] <= anchor + off:
                    room = w - ndef
                    chunk = min(max(32, 4 * room, grow), n - f)
                    sl = slice(f, f + chunk)
                    hm = kb[banks[sl]] == keys[sl]
                    hit_all = np.flatnonzero(hm)
                    costs_full = np.zeros(chunk, np.int64)
                    tc = None
                    if rw_arr is not None and hit_all.size:
                        dirs = rw_arr[f + hit_all]
                        prev = np.concatenate(([last_dir], dirs[:-1]))
                        tc = np.where(
                            (prev == 1) & (dirs == 0), t_wtr,
                            np.where((prev == 0) & (dirs == 1),
                                     t_rtw, 0)).astype(np.int64)
                        costs_full[hit_all] = cost_hit + tc
                    else:
                        costs_full[hit_all] = cost_hit
                    ends_full = off + np.cumsum(costs_full)
                    pre_full = ends_full - costs_full
                    take = chunk
                    late = np.flatnonzero(arr[sl] > anchor + pre_full)
                    if late.size:
                        take = int(late[0])
                    miss_rel = np.flatnonzero(~hm[:take])
                    if miss_rel.size >= room:
                        t2 = int(miss_rel[room - 1]) + 1
                        if t2 < take:
                            take = t2
                        miss_rel = miss_rel[:room]
                    hit_rel = hit_all[hit_all < take]
                    if t_refi and hit_rel.size:
                        cross = np.flatnonzero(
                            anchor + pre_full[hit_rel] >= next_ref)
                        if cross.size:       # cross[0] >= 1: refresh ran
                            kcut = int(cross[0])
                            take = int(hit_rel[kcut])
                            hit_rel = hit_rel[:kcut]
                            miss_rel = miss_rel[miss_rel < take]
                    k = hit_rel.size
                    if k:
                        n_hit += k
                        if tc is not None:
                            tsum = int(tc[:k].sum())  # hit_rel prefixes
                            turn += tsum
                            last_dir = int(rw_arr[f + hit_rel[-1]])
                        completion[f + hit_rel] = anchor + ends_full[hit_rel]
                        service[f + hit_rel] = costs_full[hit_rel]
                        off = int(ends_full[hit_rel[-1]])
                        out[out_n:out_n + k] = f + hit_rel
                        out_n += k
                    if miss_rel.size:
                        for m in (f + miss_rel).tolist():
                            kk = keys_l[m]
                            lst = buckets.get(kk)
                            if lst is None:
                                buckets[kk] = [m]
                            else:
                                lst.append(m)
                            order.append(m)
                        ndef += miss_rel.size
                    f += take
                    if take < chunk or anchor + off >= next_ref:
                        break
                    grow = min(chunk * 2, 1 << 20)
                streak = 0
                grow = max(64, 4 * w)
                continue
            k = keys_l[f]
            if cur[k // key_span] == k:
                c = cost_hit
                if rw_l is not None:
                    d = rw_l[f]
                    if d != last_dir:
                        if last_dir == 1:
                            c += t_wtr
                            turn += t_wtr
                        elif last_dir == 0:
                            c += t_rtw
                            turn += t_rtw
                        last_dir = d
                n_hit += 1
                off += c
                completion[f] = anchor + off
                service[f] = c
                out[out_n] = f
                out_n += 1
                streak += 1
            else:
                lst = buckets.get(k)
                if lst is None:
                    buckets[k] = [f]
                else:
                    lst.append(f)
                order.append(f)
                ndef += 1
                streak = 0
            f += 1
        if ndef == 0:
            continue
        if anchor + off >= next_ref:
            continue
        # ---- event: pop the oldest admitted miss --------------------
        while drained[order[head]]:
            head += 1
        d = order[head]
        head += 1
        ndef -= 1
        k = keys_l[d]
        if cur[k // key_span] == -1:
            n_first += 1
            c = cost_first
        else:
            n_conflict += 1
            c = cost_conf
        cur[k // key_span] = k
        if rw_l is not None:
            dd = rw_l[d]
            if dd != last_dir:
                if last_dir == 1:
                    c += t_wtr
                    turn += t_wtr
                elif last_dir == 0:
                    c += t_rtw
                    turn += t_rtw
                last_dir = dd
        off += c
        completion[d] = anchor + off
        service[d] = c
        out[out_n] = d
        out_n += 1
        streak = 0
        lst = buckets.pop(k)
        for i in range(1, len(lst)):
            if anchor + off >= next_ref:
                buckets[k] = lst[i:]
                break
            x = lst[i]
            c = cost_hit
            if rw_l is not None:
                dd = rw_l[x]
                if dd != last_dir:
                    if last_dir == 1:
                        c += t_wtr
                        turn += t_wtr
                    elif last_dir == 0:
                        c += t_rtw
                        turn += t_rtw
                    last_dir = dd
            n_hit += 1
            off += c
            completion[x] = anchor + off
            service[x] = c
            out[out_n] = x
            out_n += 1
            drained[x] = 1
            ndef -= 1
    return result_cls(
        total_fpga_cycles=(anchor + off) * timings.clock_ratio,
        row_hits=n_hit, row_conflicts=n_conflict, first_accesses=n_first,
        n_refreshes=n_ref, refresh_dram_cycles=n_ref * t_rfc,
        turnaround_dram_cycles=turn,
        service_order=out,
        completion_fpga_cycles=completion * timings.clock_ratio,
        service_dram_cycles=service,
        grant_order=np.arange(n, dtype=np.int64),
        granted_port=np.zeros(n, np.int64),
        idle_dram_cycles=idle)


def _arrivals_fast_single(addrs, n, timings, sched, rw_arr, arr, result_cls):
    """Arrival-gated chunked frontier scan (single admission queue)."""
    rows = timings.row_of(addrs)
    banks = timings.bank_of(addrs)
    w = sched.effective_window
    use_cap = sched.policy == "frfcfs_cap"
    cap = sched.starvation_cap
    t_refi, t_rfc = sched.t_refi, sched.t_rfc
    t_wtr, t_rtw = timings.t_wtr, timings.t_rtw
    cost_hit = timings.t_cl + timings.t_burst
    cost_first = timings.t_rcd + timings.t_cl + timings.t_burst
    cost_conf = (timings.t_rp + timings.t_rcd + timings.t_cl
                 + timings.t_burst)

    open_arr = np.zeros(timings.num_banks, np.int64)
    opened = np.zeros(timings.num_banks, bool)
    banks_l = banks.tolist()
    rows_l = rows.tolist()
    rw_l = None if rw_arr is None else rw_arr.tolist()
    arr_l = arr.tolist()
    open_l = [0] * timings.num_banks
    opened_l = [False] * timings.num_banks
    deferred: list[int] = []    # admitted misses, admission order
    byp: list[int] = []         # issues past each, parallel list
    out = np.empty(n, np.int64)
    out_n = 0
    completion = np.zeros(n, np.float64)
    service = np.zeros(n, np.int64)
    f = 0
    anchor = 0                  # float once the channel has idled
    off = 0                     # exact integer clocks since anchor
    next_ref = t_refi
    n_hit = n_conflict = n_first = n_ref = turn = 0
    last_dir = -1
    idle = 0.0
    grow = max(64, 4 * w)

    def serve_scalar(idx: int) -> None:
        nonlocal n_hit, n_conflict, n_first, off, turn, last_dir, out_n
        b, r = banks_l[idx], rows_l[idx]
        if not opened_l[b]:
            n_first += 1
            c = cost_first
        elif open_l[b] == r:
            n_hit += 1
            c = cost_hit
        else:
            n_conflict += 1
            c = cost_conf
        opened_l[b] = True
        open_l[b] = r
        opened[b] = True
        open_arr[b] = r
        if rw_l is not None:
            d = rw_l[idx]
            if last_dir == 1 and d == 0:
                turn += t_wtr
                c += t_wtr
            elif last_dir == 0 and d == 1:
                turn += t_rtw
                c += t_rtw
            last_dir = d
        off += c
        completion[idx] = anchor + off
        service[idx] = c
        out[out_n] = idx
        out_n += 1

    while f < n or deferred:
        if not deferred and arr_l[f] > anchor + off:
            # idle-gap advance: refreshes completing inside the gap
            # overlap with idleness; one in progress at the target
            # delays the next issue to its end (oracle's absorb rule)
            target = arr_l[f]
            if t_refi:
                while next_ref <= target:
                    n_ref += 1
                    opened[:] = False
                    opened_l = [False] * timings.num_banks
                    end = next_ref + t_rfc
                    next_ref += t_refi
                    if end > target:
                        target = end
            idle += target - (anchor + off)
            anchor, off = target, 0
        if t_refi:
            while anchor + off >= next_ref:   # refresh precedes the issue
                off += t_rfc
                n_ref += 1
                opened[:] = False
                opened_l = [False] * timings.num_banks
                next_ref += t_refi
        frontier_ok = f < n and arr_l[f] <= anchor + off
        if deferred and (len(deferred) >= w or not frontier_ok
                         or (use_cap and byp[0] >= cap)):
            # -- event: issue the oldest admitted miss, then drain the
            # deferred requests its newly opened row converts into hits
            serve_scalar(deferred.pop(0))
            if use_cap:
                byp.pop(0)
                while deferred:
                    if t_refi and anchor + off >= next_ref:
                        break
                    if byp[0] >= cap:
                        i = 0
                    elif len(deferred) <= 48:
                        i = -1
                        for kk, dd in enumerate(deferred):
                            bb = banks_l[dd]
                            if opened_l[bb] and open_l[bb] == rows_l[dd]:
                                i = kk
                                break
                        if i < 0:
                            break
                    else:
                        d_arr = np.asarray(deferred, np.int64)
                        db = banks[d_arr]
                        cand = np.flatnonzero(
                            opened[db] & (open_arr[db] == rows[d_arr]))
                        if cand.size == 0:
                            break
                        i = int(cand[0])
                    serve_scalar(deferred.pop(i))
                    byp.pop(i)
                    for kk in range(i):
                        byp[kk] += 1
            elif deferred and len(deferred) <= 48:
                cand_pos = [kk for kk, dd in enumerate(deferred)
                            if opened_l[banks_l[dd]]
                            and open_l[banks_l[dd]] == rows_l[dd]]
                if cand_pos:
                    served_pos: list[int] = []
                    for kk in cand_pos:
                        if t_refi and anchor + off >= next_ref:
                            break
                        serve_scalar(deferred[kk])
                        served_pos.append(kk)
                    if served_pos:
                        drop = set(served_pos)
                        deferred = [dd for kk, dd in enumerate(deferred)
                                    if kk not in drop]
            elif deferred:
                # vectorized deep-window drain, cut by refresh only
                d_arr = np.asarray(deferred, np.int64)
                db = banks[d_arr]
                cand = np.flatnonzero(
                    opened[db] & (open_arr[db] == rows[d_arr]))
                if cand.size:
                    idxs = d_arr[cand]
                    tcosts = None
                    if rw_arr is not None:
                        dirs = rw_arr[idxs]
                        prev = np.concatenate(([last_dir], dirs[:-1]))
                        tcosts = np.where(
                            (prev == 1) & (dirs == 0), t_wtr,
                            np.where((prev == 0) & (dirs == 1),
                                     t_rtw, 0)).astype(np.int64)
                    costs = (np.full(cand.size, cost_hit, np.int64)
                             if tcosts is None else cost_hit + tcosts)
                    ends = off + np.cumsum(costs)
                    j = cand.size
                    if t_refi:
                        cross = np.flatnonzero(
                            anchor + (ends - costs) >= next_ref)
                        if cross.size:
                            j = int(cross[0])
                    if j:
                        n_hit += j
                        if tcosts is not None:
                            tsum = int(tcosts[:j].sum())
                            turn += tsum
                            last_dir = int(rw_arr[idxs[j - 1]])
                        completion[idxs[:j]] = anchor + ends[:j]
                        service[idxs[:j]] = costs[:j]
                        off = int(ends[j - 1])
                        out[out_n:out_n + j] = idxs[:j]
                        out_n += j
                        keep = np.ones(d_arr.size, bool)
                        keep[cand[:j]] = False
                        deferred = [d for d, m in zip(deferred, keep)
                                    if m]
            continue
        if f >= n:
            break
        # -- scalar lane: defer leading misses (admission advances no
        # clock, so a frontier miss is pure bookkeeping) and, while the
        # arrived backlog is short, serve hits one at a time — the scan
        # machinery only pays off once a real backlog forms. Break
        # conditions mirror the scan's truncations; the event branch
        # above guarantees byp[0] < cap and a refresh-clean clock at
        # entry, so a break always makes progress first (moved=True).
        moved = False
        while f < n and arr_l[f] <= anchor + off:
            b = banks_l[f]
            if opened_l[b] and open_l[b] == rows_l[f]:
                if len(deferred) >= w:
                    break                     # window full: event drains
                if f + 16 < n and arr_l[f + 16] <= anchor + off:
                    break                     # backlog: vectorized scan
                if use_cap and byp and byp[0] >= cap:
                    break                     # cap: event serves a miss
                if t_refi and anchor + off >= next_ref:
                    break                     # refresh precedes the issue
                serve_scalar(f)
                if use_cap:
                    for kk in range(len(byp)):
                        byp[kk] += 1
            else:
                if len(deferred) >= w:
                    break                     # window full: event drains
                deferred.append(f)
                if use_cap:
                    byp.append(0)
            f += 1
            moved = True
        if moved:
            continue
        # -- scan run: serve arrived frontier hits, defer arrived misses
        room = w - len(deferred)
        chunk = min(max(32, 4 * room, grow), n - f)
        sl = slice(f, f + chunk)
        bsl = banks[sl]
        hm = opened[bsl] & (open_arr[bsl] == rows[sl])
        hit_all = np.flatnonzero(hm)
        costs_full = np.zeros(chunk, np.int64)
        tc = None
        if rw_arr is not None and hit_all.size:
            dirs = rw_arr[f + hit_all]
            prev = np.concatenate(([last_dir], dirs[:-1]))
            tc = np.where((prev == 1) & (dirs == 0), t_wtr,
                          np.where((prev == 0) & (dirs == 1),
                                   t_rtw, 0)).astype(np.int64)
            costs_full[hit_all] = cost_hit + tc
        else:
            costs_full[hit_all] = cost_hit
        ends_full = off + np.cumsum(costs_full)
        pre_full = ends_full - costs_full
        take = chunk
        # arrival gate: position j is admitted right after the issue of
        # every earlier chunk entry — eligible iff arrived by that clock
        late = np.flatnonzero(arr[sl] > anchor + pre_full)
        if late.size:
            take = int(late[0])
        miss_rel = np.flatnonzero(~hm[:take])
        if miss_rel.size >= room:
            t2 = int(miss_rel[room - 1]) + 1     # through the room-th miss
            if t2 < take:
                take = t2
            miss_rel = miss_rel[:room]
        hit_rel = hit_all[hit_all < take]
        if use_cap and hit_rel.size:
            if deferred:
                # every hit here is younger than the oldest pending miss
                budget = cap - byp[0]            # >= 1: event checked above
                if hit_rel.size > budget:
                    take = int(hit_rel[budget])
                    hit_rel = hit_rel[:budget]
                    miss_rel = miss_rel[miss_rel < take]
            elif miss_rel.size:
                # only hits *after* the first new miss bypass it
                after = hit_rel[hit_rel > miss_rel[0]]
                if after.size > cap:
                    take = int(after[cap])
                    hit_rel = hit_rel[hit_rel < take]
                    miss_rel = miss_rel[miss_rel < take]
        if t_refi and hit_rel.size:
            cross = np.flatnonzero(anchor + pre_full[hit_rel] >= next_ref)
            if cross.size:
                kcut = int(cross[0])             # >= 1: refresh ran above
                take = int(hit_rel[kcut])
                hit_rel = hit_rel[:kcut]
                miss_rel = miss_rel[miss_rel < take]
        k = hit_rel.size
        if k:
            n_hit += k
            if tc is not None:
                tsum = int(tc[:k].sum())         # hit_rel prefixes hit_all
                turn += tsum
                last_dir = int(rw_arr[f + hit_rel[-1]])
            completion[f + hit_rel] = anchor + ends_full[hit_rel]
            service[f + hit_rel] = costs_full[hit_rel]
            off = int(ends_full[hit_rel[-1]])
            out[out_n:out_n + k] = f + hit_rel
            out_n += k
        if use_cap:
            if k and byp:
                byp = [b + k for b in byp]
            if miss_rel.size:
                new_byp = k - np.searchsorted(hit_rel, miss_rel)
                byp.extend(int(b) for b in new_byp)
        if miss_rel.size:
            deferred.extend(int(m) for m in (f + miss_rel))
        f += take
        grow = chunk * 2 if take == chunk else 64
    return result_cls(
        total_fpga_cycles=(anchor + off) * timings.clock_ratio,
        row_hits=n_hit, row_conflicts=n_conflict, first_accesses=n_first,
        n_refreshes=n_ref, refresh_dram_cycles=n_ref * t_rfc,
        turnaround_dram_cycles=turn,
        service_order=out,
        completion_fpga_cycles=completion * timings.clock_ratio,
        service_dram_cycles=service,
        grant_order=np.arange(n, dtype=np.int64),
        granted_port=np.zeros(n, np.int64),
        idle_dram_cycles=idle)


def _arrivals_fast_multi(addrs, n, timings, sched, rw_arr, arr, ports,
                         nports, arb_policy, weights, result_cls):
    """Optimized event-at-a-time serving loop for arbitrated streams.

    Admission is coupled to the arbiter's rotation state, so deferring
    a grant can change which port wins a slot — the frontier-scan
    batching of the single-port path does not apply. Same spec as the
    oracle, with python-list state (~an order of magnitude cheaper than
    dict/numpy scalar indexing in this regime)."""
    from repro_torch.core.timing import _serving_weights

    rows = timings.row_of(addrs)
    banks = timings.bank_of(addrs)
    w = sched.effective_window
    use_cap = sched.policy == "frfcfs_cap"
    cap = sched.starvation_cap
    t_refi, t_rfc = sched.t_refi, sched.t_rfc
    t_wtr, t_rtw = timings.t_wtr, timings.t_rtw
    t_cl, t_rcd, t_rp = timings.t_cl, timings.t_rcd, timings.t_rp
    t_burst = timings.t_burst
    credits = _serving_weights(nports, arb_policy, weights)
    priority = arb_policy == "priority"

    banks_l = banks.tolist()
    rows_l = rows.tolist()
    rw_l = None if rw_arr is None else rw_arr.tolist()
    arr_l = arr.tolist()
    queues = [np.flatnonzero(ports == p).tolist() for p in range(nports)]
    qlen = [len(q) for q in queues]
    heads = [0] * nports
    open_l = [0] * timings.num_banks
    opened_l = [False] * timings.num_banks
    pending: list[int] = []
    bypass: list[int] = []
    ptr, credit = 0, credits[0]
    anchor = 0
    off = 0
    next_ref = t_refi
    n_hit = n_conflict = n_first = n_ref = turn = 0
    last_dir = -1
    idle = 0.0
    served = 0
    completion = np.zeros(n, np.float64)
    service = np.zeros(n, np.int64)
    out = np.empty(n, np.int64)
    grant_order = np.empty(n, np.int64)
    granted_port = np.empty(n, np.int64)
    granted = 0

    while served < n:
        cur = anchor + off
        while len(pending) < w:              # -- admission
            g = -1
            if priority:
                for p in range(nports):
                    h = heads[p]
                    if h < qlen[p] and arr_l[queues[p][h]] <= cur:
                        g = p
                        break
            else:
                for _ in range(nports + 1):
                    if credit > 0:
                        h = heads[ptr]
                        if h < qlen[ptr] and arr_l[queues[ptr][h]] <= cur:
                            g = ptr
                            credit -= 1
                            break
                    ptr += 1
                    if ptr == nports:
                        ptr = 0
                    credit = credits[ptr]
            if g < 0:
                break
            idx = queues[g][heads[g]]
            heads[g] += 1
            pending.append(idx)
            bypass.append(0)
            grant_order[granted] = idx
            granted_port[granted] = g
            granted += 1
        if not pending:                      # -- idle-gap advance
            target = min(arr_l[queues[p][heads[p]]] for p in range(nports)
                         if heads[p] < qlen[p])
            if t_refi:
                while next_ref <= target:
                    n_ref += 1
                    opened_l = [False] * timings.num_banks
                    end = next_ref + t_rfc
                    next_ref += t_refi
                    if end > target:
                        target = end
            idle += target - (anchor + off)
            anchor, off = target, 0
            continue
        if t_refi:
            while anchor + off >= next_ref:
                off += t_rfc
                n_ref += 1
                opened_l = [False] * timings.num_banks
                next_ref += t_refi
        pick = 0
        if w > 1:
            forced = -1
            if use_cap:
                for i, bp in enumerate(bypass):
                    if bp >= cap:
                        forced = i
                        break
            if forced >= 0:
                pick = forced
            else:
                for i, j in enumerate(pending):
                    b = banks_l[j]
                    if opened_l[b] and open_l[b] == rows_l[j]:
                        pick = i
                        break
        idx = pending.pop(pick)
        bypass.pop(pick)
        b, r = banks_l[idx], rows_l[idx]
        if not opened_l[b]:
            n_first += 1
            cost = t_rcd + t_cl
        elif open_l[b] == r:
            n_hit += 1
            cost = t_cl
        else:
            n_conflict += 1
            cost = t_rp + t_rcd + t_cl
        opened_l[b] = True
        open_l[b] = r
        cost += t_burst
        if rw_l is not None:
            d = rw_l[idx]
            if last_dir == 1 and d == 0:
                turn += t_wtr
                cost += t_wtr
            elif last_dir == 0 and d == 1:
                turn += t_rtw
                cost += t_rtw
            last_dir = d
        off += cost
        for i in range(pick):
            bypass[i] += 1
        completion[idx] = anchor + off
        service[idx] = cost
        out[served] = idx
        served += 1
    return result_cls(
        total_fpga_cycles=(anchor + off) * timings.clock_ratio,
        row_hits=n_hit, row_conflicts=n_conflict, first_accesses=n_first,
        n_refreshes=n_ref, refresh_dram_cycles=n_ref * t_rfc,
        turnaround_dram_cycles=turn,
        service_order=out,
        completion_fpga_cycles=completion * timings.clock_ratio,
        service_dram_cycles=service,
        grant_order=grant_order,
        granted_port=granted_port,
        idle_dram_cycles=idle)


def simulate_faults_fast(addrs, timings, sched, rw=None, *,
                         faults, channel=0, arrival_fpga=None,
                         pe_id=None, num_ports=None,
                         arb_policy="round_robin", weights=None,
                         trace=None):
    """Fast path of :func:`repro_torch.core.timing.simulate_faults` —
    bit-identical to ``simulate_faults_seq`` (property-tested over
    fault rate x ECC mode x replay bound x backoff x outage x ports x
    DRAM policy x refresh).

    Same optimized event-at-a-time loop as
    :func:`_arrivals_fast_multi` (python-list state, anchored clock),
    with the RAS layer woven around the service step. The fault draws
    are where the speed comes from: every request's *first-attempt*
    uniform and weak-row flag are computed in one vectorized
    splitmix64 pass up front (the counter-based hash makes the draw a
    pure function of ``(seed, channel, index, attempt)``, so
    evaluating it early cannot perturb anything); only replay attempts
    — rare by construction — fall back to the scalar hash, which is
    the same wrapping arithmetic.

    ``trace`` (the lifecycle event stream) is ROADMAP A5.3: one that is
    not ``None`` raises ``NotImplementedError``.
    """
    import heapq

    from repro_torch.core import faults as F
    from repro_torch.core.timing import (FaultSimResult, _serving_trace,
                                         _serving_weights, refuse_trace)

    refuse_trace(trace)
    fc = faults
    addrs, n, rw_arr, arr, ports, nports = _serving_trace(
        addrs, timings, rw, arrival_fpga, pe_id, num_ports)
    credits = _serving_weights(nports, arb_policy, weights)
    if n == 0:
        return FaultSimResult(total_fpga_cycles=0.0, row_hits=0,
                              row_conflicts=0, first_accesses=0)
    rows = timings.row_of(addrs)
    banks = timings.bank_of(addrs)
    w = sched.effective_window
    use_cap = sched.policy == "frfcfs_cap"
    cap = sched.starvation_cap
    t_refi, t_rfc = sched.t_refi, sched.t_rfc
    t_wtr, t_rtw = timings.t_wtr, timings.t_rtw
    t_cl, t_rcd, t_rp = timings.t_cl, timings.t_rcd, timings.t_rp
    t_burst = timings.t_burst
    priority = arb_policy == "priority"
    secded = fc.ecc == "secded"
    due_frac = fc.due_fraction
    ecc_clocks = fc.ecc_correction_clocks
    write_crc = fc.write_crc
    max_replays = fc.max_replays
    retire_thresh = fc.row_retire_threshold
    esc_thresh = fc.refresh_escalate_threshold
    wins = fc.outage_windows_for(channel)

    weak = F.weak_rows(fc, channel, rows)
    p_req = np.minimum(
        fc.transient_ber + np.where(weak, fc.weak_row_ber, 0.0), 1.0)
    # error_prob(fc, False) with the same float expression as the spec:
    p_base = fc.transient_ber if fc.transient_ber < 1.0 else 1.0
    if p_req.max() > 0.0:
        u1 = F.error_uniforms(fc, channel, np.arange(n, dtype=np.int64), 1)
    else:
        u1 = np.zeros(n)
    u1_l = u1.tolist()
    p_l = p_req.tolist()
    weak_l = weak.tolist()
    banks_l = banks.tolist()
    rows_l = rows.tolist()
    rw_l = None if rw_arr is None else rw_arr.tolist()
    arr_l = arr.tolist()
    ports_l = ports.tolist()
    queues = [np.flatnonzero(ports == p).tolist() for p in range(nports)]
    qlen = [len(q) for q in queues]
    heads = [0] * nports
    open_l = [0] * timings.num_banks
    opened_l = [False] * timings.num_banks
    pending: list[int] = []
    bypass: list[int] = []
    ptr, credit = 0, credits[0]
    anchor = 0
    off = 0
    next_ref = t_refi
    t_refi_eff = t_refi
    esc_level = 0
    n_hit = n_conflict = n_first = n_ref = turn = 0
    last_dir = -1
    idle = 0.0
    served = 0
    completion = np.zeros(n, np.float64)
    service = np.zeros(n, np.int64)
    attempts_np = np.zeros(n, np.int64)
    attempts = attempts_np.tolist()
    dropped = np.zeros(n, bool)
    grant_order = np.empty(n, np.int64)
    granted_port = np.empty(n, np.int64)
    granted = 0
    order: list[int] = []
    replay_q: list = []
    rseq = 0
    retired: dict[int, int] = {}
    err_count: dict[int, int] = {}
    st = F.FaultStats()
    retired_seq: list = []
    dropped_by_port: dict[int, int] = {}

    while served < n:
        cur = anchor + off
        while len(pending) < w:              # -- admission
            if replay_q and replay_q[0][0] <= cur:
                pending.append(heapq.heappop(replay_q)[2])
                bypass.append(0)
                continue
            g = -1
            if priority:
                for p in range(nports):
                    h = heads[p]
                    if h < qlen[p] and arr_l[queues[p][h]] <= cur:
                        g = p
                        break
            else:
                for _ in range(nports + 1):
                    if credit > 0:
                        h = heads[ptr]
                        if h < qlen[ptr] and arr_l[queues[ptr][h]] <= cur:
                            g = ptr
                            credit -= 1
                            break
                    ptr += 1
                    if ptr == nports:
                        ptr = 0
                    credit = credits[ptr]
            if g < 0:
                break
            idx = queues[g][heads[g]]
            heads[g] += 1
            pending.append(idx)
            bypass.append(0)
            grant_order[granted] = idx
            granted_port[granted] = g
            granted += 1
        if not pending:                      # -- idle-gap advance
            target = min(arr_l[queues[p][heads[p]]] for p in range(nports)
                         if heads[p] < qlen[p]) if any(
                heads[p] < qlen[p] for p in range(nports)) else replay_q[0][0]
            if replay_q and replay_q[0][0] < target:
                target = replay_q[0][0]
            if t_refi:
                while next_ref <= target:
                    n_ref += 1
                    opened_l = [False] * timings.num_banks
                    end = next_ref + t_rfc
                    next_ref += t_refi_eff
                    if end > target:
                        target = end
            idle += target - (anchor + off)
            anchor, off = target, 0
            continue
        now = anchor + off
        jumped = False
        for s, e in wins:                    # -- outage window stall
            if s <= now < e:
                target = float(e)
                if t_refi:
                    while next_ref <= target:
                        n_ref += 1
                        opened_l = [False] * timings.num_banks
                        end = next_ref + t_rfc
                        next_ref += t_refi_eff
                        if end > target:
                            target = end
                st.outage_dram_cycles += target - now
                anchor, off = target, 0
                jumped = True
                break
        if jumped:
            continue
        if t_refi:
            while anchor + off >= next_ref:
                off += t_rfc
                n_ref += 1
                opened_l = [False] * timings.num_banks
                next_ref += t_refi_eff
        pick = 0
        if w > 1:
            forced = -1
            if use_cap:
                for i, bp in enumerate(bypass):
                    if bp >= cap:
                        forced = i
                        break
            if forced >= 0:
                pick = forced
            elif retired:
                for i, j in enumerate(pending):
                    b = banks_l[j]
                    rj = rows_l[j]
                    if opened_l[b] and open_l[b] == retired.get(rj, rj):
                        pick = i
                        break
            else:
                for i, j in enumerate(pending):
                    b = banks_l[j]
                    if opened_l[b] and open_l[b] == rows_l[j]:
                        pick = i
                        break
        idx = pending.pop(pick)
        bypass.pop(pick)
        b, r_nat = banks_l[idx], rows_l[idx]
        r = retired.get(r_nat, r_nat) if retired else r_nat
        if r != r_nat:
            st.spare_issues += 1
        if not opened_l[b]:
            n_first += 1
            cost = t_rcd + t_cl
        elif open_l[b] == r:
            n_hit += 1
            cost = t_cl
        else:
            n_conflict += 1
            cost = t_rp + t_rcd + t_cl
        opened_l[b] = True
        open_l[b] = r
        cost += t_burst
        if rw_l is not None:
            d = rw_l[idx]
            if last_dir == 1 and d == 0:
                turn += t_wtr
                cost += t_wtr
            elif last_dir == 0 and d == 1:
                turn += t_rtw
                cost += t_rtw
            last_dir = d
        att = attempts[idx] + 1
        attempts[idx] = att
        if att > 1:
            st.n_replays += 1
        p_err = (p_l[idx] if r == r_nat else p_base) if weak_l[idx] \
            else p_l[idx]
        errored = False
        u = 0.0
        if p_err > 0.0:
            u = u1_l[idx] if att == 1 else F.error_uniform(
                fc, channel, idx, att)
            errored = u < p_err
        failed = False
        if errored:
            st.n_injected += 1
            if retire_thresh and r < F.SPARE_ROW_BASE:
                c = err_count.get(r, 0) + 1
                err_count[r] = c
                if (c >= retire_thresh and r_nat not in retired
                        and len(retired) < fc.max_retired_rows):
                    retired[r_nat] = F.SPARE_ROW_BASE + r_nat
                    retired_seq.append((channel, r_nat))
            if esc_thresh and t_refi:
                while (esc_level < fc.refresh_escalate_max
                       and st.n_injected >= esc_thresh * (esc_level + 1)):
                    esc_level += 1
                    st.refresh_escalations += 1
                    shrunk = t_refi >> esc_level
                    t_refi_eff = shrunk if shrunk > t_rfc else t_rfc + 1
            is_read = rw_l is None or rw_l[idx] == 0
            if is_read:
                if secded:
                    if u < p_err * due_frac:
                        failed = True
                    else:
                        st.n_corrected += 1
                        st.correction_dram_cycles += ecc_clocks
                        cost += ecc_clocks
                else:
                    st.n_silent += 1
            else:
                if write_crc:
                    failed = True
                else:
                    st.n_silent += 1
        off += cost
        for i in range(pick):
            bypass[i] += 1
        service[idx] += cost
        order.append(idx)
        if failed:
            st.n_uncorrectable += 1
            st.replay_dram_cycles += cost
            if att > max_replays:
                dropped[idx] = True
                st.n_dropped += 1
                port = ports_l[idx]
                dropped_by_port[port] = dropped_by_port.get(port, 0) + 1
                completion[idx] = anchor + off
                served += 1
            else:
                rseq += 1
                heapq.heappush(
                    replay_q,
                    (anchor + off + fc.backoff_for(att), rseq, idx))
        else:
            completion[idx] = anchor + off
            served += 1

    st.rows_retired = tuple(retired_seq)
    st.dropped_by_port = dropped_by_port
    attempts_np = np.asarray(attempts, np.int64)
    res = FaultSimResult(
        total_fpga_cycles=(anchor + off) * timings.clock_ratio,
        row_hits=n_hit, row_conflicts=n_conflict, first_accesses=n_first,
        n_refreshes=n_ref, refresh_dram_cycles=n_ref * t_rfc,
        turnaround_dram_cycles=turn,
        service_order=np.asarray(order, dtype=np.int64),
        completion_fpga_cycles=completion * timings.clock_ratio,
        service_dram_cycles=service,
        grant_order=grant_order[:granted],
        granted_port=granted_port[:granted],
        idle_dram_cycles=idle,
        fault=st, attempts=attempts_np, dropped=dropped)
    return res
