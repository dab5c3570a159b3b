"""Multi-port, multi-channel front end — PE arbitration + address mapping
+ channel-parallel DRAM simulation.

The paper's controller is explicitly *multi-port* (several PEs share one
memory interface) and *memory-spec programmable*; HBM-class parts widen
that picture to several independent DRAM channels behind one address
space. This module is the layer between batch formation and the DRAM
model that makes both concrete:

1. **AddressMap** — decomposes a flat physical address into
   ``(channel, bank, row)`` under a configurable interleave policy
   (``ChannelConfig``): row-interleave, block-interleave, or XOR-permuted
   block interleave (the classic fix for power-of-two stride camping).
   The map is a bijection ``addr ↔ (channel, local_addr)``; bank/row are
   then the ordinary ``DRAMTimings`` decode of the *local* address.

2. **Multi-port arbiter** — merges per-``pe_id`` request streams into
   per-channel service queues under round-robin / fixed-priority /
   weighted-round-robin policies. Each port's stream is a FIFO, so
   **per-port arrival order is preserved into every channel queue**
   (the weak-consistency rule the scheduler relies on); per-port
   grant/stall/fairness statistics are reported.

3. **Channel-parallel simulation** — channels are *exactly* independent
   after mapping: a request touches only its own channel's bank/row
   state, and the per-channel rw substream (in arrival order) determines
   that channel's bus turnarounds. The trace therefore partitions by
   channel the same way the cache partitions by set (the set-parallel
   trace engine's argument), so the fast path classifies every channel
   with the vectorized
   :func:`repro_torch.core.timing.simulate_dram_access` and aggregates
   makespan = max over channels + arbitration fill. The strict
   one-request-at-a-time walk is kept as ``simulate_channels_seq`` — the
   oracle the fast path is property-tested against (bit-identical).

Arbitration and mapping are host-side control plane (numpy), like the
batch formers: they decide *order* and *cost*, never values.

Counterpart of the reference's ``repro.core.channels``, copied
expression for expression; numpy on the host, like the reference's.

Since the staged-pipeline refactor (``repro_torch.core.pipeline``, ARCHITECTURE
§7) the *fast paths* of the two front-end compositions below delegate to
pipeline stage subsets; the ``use_seq_oracle=True`` compositions keep the
original request-at-a-time code and remain the bit-identity oracles.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np

from repro_torch.core.config import (ChannelConfig, DRAMSchedConfig,
                                     SchedulerConfig)
from repro_torch.core.timing import (DRAMTimings, DDR4_2400, SimResult,
                                     simulate_dram_access, simulate_dram_sched,
                                     simulate_dram_sched_seq)

ARBITER_POLICIES = ("round_robin", "priority", "weighted")


# ---------------------------------------------------------------------------
# 1. Address mapping
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AddressMap:
    """Configurable physical-address → (channel, bank, row) decomposition.

    The channel-select field sits at ``granularity`` byte alignment
    (``granularity = row_bytes`` for ``row_interleave``, else
    ``interleave_bytes``). ``local_addr`` removes that field, compacting
    each channel's share into a dense private address space — so per
    channel, the ordinary open-row decode (``DRAMTimings.row_of`` /
    ``bank_of``) applies unchanged, and the map is a bijection
    ``addr ↔ (channel, local_addr)`` for every policy (the XOR policy
    permutes *which* channel a block lands on, never the local image).
    """

    config: ChannelConfig
    timings: DRAMTimings = dataclasses.field(
        default_factory=lambda: DDR4_2400)
    #: RAS config (``faults.failed_channels`` re-maps a failed
    #: channel's traffic onto the survivors — ARCHITECTURE §10).
    faults: "object | None" = None

    @property
    def granularity(self) -> int:
        if self.config.policy == "row_interleave":
            return self.timings.row_bytes
        return self.config.interleave_bytes

    @property
    def failed_channels(self) -> tuple[int, ...]:
        if self.faults is None:
            return ()
        return tuple(sorted(self.faults.failed_channels))

    @property
    def surviving_channels(self) -> tuple[int, ...]:
        dead = set(self.failed_channels)
        return tuple(c for c in range(self.config.num_channels)
                     if c not in dead)

    def _fold(self, block: np.ndarray) -> np.ndarray:
        """XOR-fold every log2(c)-bit digit of ``block`` into one digit.

        Masking once at the end is exact: AND distributes over XOR. The
        fold stops at the widest occupied bit — higher shifts contribute
        zeros (negative blocks sign-extend, so they take all 64)."""
        c = self.config.num_channels
        bits = c.bit_length() - 1
        hi = int(block.max(initial=0))
        max_bits = 64 if int(block.min(initial=0)) < 0 \
            else max(1, hi.bit_length())
        folded = np.zeros_like(block)
        for shift in range(0, max_bits, bits):
            folded ^= block >> shift
        return (folded & (c - 1)).astype(np.int64)

    def _natural_channel(self, addr) -> np.ndarray:
        addr = np.asarray(addr, dtype=np.int64)
        c = self.config.num_channels
        if c == 1:
            return np.zeros_like(addr)
        block = addr // self.granularity
        if self.config.policy == "xor":
            # Permutation-based interleave: XOR-fold *every* log2(c)-bit
            # digit of the block index into the channel select, so any
            # power-of-two stride (however far above the granularity)
            # still touches all channels.
            return self._fold(block)
        return (block % c).astype(np.int64)

    def channel_of(self, addr) -> np.ndarray:
        ch = self._natural_channel(addr)
        failed = self.failed_channels
        if not failed:
            return ch
        # Failed-channel degradation: a dead channel's blocks spread
        # round-robin over the survivors (by natural block index), so
        # the re-homed traffic shares every surviving channel's
        # bandwidth instead of doubling up on one.
        addr = np.asarray(addr, dtype=np.int64)
        block = addr // self.granularity
        surv = np.asarray(self.surviving_channels, np.int64)
        out = ch.copy()
        for f in failed:
            m = ch == f
            if m.any():
                out[m] = surv[block[m] % surv.size]
        return out

    def local_addr(self, addr) -> np.ndarray:
        """Address within the owning channel (channel-select field
        removed). Dense per channel; keeps sub-block offsets. Re-homed
        traffic from a failed channel lands in a reserved region of the
        survivor's space (``REMAP_LOCAL_BASE`` per failed channel) —
        distinct rows from the survivor's native traffic, preserving
        the ``addr ↔ (channel, local_addr)`` bijection."""
        local = self._natural_local(addr)
        failed = self.failed_channels
        if not failed:
            return local
        from repro_torch.core.faults import REMAP_LOCAL_BASE
        ch = self._natural_channel(addr)
        out = local.copy()
        for i, f in enumerate(failed):
            m = ch == f
            if m.any():
                out[m] = (i + 1) * REMAP_LOCAL_BASE + local[m]
        return out

    def _natural_local(self, addr) -> np.ndarray:
        addr = np.asarray(addr, dtype=np.int64)
        c = self.config.num_channels
        if c == 1:
            return addr
        g = self.granularity
        return (addr // g // c) * g + addr % g

    def _natural_global(self, channel, local) -> np.ndarray:
        channel = np.asarray(channel, dtype=np.int64)
        local = np.asarray(local, dtype=np.int64)
        c = self.config.num_channels
        if c == 1:
            return local + np.zeros_like(channel)
        g = self.granularity
        group, offset = local // g, local % g
        if self.config.policy == "xor":
            low = (channel ^ self._fold(group)) & (c - 1)
        else:
            low = channel
        return (group * c + low) * g + offset

    def global_addr(self, channel, local) -> np.ndarray:
        """Inverse of the bijection: recompose ``(channel, local_addr)``
        into the flat physical address. For the XOR policy the low block
        digit is recovered as ``channel XOR fold(group)`` — the fold of
        ``block = group*c + d`` is ``d XOR fold(group)``, so the XOR
        cancels. A re-homed local (>= ``REMAP_LOCAL_BASE``) encodes
        which failed channel it came from, so the natural address is
        recovered from that channel, ignoring the survivor it was
        served on. Used by the pipeline's CacheFilter to give victim
        write-backs a real physical address; round-trip property-tested.
        """
        failed = self.failed_channels
        if not failed:
            return self._natural_global(channel, local)
        from repro_torch.core.faults import REMAP_LOCAL_BASE
        channel = np.asarray(channel, dtype=np.int64)
        local = np.asarray(local, dtype=np.int64)
        remapped = local >= REMAP_LOCAL_BASE
        if not remapped.any():
            return self._natural_global(channel, local)
        fidx = np.clip(local // REMAP_LOCAL_BASE - 1, 0, len(failed) - 1)
        failed_arr = np.asarray(failed, np.int64)
        nat_ch = np.where(remapped, failed_arr[fidx], channel)
        nat_local = np.where(remapped, local % REMAP_LOCAL_BASE, local)
        return self._natural_global(nat_ch, nat_local)

    def decompose(self, addr):
        """``(channel, bank, row)`` of each address."""
        local = self.local_addr(addr)
        return (self.channel_of(addr), self.timings.bank_of(local),
                self.timings.row_of(local))


# ---------------------------------------------------------------------------
# 2. Multi-port arbiter
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ArbiterStats:
    """Per-port service statistics for one arbitrated queue."""

    grants: np.ndarray       # (P,) requests granted to each port
    stall_slots: np.ndarray  # (P,) grant slots a port waited with work
    fairness: float          # Jain index over per-port grant counts

    @staticmethod
    def from_grant_order(ports: np.ndarray, num_ports: int) -> "ArbiterStats":
        """Derive stats from the granted-port sequence (slot order).

        A port *stalls* in every grant slot before its last grant that
        went to a different port — it still had pending requests (FIFO
        queues, saturated arrival) but was not picked.
        """
        ports = np.asarray(ports, dtype=np.int64)
        grants = np.bincount(ports, minlength=num_ports)[:num_ports]
        stalls = np.zeros(num_ports, dtype=np.int64)
        if ports.size:
            slots = np.arange(ports.size, dtype=np.int64)
            last = np.full(num_ports, -1, dtype=np.int64)
            last[ports] = slots          # fancy assignment: last wins
            present = last >= 0
            stalls[present] = last[present] + 1 - grants[present]
        return ArbiterStats(grants=grants, stall_slots=stalls,
                            fairness=_jain(grants))


def _jain(grants: np.ndarray) -> float:
    """Jain fairness index over the ports that received any service
    (1.0 = perfectly even; → 1/n as one port dominates)."""
    n_active = int((grants > 0).sum())
    if n_active == 0:
        return 1.0
    g = grants[grants > 0].astype(np.float64)
    return float(g.sum() ** 2 / (n_active * (g ** 2).sum()))


def _normalize_weights(num_ports: int, policy: str,
                       weights: Sequence[int] | None) -> np.ndarray:
    if policy not in ARBITER_POLICIES:
        raise ValueError(f"arbiter policy {policy!r} must be one of "
                         f"{ARBITER_POLICIES}")
    if policy != "weighted":
        return np.ones(num_ports, dtype=np.int64)
    if weights is None:
        raise ValueError("policy='weighted' requires per-port weights")
    w = np.asarray(weights, dtype=np.int64)
    if w.shape != (num_ports,) or (w < 1).any():
        raise ValueError("weights must be one positive integer per port")
    return w


def arbitrate_ports_seq(
    pe_id: np.ndarray,
    *,
    num_ports: int,
    policy: str = "round_robin",
    weights: Sequence[int] | None = None,
) -> tuple[np.ndarray, ArbiterStats]:
    """Reference arbiter — an explicit grant-per-slot loop over per-port
    FIFOs (saturated arrival: every request is pending from slot 0).
    Kept as the oracle :func:`arbitrate_ports` is property-tested
    against.

    Returns ``(perm, stats)``: ``perm`` lists request indices (into the
    input stream) in grant order; within each port the FIFO pop
    preserves arrival order by construction.
    """
    pe = np.asarray(pe_id, dtype=np.int64)
    if pe.size and (pe.min() < 0 or pe.max() >= num_ports):
        raise ValueError("pe_id outside [0, num_ports)")
    w = _normalize_weights(num_ports, policy, weights)
    queues = [list(np.flatnonzero(pe == p)) for p in range(num_ports)]
    heads = [0] * num_ports
    out: list[int] = []
    granted_port: list[int] = []
    if policy == "priority":
        # Fixed priority = ascending pe_id: the highest-priority port with
        # pending work wins every slot, so lower ports drain first.
        for p in range(num_ports):
            out.extend(queues[p])
            granted_port.extend([p] * len(queues[p]))
    else:
        # (Weighted) round robin with a rotating grant pointer: each full
        # rotation grants every still-busy port up to weight[p] requests,
        # ports in cyclic index order.
        remaining = sum(len(q) for q in queues)
        while remaining:
            for p in range(num_ports):
                q, h = queues[p], heads[p]
                take = min(int(w[p]), len(q) - h)
                for k in range(take):
                    out.append(q[h + k])
                    granted_port.append(p)
                heads[p] += take
                remaining -= take
    perm = np.asarray(out, dtype=np.int64)
    return perm, ArbiterStats.from_grant_order(
        np.asarray(granted_port, dtype=np.int64), num_ports)


def arbitrate_ports(
    pe_id: np.ndarray,
    *,
    num_ports: int,
    policy: str = "round_robin",
    weights: Sequence[int] | None = None,
) -> tuple[np.ndarray, ArbiterStats]:
    """Vectorized arbiter — identical grant order to
    :func:`arbitrate_ports_seq` via one stable sort.

    Key construction: each request's position within its port's FIFO is
    its cumulative count; under (weighted) round robin the request is
    granted in rotation ``pos // weight[p]``, within a rotation ports go
    in index order and a port's ``weight`` grants stay consecutive —
    i.e. stable sort by ``(rotation, port, pos)``. Fixed priority is the
    degenerate key ``(0, port, pos)``.
    """
    pe = np.asarray(pe_id, dtype=np.int64)
    if pe.size and (pe.min() < 0 or pe.max() >= num_ports):
        raise ValueError("pe_id outside [0, num_ports)")
    w = _normalize_weights(num_ports, policy, weights)
    n = pe.shape[0]
    ones = np.ones(n, dtype=np.int64)
    pos = np.zeros(n, dtype=np.int64)
    for p in range(num_ports):          # cumcount per port (P ≤ 128)
        m = pe == p
        pos[m] = np.cumsum(ones[m]) - 1
    rotation = np.zeros(n, dtype=np.int64) if policy == "priority" \
        else pos // w[pe]
    perm = np.lexsort((pos, pe, rotation))
    return perm, ArbiterStats.from_grant_order(pe[perm], num_ports)


def per_port_order_preserved(
    pe_id: np.ndarray,
    addrs: np.ndarray,
    *,
    num_ports: int,
    channel_cfg: ChannelConfig = ChannelConfig(),
    timings: DRAMTimings = DDR4_2400,
    policy: str = "round_robin",
    weights: Sequence[int] | None = None,
) -> bool:
    """Acceptance predicate: after mapping + arbitration, does every
    port's substream enter every channel queue in arrival order? True by
    construction (FIFO pop per port); exported so the property tests and
    the benchmark's machine-readable record check the same thing."""
    pe = np.asarray(pe_id, dtype=np.int64).ravel()
    ch = AddressMap(channel_cfg, timings).channel_of(addrs)
    for k in range(channel_cfg.num_channels):
        sel = np.flatnonzero(ch == k)
        perm, _ = arbitrate_ports(pe[sel], num_ports=num_ports,
                                  policy=policy, weights=weights)
        granted = sel[perm]
        for p in range(num_ports):
            mine = granted[pe[granted] == p]
            if mine.size > 1 and not (np.diff(mine) > 0).all():
                return False
    return True


def arbiter_fill_cycles(num_ports: int) -> int:
    """Grant-path latency of a ``num_ports``-wide arbiter: a binary
    grant/mux tree is ``ceil(log2(P))`` stages deep. The tree is
    pipelined (one grant per cycle per channel once full), so only the
    fill is exposed — charged once per simulation, in FPGA cycles."""
    return int(math.ceil(math.log2(num_ports))) if num_ports > 1 else 0


# ---------------------------------------------------------------------------
# 3. Channel-parallel DRAM simulation
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ChannelSimResult:
    """Aggregate of per-channel open-row simulations.

    ``makespan_fpga_cycles`` is the wall-clock model: channels service
    their queues concurrently, so the trace completes when the slowest
    channel drains, plus the (pipelined) arbitration fill.
    ``busy_fpga_cycles`` is the summed occupancy (energy/utilization
    view). Counts aggregate over channels.
    """

    makespan_fpga_cycles: float
    busy_fpga_cycles: float
    arbitration_cycles: float
    per_channel: list[SimResult]
    requests_per_channel: list[int]
    port_stats: ArbiterStats | None = None

    @property
    def row_hits(self) -> int:
        return sum(r.row_hits for r in self.per_channel)

    @property
    def row_conflicts(self) -> int:
        return sum(r.row_conflicts for r in self.per_channel)

    @property
    def first_accesses(self) -> int:
        return sum(r.first_accesses for r in self.per_channel)

    @property
    def hit_rate(self) -> float:
        n = self.row_hits + self.row_conflicts + self.first_accesses
        return self.row_hits / max(1, n)

    @property
    def total_fpga_cycles(self) -> float:
        """Alias so a ChannelSimResult reads like a SimResult (the
        modeled completion time of the whole trace)."""
        return self.makespan_fpga_cycles

    def as_sim_result(self) -> SimResult:
        return SimResult(total_fpga_cycles=self.makespan_fpga_cycles,
                         row_hits=self.row_hits,
                         row_conflicts=self.row_conflicts,
                         first_accesses=self.first_accesses)


def _aggregate(per_channel: list[SimResult], counts: list[int],
               arb_cycles: float,
               port_stats: ArbiterStats | None = None) -> ChannelSimResult:
    busy = float(sum(r.total_fpga_cycles for r in per_channel))
    makespan = (max((r.total_fpga_cycles for r in per_channel),
                    default=0.0) + arb_cycles)
    return ChannelSimResult(
        makespan_fpga_cycles=makespan, busy_fpga_cycles=busy,
        arbitration_cycles=arb_cycles, per_channel=per_channel,
        requests_per_channel=counts, port_stats=port_stats)


def simulate_channels_seq(
    addrs: np.ndarray,
    timings: DRAMTimings = DDR4_2400,
    channel_cfg: ChannelConfig = ChannelConfig(),
    rw: np.ndarray | None = None,
    dram_sched: DRAMSchedConfig | None = None,
) -> ChannelSimResult:
    """Reference channel simulator — one python iteration per request,
    walking the global trace in arrival order against per-channel
    per-bank open-row state (and per-channel last-direction state for
    the tWTR/tRTW turnarounds). Kept as the oracle
    :func:`simulate_channels` is property-tested against.

    ``dram_sched`` swaps each channel's interface for the out-of-order
    command scheduler oracle
    (:func:`repro_torch.core.timing.simulate_dram_sched_seq`): channels stay
    exactly independent (a reorder window spans only its own channel's
    queue), so the walk decomposes per channel.
    """
    amap = AddressMap(channel_cfg, timings)
    if dram_sched is not None and (dram_sched.effective_window > 1
                                   or dram_sched.t_refi):
        addrs = np.asarray(addrs, dtype=np.int64).ravel()
        ch = amap.channel_of(addrs)
        local = amap.local_addr(addrs)
        rw_arr = None if rw is None else np.asarray(rw, np.int32).ravel()
        per_channel, counts = [], []
        for k in range(channel_cfg.num_channels):
            sel = np.flatnonzero(ch == k)   # stable: keeps arrival order
            per_channel.append(simulate_dram_sched_seq(
                local[sel], timings, dram_sched,
                rw=None if rw_arr is None else rw_arr[sel]))
            counts.append(int(sel.shape[0]))
        return _aggregate(per_channel, counts, 0.0)
    addrs = np.asarray(addrs, dtype=np.int64).ravel()
    c = channel_cfg.num_channels
    ch = amap.channel_of(addrs)
    banks = timings.bank_of(amap.local_addr(addrs))
    rows = timings.row_of(amap.local_addr(addrs))
    rw_arr = None if rw is None else np.asarray(rw, np.int32).ravel()

    open_row: list[dict[int, int]] = [dict() for _ in range(c)]
    last_dir = [-1] * c
    n_first = [0] * c
    n_hit = [0] * c
    n_conflict = [0] * c
    n_req = [0] * c
    turn = [0] * c
    for i in range(addrs.shape[0]):
        k, b, r = int(ch[i]), int(banks[i]), int(rows[i])
        n_req[k] += 1
        state = open_row[k]
        if b not in state:
            n_first[k] += 1
        elif state[b] == r:
            n_hit[k] += 1
        else:
            n_conflict[k] += 1
        state[b] = r
        if rw_arr is not None:
            d = int(rw_arr[i])
            if last_dir[k] == 1 and d == 0:
                turn[k] += timings.t_wtr
            elif last_dir[k] == 0 and d == 1:
                turn[k] += timings.t_rtw
            last_dir[k] = d
    per_channel = []
    for k in range(c):
        dram_cycles = (
            n_first[k] * (timings.t_rcd + timings.t_cl)
            + n_hit[k] * timings.t_cl
            + n_conflict[k] * (timings.t_rp + timings.t_rcd + timings.t_cl)
            + n_req[k] * timings.t_burst + turn[k])
        per_channel.append(SimResult(
            total_fpga_cycles=dram_cycles * timings.clock_ratio,
            row_hits=n_hit[k], row_conflicts=n_conflict[k],
            first_accesses=n_first[k]))
    return _aggregate(per_channel, n_req, 0.0)


def simulate_channels(
    addrs: np.ndarray,
    timings: DRAMTimings = DDR4_2400,
    channel_cfg: ChannelConfig = ChannelConfig(),
    rw: np.ndarray | None = None,
    dram_sched: DRAMSchedConfig | None = None,
) -> ChannelSimResult:
    """Channel-parallel open-row simulation — bit-identical to
    :func:`simulate_channels_seq`.

    Channels are exactly independent after mapping (a request touches
    only its channel's bank state; turnarounds depend only on its
    channel's rw substream), so the trace is partitioned by channel —
    arrival order preserved within each channel by a stable selection —
    and every channel runs the vectorized
    :func:`~repro_torch.core.timing.simulate_dram_access` (or, with
    ``dram_sched``, the out-of-order command scheduler
    :func:`~repro_torch.core.timing.simulate_dram_sched`) on its *local*
    addresses.
    """
    amap = AddressMap(channel_cfg, timings)
    addrs = np.asarray(addrs, dtype=np.int64).ravel()
    c = channel_cfg.num_channels
    local = amap.local_addr(addrs)
    ch = amap.channel_of(addrs)
    rw_arr = None if rw is None else np.asarray(rw, np.int32).ravel()
    per_channel, counts = [], []
    for k in range(c):
        sel = np.flatnonzero(ch == k)       # stable: keeps arrival order
        sub_rw = None if rw_arr is None else rw_arr[sel]
        if dram_sched is not None:
            per_channel.append(simulate_dram_sched(
                local[sel], timings, dram_sched, rw=sub_rw))
        else:
            per_channel.append(simulate_dram_access(
                local[sel], timings, rw=sub_rw))
        counts.append(int(sel.shape[0]))
    return _aggregate(per_channel, counts, 0.0)


# ---------------------------------------------------------------------------
# Front-end pipelines: mapping (+ arbitration) (+ scheduling) → channels
# ---------------------------------------------------------------------------

def _run_channel(local_ch, rw_ch, *, sched_config, timings,
                 coalesce_writes, use_seq_oracle, dram_sched=None):
    """One channel's back half — optional scheduler front end, then the
    open-row simulation — with ``use_seq_oracle`` swapping every stage
    for its request-at-a-time sibling. Since the fast paths moved into
    ``repro_torch.core.pipeline`` this runs only as the oracle composition
    (``use_seq_oracle=True``) the pipeline is property-tested against;
    the flag is kept so the two compositions stay diffable."""
    from repro_torch.core import scheduler as sched

    if sched_config is not None:
        schedule = (sched.schedule_trace_rw_seq if use_seq_oracle
                    else sched.schedule_trace_rw)
        served, served_rw = schedule(local_ch, rw_ch, config=sched_config,
                                     timings=timings,
                                     coalesce_writes=coalesce_writes)
    else:
        served, served_rw = local_ch, rw_ch
    if use_seq_oracle:
        if dram_sched is not None and (dram_sched.effective_window > 1
                                       or dram_sched.t_refi):
            return simulate_dram_sched_seq(served, timings, dram_sched,
                                           rw=served_rw)
        return simulate_channels_seq(served, timings, ChannelConfig(),
                                     rw=served_rw).per_channel[0]
    if dram_sched is not None:
        return simulate_dram_sched(served, timings, dram_sched,
                                   rw=served_rw)
    return simulate_dram_access(served, timings, rw=served_rw)


def schedule_and_simulate_channels(
    addrs: np.ndarray,
    rw: np.ndarray | None = None,
    *,
    sched_config: SchedulerConfig,
    timings: DRAMTimings = DDR4_2400,
    channel_cfg: ChannelConfig = ChannelConfig(),
    coalesce_writes: bool = False,
    use_seq_oracle: bool = False,
    dram_sched: DRAMSchedConfig | None = None,
) -> ChannelSimResult:
    """Single-port multi-channel pipeline: map → per-channel scheduler
    (each channel owns a batch former + bitonic sorter, exactly like
    each channel owns a DRAM interface) → per-channel open-row
    simulation → makespan aggregate.

    The fast path is the staged pipeline (``repro_torch.core.pipeline``:
    AddressMap → BatchScheduler → DRAMService) viewed through the
    legacy aggregate. ``use_seq_oracle`` keeps the original
    request-at-a-time composition (``schedule_trace_rw_seq`` +
    per-request classification) — the pre-refactor code the pipeline is
    property-tested bit-identical against. ``dram_sched`` gives every
    channel's interface the out-of-order command scheduler (oracle
    sibling on the seq path).
    """
    if not use_seq_oracle:
        from repro_torch.core import pipeline as pipeline_mod
        stream = pipeline_mod.RequestStream.from_addrs(addrs, rw)
        ctx = pipeline_mod.PipelineContext(
            channels=channel_cfg, scheduler=sched_config, cache=None,
            timings=timings, dram_sched=dram_sched)
        return pipeline_mod.run_pipeline(
            stream, ctx, pipeline_mod.default_stages(
                ctx, cache=False, coalesce_writes=coalesce_writes)
        ).as_channel_result()
    amap = AddressMap(channel_cfg, timings)
    addrs = np.asarray(addrs, dtype=np.int64).ravel()
    rw_arr = np.zeros(addrs.shape[0], np.int32) if rw is None \
        else np.asarray(rw, np.int32).ravel()
    ch = amap.channel_of(addrs)
    local = amap.local_addr(addrs)
    per_channel, counts = [], []
    for k in range(channel_cfg.num_channels):
        sel = np.flatnonzero(ch == k)
        per_channel.append(_run_channel(
            local[sel], rw_arr[sel], sched_config=sched_config,
            timings=timings, coalesce_writes=coalesce_writes,
            use_seq_oracle=True, dram_sched=dram_sched))
        counts.append(int(sel.shape[0]))
    return _aggregate(per_channel, counts, 0.0)


def simulate_multiport_channels(
    pe_id: np.ndarray,
    addrs: np.ndarray,
    rw: np.ndarray | None = None,
    *,
    num_ports: int,
    policy: str = "round_robin",
    weights: Sequence[int] | None = None,
    timings: DRAMTimings = DDR4_2400,
    channel_cfg: ChannelConfig = ChannelConfig(),
    sched_config: SchedulerConfig | None = None,
    coalesce_writes: bool = False,
    use_seq_oracle: bool = False,
    dram_sched: DRAMSchedConfig | None = None,
) -> ChannelSimResult:
    """Full front end: per-PE streams → per-channel arbiter → optional
    per-channel scheduler → channel-parallel DRAM simulation.

    Each channel owns an arbiter instance that merges the port
    substreams destined for it (per-port FIFOs ⇒ per-port arrival order
    is preserved into every channel queue). The makespan charges the
    slowest channel plus the arbiter fill
    (:func:`arbiter_fill_cycles`). Port statistics aggregate over all
    channel arbiters: grants and stall slots sum, and ``fairness`` is
    the Jain index of the aggregated per-port grant counts.

    The fast path is the staged pipeline (``repro_torch.core.pipeline``:
    AddressMap → PortArbiter → BatchScheduler → DRAMService) viewed
    through the legacy aggregate. ``use_seq_oracle`` keeps the original
    all-sequential composition (``arbitrate_ports_seq`` /
    ``schedule_trace_rw_seq`` / per-request channel walk) — the
    pre-refactor code the pipeline is property-tested bit-identical
    against.
    """
    if not use_seq_oracle:
        from repro_torch.core import pipeline as pipeline_mod
        stream = pipeline_mod.RequestStream.from_addrs(addrs, rw,
                                                       pe_id=pe_id)
        ctx = pipeline_mod.PipelineContext(
            channels=channel_cfg, scheduler=sched_config, cache=None,
            timings=timings, dram_sched=dram_sched)
        return pipeline_mod.run_pipeline(
            stream, ctx, pipeline_mod.default_stages(
                ctx, ports=num_ports, arbiter_policy=policy,
                weights=weights, cache=False,
                coalesce_writes=coalesce_writes)
        ).as_channel_result()
    amap = AddressMap(channel_cfg, timings)
    addrs = np.asarray(addrs, dtype=np.int64).ravel()
    pe = np.asarray(pe_id, dtype=np.int64).ravel()
    if pe.shape != addrs.shape:
        raise ValueError("pe_id must have one entry per request")
    rw_arr = np.zeros(addrs.shape[0], np.int32) if rw is None \
        else np.asarray(rw, np.int32).ravel()
    ch = amap.channel_of(addrs)
    local = amap.local_addr(addrs)
    arbitrate = arbitrate_ports_seq

    per_channel, counts = [], []
    grants = np.zeros(num_ports, dtype=np.int64)
    stalls = np.zeros(num_ports, dtype=np.int64)
    for k in range(channel_cfg.num_channels):
        sel = np.flatnonzero(ch == k)
        perm, stats = arbitrate(pe[sel], num_ports=num_ports,
                                policy=policy, weights=weights)
        order = sel[perm]
        grants += stats.grants
        stalls += stats.stall_slots
        per_channel.append(_run_channel(
            local[order], rw_arr[order], sched_config=sched_config,
            timings=timings, coalesce_writes=coalesce_writes,
            use_seq_oracle=use_seq_oracle, dram_sched=dram_sched))
        counts.append(int(sel.shape[0]))
    port_stats = ArbiterStats(grants=grants, stall_slots=stalls,
                              fairness=_jain(grants))
    return _aggregate(per_channel, counts,
                      float(arbiter_fill_cycles(num_ports)),
                      port_stats=port_stats)


# ---------------------------------------------------------------------------
# Open-loop serving composition (arrival-aware front end)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ServingChannelResult(ChannelSimResult):
    """:class:`ChannelSimResult` plus the per-request latency arrays of
    an open-loop run — completion stamps aligned to the *input* trace
    order (arbiter fill included, like the makespan)."""

    completion_fpga_cycles: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.float64))
    service_fpga_cycles: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.float64))
    arrival_fpga_cycles: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.float64))
    idle_fpga_cycles: float = 0.0
    #: aggregated :class:`repro_torch.core.faults.FaultStats` over channels
    #: (``None`` on fault-free runs).
    fault: "object | None" = None
    #: per-request dropped flags (input trace order; all-False without
    #: faults).
    dropped: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, bool))

    @property
    def sojourn_fpga_cycles(self) -> np.ndarray:
        return self.completion_fpga_cycles - self.arrival_fpga_cycles


def simulate_serving_channels(
    addrs: np.ndarray,
    arrival_fpga: np.ndarray | None = None,
    rw: np.ndarray | None = None,
    *,
    pe_id: np.ndarray | None = None,
    num_ports: int | None = None,
    policy: str = "round_robin",
    weights: Sequence[int] | None = None,
    timings: DRAMTimings = DDR4_2400,
    channel_cfg: ChannelConfig = ChannelConfig(),
    dram_sched: DRAMSchedConfig | None = None,
    use_seq_oracle: bool = False,
    faults=None,
    trace=None,
) -> ServingChannelResult:
    """Arrival-aware front end: map → per-channel coupled
    admission+service (:func:`repro_torch.core.timing.simulate_arrivals`) →
    makespan/latency aggregate.

    Channels stay exactly independent after mapping (each owns its
    arbiter, reorder window and refresh counter), so the open-loop walk
    decomposes per channel like every closed-loop composition above.
    ``use_seq_oracle`` swaps every channel's engine for the
    request-at-a-time spec ``simulate_arrivals_seq`` — the two are
    bit-identical (property-tested), and with all-zero arrivals both
    degenerate to the closed-loop arbiter + scheduler results.

    ``faults`` (a :class:`repro_torch.core.config.FaultConfig`) turns on the
    RAS layer: the address map re-homes failed channels' traffic onto
    survivors, each surviving channel runs the fault-injected service
    (:func:`repro_torch.core.timing.simulate_faults`, keyed by its channel
    index so storms are independent per channel), and the per-channel
    :class:`~repro_torch.core.faults.FaultStats` aggregate into ``fault``.
    ``faults=None`` (or an inactive config) is bit-identical to the
    fault-free walk.

    ``trace`` (the reference's ``TraceRecorder``) opts into per-request
    lifecycle tracing, which is ROADMAP A5.3: one that is not ``None``
    raises ``NotImplementedError``.
    """
    from repro_torch.core.timing import (refuse_trace, simulate_arrivals,
                                         simulate_faults)

    refuse_trace(trace)

    amap = AddressMap(channel_cfg, timings, faults)
    addrs = np.asarray(addrs, dtype=np.int64).ravel()
    n = addrs.shape[0]
    arr = np.zeros(n, np.float64) if arrival_fpga is None \
        else np.asarray(arrival_fpga, np.float64).ravel()
    rw_arr = None if rw is None else np.asarray(rw, np.int32).ravel()
    pe = None if pe_id is None else np.asarray(pe_id, np.int64).ravel()
    ch = amap.channel_of(addrs)
    local = amap.local_addr(addrs)
    engine = "sequential" if use_seq_oracle else "auto"
    multi = num_ports is not None and num_ports > 1

    per_channel, counts = [], []
    completion = np.zeros(n, np.float64)
    service = np.zeros(n, np.float64)
    idle = 0.0
    grants = np.zeros(num_ports or 1, np.int64)
    stalls = np.zeros(num_ports or 1, np.int64)
    fault_agg = None
    dropped = np.zeros(n, bool)
    for k in range(channel_cfg.num_channels):
        sel = np.flatnonzero(ch == k)       # stable: keeps trace order
        sub = dict(
            rw=None if rw_arr is None else rw_arr[sel],
            arrival_fpga=arr[sel],
            pe_id=None if pe is None else pe[sel],
            num_ports=num_ports, arb_policy=policy, weights=weights,
            engine=engine,
            trace=(None if trace is None
                   else trace.channel(k, req_ids=sel)))
        sched_k = dram_sched if dram_sched is not None \
            else DRAMSchedConfig()
        if faults is None:
            res = simulate_arrivals(local[sel], timings, sched_k, **sub)
        else:
            res = simulate_faults(local[sel], timings, sched_k,
                                  faults=faults, channel=k, **sub)
            dropped[sel] = res.dropped if res.dropped.size else False
            fault_agg = res.fault if fault_agg is None \
                else fault_agg.combine(res.fault)
        completion[sel] = res.completion_fpga_cycles
        service[sel] = res.service_dram_cycles * timings.clock_ratio
        idle += res.idle_dram_cycles * timings.clock_ratio
        if multi:
            st = ArbiterStats.from_grant_order(res.granted_port,
                                               num_ports)
            grants += st.grants
            stalls += st.stall_slots
        per_channel.append(res)
        counts.append(int(sel.shape[0]))
    fill = float(arbiter_fill_cycles(num_ports)) if multi else 0.0
    agg = _aggregate(per_channel, counts, fill,
                     port_stats=(ArbiterStats(grants=grants,
                                              stall_slots=stalls,
                                              fairness=_jain(grants))
                                 if multi else None))
    return ServingChannelResult(
        **dataclasses.asdict(agg) | {"per_channel": per_channel,
                                     "port_stats": agg.port_stats},
        completion_fpga_cycles=completion + fill,
        service_fpga_cycles=service,
        arrival_fpga_cycles=arr,
        idle_fpga_cycles=idle,
        fault=fault_agg,
        dropped=dropped)
