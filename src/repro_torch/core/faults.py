"""Deterministic fault-injection primitives for the RAS layer
(ARCHITECTURE.md §10).

Everything the fault model draws — whether an access errors, whether a
detected error exceeds SECDED correction, which rows are weak — is a
pure function of ``(seed, channel, request index, attempt)`` through a
counter-based splitmix64 hash. There is no RNG *stream*: the oracle in
``timing.simulate_faults_seq`` and the fast path in
``trace_engine.simulate_faults_fast`` evaluate the same hash at the
same coordinates and therefore see the *same storm* bit-for-bit, no
matter in which order or how many times each evaluates it. The scalar
(python-int) and vectorized (numpy uint64) implementations below are
the same wrapping 64-bit arithmetic and are property-tested equal.

Row retirement uses a reserved spare-row id space: retiring natural row
``r`` remaps every later access to ``SPARE_ROW_BASE + r`` in the same
bank — a distinct open-row id (so the retirement costs the row buffer
locality the natural row had) that is never weak and never retired
itself. ``SPARE_ROW_BASE`` sits far above any reachable natural row id
(31-40 bit address spaces / row_bytes >= 4096 keep natural rows under
2^50 even after failed-channel remapping).

Counterpart of the reference's ``repro.core.faults``, copied expression
for expression.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.config import FaultConfig

__all__ = [
    "SPARE_ROW_BASE", "REMAP_LOCAL_BASE", "FaultStats",
    "error_uniform", "error_uniforms", "error_prob",
    "weak_row", "weak_rows",
]

#: Spare rows used by row retirement live at ``SPARE_ROW_BASE + row``.
SPARE_ROW_BASE = 1 << 60

#: Re-homed traffic from failed channel index ``i`` (position in the
#: sorted failed list) lands at local addresses
#: ``(i+1) * REMAP_LOCAL_BASE + natural_local`` on its surviving
#: channel — a reserved region far above any natural local address
#: (40-bit app address spaces), but whose row ids stay far below
#: ``SPARE_ROW_BASE``.
REMAP_LOCAL_BASE = 1 << 44

_M64 = (1 << 64) - 1
_GOLD = 0x9E3779B97F4A7C15       # splitmix64 increment / seed stride
_MIX1 = 0xBF58476D1CE4E5B9
_MIX2 = 0x94D049BB133111EB
_G_CH = 0xD1342543DE82EF95       # per-channel stream stride
_G_IDX = 0xAF251AF3B0F025B5      # per-request stride (odd)
_G_ATT = 0x9E6C63D0876A9A61      # per-attempt stride (odd)
_ERR_SALT = 0x6A09E667F3BCC909   # error-draw stream
_WEAK_SALT = 0xBB67AE8584CAA73B  # weak-row-selection stream
_U53 = float(2.0 ** -53)


def _splitmix64_int(x: int) -> int:
    """splitmix64 finalizer on a python int (wrapping 64-bit)."""
    x = (x + _GOLD) & _M64
    x = ((x ^ (x >> 30)) * _MIX1) & _M64
    x = ((x ^ (x >> 27)) * _MIX2) & _M64
    return x ^ (x >> 31)


def _splitmix64_arr(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer on a uint64 array — the same wrapping
    arithmetic as :func:`_splitmix64_int` (numpy uint64 ops wrap)."""
    x = x + np.uint64(_GOLD)
    x = (x ^ (x >> np.uint64(30))) * np.uint64(_MIX1)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(_MIX2)
    return x ^ (x >> np.uint64(31))


def _stream_base(seed: int, channel: int, salt: int) -> int:
    return _splitmix64_int(
        (int(seed) * _GOLD + int(channel) * _G_CH + salt) & _M64)


def error_uniform(faults: FaultConfig, channel: int, idx: int,
                  attempt: int) -> float:
    """The uniform(0,1) deciding the fate of request ``idx``'s issue
    number ``attempt`` (1-based) on ``channel``. Scalar spec."""
    base = _stream_base(faults.seed, int(channel), _ERR_SALT)
    x = (base + int(idx) * _G_IDX + int(attempt) * _G_ATT) & _M64
    return (_splitmix64_int(x) >> 11) * _U53


def error_uniforms(faults: FaultConfig, channel: int, idx: np.ndarray,
                   attempt: int = 1) -> np.ndarray:
    """Vectorized :func:`error_uniform` over a request-index array for
    one fixed attempt number — bit-identical to the scalar spec."""
    base = _stream_base(faults.seed, channel, _ERR_SALT)
    x = (np.uint64(base)
         + np.asarray(idx, np.int64).astype(np.uint64) * np.uint64(_G_IDX)
         + np.uint64((attempt * _G_ATT) & _M64))
    return (_splitmix64_arr(x) >> np.uint64(11)).astype(np.float64) * _U53


def weak_row(faults: FaultConfig, channel: int, row: int) -> bool:
    """Whether natural row ``row`` on ``channel`` is a weak-row hot
    spot. Spare rows (>= ``SPARE_ROW_BASE``) are never weak. Scalar
    spec."""
    if faults.weak_row_fraction <= 0.0 or faults.weak_row_ber <= 0.0:
        return False
    if row >= SPARE_ROW_BASE:
        return False
    base = _stream_base(faults.seed, int(channel), _WEAK_SALT)
    x = (base + int(row) * _G_IDX) & _M64
    u = (_splitmix64_int(x) >> 11) * _U53
    return u < faults.weak_row_fraction


def weak_rows(faults: FaultConfig, channel: int,
              rows: np.ndarray) -> np.ndarray:
    """Vectorized :func:`weak_row` — bit-identical to the scalar
    spec."""
    rows = np.asarray(rows, np.int64)
    if faults.weak_row_fraction <= 0.0 or faults.weak_row_ber <= 0.0:
        return np.zeros(rows.shape, bool)
    base = _stream_base(faults.seed, channel, _WEAK_SALT)
    x = (np.uint64(base)
         + rows.astype(np.uint64) * np.uint64(_G_IDX))
    u = (_splitmix64_arr(x) >> np.uint64(11)).astype(np.float64) * _U53
    return (u < faults.weak_row_fraction) & (rows < SPARE_ROW_BASE)


def error_prob(faults: FaultConfig, weak: bool) -> float:
    """Per-issue error probability — the same float expression on both
    simulator paths (bit-identity)."""
    p = faults.transient_ber + (faults.weak_row_ber if weak else 0.0)
    return p if p < 1.0 else 1.0


@dataclasses.dataclass
class FaultStats:
    """Observability block for one fault-injected run (or an aggregate
    over channels). All cycle counts are DRAM command clocks.

    ``n_injected`` counts raw injected device errors (one per errored
    issue, replays included); each is classified exactly one of
    corrected / uncorrectable (enters replay) / silent. ``n_replays``
    counts re-issues actually performed; ``n_dropped`` requests whose
    last allowed attempt still failed — they complete (with a stamp)
    but are flagged, never silently lost. ``replay_dram_cycles`` is the
    bus time wasted by failed issues, ``correction_dram_cycles`` the
    ECC-pipeline stalls, ``outage_dram_cycles`` time the channel sat in
    a declared outage window with work pending. Degradation events:
    ``rows_retired`` is the ``(channel, row)`` retirement sequence,
    ``spare_issues`` counts issues served from spare rows afterwards,
    ``refresh_escalations`` the number of t_refi halvings triggered.
    ``dropped_by_port`` maps port/tenant id -> dropped requests (the
    per-tenant SLO impact of the storm).
    """

    n_injected: int = 0
    n_corrected: int = 0
    n_uncorrectable: int = 0
    n_silent: int = 0
    n_replays: int = 0
    n_dropped: int = 0
    correction_dram_cycles: int = 0
    replay_dram_cycles: int = 0
    outage_dram_cycles: float = 0.0
    spare_issues: int = 0
    refresh_escalations: int = 0
    rows_retired: tuple = ()
    dropped_by_port: dict = dataclasses.field(default_factory=dict)

    @property
    def degraded(self) -> bool:
        """True when any graceful-degradation policy fired."""
        return bool(self.rows_retired or self.refresh_escalations
                    or self.n_dropped)

    def combine(self, other: "FaultStats") -> "FaultStats":
        """Aggregate two channels' stats (order-preserving on the
        retirement sequence)."""
        merged = dict(self.dropped_by_port)
        for port, cnt in other.dropped_by_port.items():
            merged[port] = merged.get(port, 0) + cnt
        return FaultStats(
            n_injected=self.n_injected + other.n_injected,
            n_corrected=self.n_corrected + other.n_corrected,
            n_uncorrectable=self.n_uncorrectable + other.n_uncorrectable,
            n_silent=self.n_silent + other.n_silent,
            n_replays=self.n_replays + other.n_replays,
            n_dropped=self.n_dropped + other.n_dropped,
            correction_dram_cycles=(self.correction_dram_cycles
                                    + other.correction_dram_cycles),
            replay_dram_cycles=(self.replay_dram_cycles
                                + other.replay_dram_cycles),
            outage_dram_cycles=(self.outage_dram_cycles
                                + other.outage_dram_cycles),
            spare_issues=self.spare_issues + other.spare_issues,
            refresh_escalations=(self.refresh_escalations
                                 + other.refresh_escalations),
            rows_retired=self.rows_retired + other.rows_retired,
            dropped_by_port=merged)

    def as_dict(self) -> dict:
        """JSON-able snapshot (golden records / bench artifacts)."""
        return {
            "n_injected": self.n_injected,
            "n_corrected": self.n_corrected,
            "n_uncorrectable": self.n_uncorrectable,
            "n_silent": self.n_silent,
            "n_replays": self.n_replays,
            "n_dropped": self.n_dropped,
            "correction_dram_cycles": self.correction_dram_cycles,
            "replay_dram_cycles": self.replay_dram_cycles,
            "outage_dram_cycles": round(float(self.outage_dram_cycles), 3),
            "spare_issues": self.spare_issues,
            "refresh_escalations": self.refresh_escalations,
            "rows_retired": [[int(c), int(r)] for c, r in self.rows_retired],
            "dropped_by_port": {str(p): int(c) for p, c
                                in sorted(self.dropped_by_port.items())},
        }
