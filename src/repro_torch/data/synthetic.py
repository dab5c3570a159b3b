"""Open-loop arrival processes for the serving workloads (ARCHITECTURE §9).

Counterpart of the numpy arrival generators of the reference's
``repro.data.synthetic``, copied expression for expression: the pinned
serving goldens replay their draws bit for bit. The token half of that
module (``make_batch``, ``SyntheticDataset``) is ROADMAP A8.
"""

from __future__ import annotations

import numpy as np


# ---------------------------------------------------------------------------
# Open-loop arrival processes (serving workloads, ARCHITECTURE §9)
# ---------------------------------------------------------------------------
# All draws go through the bit-generator primitives (``rng.random`` /
# ``rng.integers``) with the shaping done in plain arithmetic — numpy
# guarantees stream stability for the bit generators, so the pinned
# serving goldens cannot drift between numpy releases (same rule as
# ``tests/core/golden_cases.py``). Times are FPGA cycles, float64.

def _exp_gaps(rng: np.random.Generator, n: int, rate: float) -> np.ndarray:
    """Exponential inter-arrival gaps of mean ``1/rate`` via inverse
    CDF on uniform draws (no ``Generator.exponential``)."""
    u = rng.random(n)
    return -np.log1p(-u) / rate


def poisson_arrivals(rng: np.random.Generator, n: int,
                     rate: float) -> np.ndarray:
    """Memoryless open-loop arrivals: ``n`` stamps at ``rate`` requests
    per FPGA cycle (the M/·/1 baseline every queueing result starts
    from)."""
    if rate <= 0:
        raise ValueError(f"rate={rate} must be positive")
    return np.cumsum(_exp_gaps(rng, n, rate))


def bursty_arrivals(rng: np.random.Generator, n: int, rate: float,
                    *, burst_len: int = 16,
                    burst_factor: float = 8.0) -> np.ndarray:
    """Markov-modulated bursts: runs of ``burst_len`` requests arrive
    ``burst_factor``× faster than ``rate``, separated by compensating
    idle gaps so the *long-run* offered load is still ``rate`` — the
    adversarial pattern that fills reorder windows and port FIFOs
    faster than the mean-rate analysis predicts."""
    if rate <= 0 or burst_factor <= 1 or burst_len < 1:
        raise ValueError("need rate > 0, burst_factor > 1, burst_len >= 1")
    gaps = _exp_gaps(rng, n, rate * burst_factor)
    starts = np.arange(n) % burst_len == 0
    # each burst owes (burst_len/rate) mean time but spends only
    # (burst_len/(rate*bf)) inside the burst — the idle gap carries
    # the difference, keeping the long-run rate exact
    idle_mean = burst_len / rate - burst_len / (rate * burst_factor)
    n_bursts = int(starts.sum())
    idle = np.zeros(n)
    idle[starts] = _exp_gaps(rng, n_bursts, 1.0 / idle_mean)
    return np.cumsum(gaps + idle)


def diurnal_arrivals(rng: np.random.Generator, n: int, rate: float,
                     *, cycles: float = 4.0,
                     depth: float = 0.8) -> np.ndarray:
    """Slowly-modulated load: the instantaneous rate swings
    ``rate * (1 ± depth)`` sinusoidally over ``cycles`` full periods of
    the trace — peak-hour pressure and trough idle in one stream."""
    if rate <= 0 or not 0 <= depth < 1:
        raise ValueError("need rate > 0 and 0 <= depth < 1")
    phase = 2.0 * np.pi * cycles * np.arange(n) / max(1, n)
    # E[1/(1 + d sin)] = 1/sqrt(1 - d^2): pre-scale so the *long-run*
    # rate is exactly ``rate`` despite the harmonic-mean penalty
    inst = (rate / np.sqrt(1.0 - depth * depth)
            * (1.0 + depth * np.sin(phase)))
    return np.cumsum(_exp_gaps(rng, n, 1.0)[:n] / inst)


def hog_victim_workload(rng: np.random.Generator, *,
                        n_victim: int, n_hog: int,
                        victim_rate: float, hog_rate: float,
                        n_rows: int = 8192, victim_burst: int = 8,
                        victim_port: int = 0, hog_port: int = 1):
    """Two-tenant isolation workload (Memory-Controller-Wall style):

    * tenant ``victim_port`` — a latency-SLO service whose *queries*
      arrive Poisson but touch ``victim_burst`` Zipf-popular pages at
      once (one query = one burst of same-stamp reads; long-run rate is
      still ``victim_rate`` requests/cycle);
    * tenant ``hog_port`` — a bandwidth hog streaming sequential rows
      (with write-backs) at ``hog_rate``, typically >> victim_rate.

    Returns ``(row_ids, rw, pe_id, arrival_cycle)`` merged in arrival
    order (stable sort — ties keep victim-first determinism), ready for
    ``MemoryController.simulate(..., arrival_cycle=...)``.
    """
    # victim: Zipf-shaped popularity (inverse-CDF, as golden_cases.py)
    u = np.clip(rng.random(n_victim), 1e-12, 1.0)
    v_rows = (np.floor(np.minimum(u ** (-1.0 / 0.2), 2.0 ** 62))
              .astype(np.int64) - 1) % n_rows
    v_rw = np.zeros(n_victim, np.int32)
    if victim_burst < 1:
        raise ValueError(f"victim_burst={victim_burst} must be >= 1")
    n_q = -(-n_victim // victim_burst)
    q_arr = poisson_arrivals(rng, n_q, victim_rate / victim_burst)
    v_arr = np.repeat(q_arr, victim_burst)[:n_victim]
    # hog: sequential sweep with jitter, 1-in-4 write
    h_rows = ((np.arange(n_hog) // 2 + rng.integers(0, 4, n_hog))
              % n_rows).astype(np.int64)
    h_rw = (np.arange(n_hog) % 4 == 3).astype(np.int32)
    h_arr = bursty_arrivals(rng, n_hog, hog_rate)
    rows = np.concatenate([v_rows, h_rows])
    rw = np.concatenate([v_rw, h_rw])
    pe = np.concatenate([np.full(n_victim, victim_port, np.int64),
                         np.full(n_hog, hog_port, np.int64)])
    arr = np.concatenate([v_arr, h_arr])
    order = np.argsort(arr, kind="stable")
    return rows[order], rw[order], pe[order], arr[order]
