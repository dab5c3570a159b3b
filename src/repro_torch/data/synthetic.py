"""Deterministic synthetic data: token batches and open-loop arrivals.

Counterpart of the reference's ``repro.data.synthetic``, copied
expression for expression on numpy alone: every batch is a pure function
of ``(seed, step)`` (no iterator state, so a restarted job regenerates
exactly the batch it stopped on), drawn from the same ``SeedSequence``
triples in the same order, and the pinned serving goldens replay the
arrival draws bit for bit. Token streams are Zipf-distributed; audio and
vision frontends get Gaussian frame / patch embeddings (the frontends
themselves are stubs). The reference's ``batch_specs`` builds sharding
specs and comes with the mesh (ROADMAP A9).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np

from repro_torch.configs.base import ArchConfig, ShapeConfig


def _rng(seed: int, step: int, role: int) -> np.random.Generator:
    # SeedSequence gives independent streams per (seed, step, role)
    return np.random.default_rng(np.random.SeedSequence((seed, step, role)))


def zipf_tokens(rng: np.random.Generator, shape, vocab: int,
                alpha: float = 1.1) -> np.ndarray:
    """Zipf-like token draw bounded to [0, vocab)."""
    z = rng.zipf(alpha, size=shape).astype(np.int64)
    return ((z - 1) % vocab).astype(np.int32)


def make_batch(cfg: ArchConfig, shape: ShapeConfig, *, step: int,
               seed: int = 0, batch_override: int | None = None
               ) -> Dict[str, np.ndarray]:
    """Materialize the global batch for ``step`` (host-RAM numpy):
    ``frames`` (float32) and ``labels`` for audio; ``vision_embeds``
    (float32), ``tokens`` and ``labels`` for vision_text, whose text
    takes ``seq_len - num_vision_tokens`` positions; ``tokens`` and
    ``labels`` (the next token) otherwise."""
    B = batch_override or shape.global_batch
    S = shape.seq_len
    out: Dict[str, np.ndarray] = {}
    if cfg.modality == "audio":
        out["frames"] = _rng(seed, step, 0).standard_normal(
            (B, S, cfg.frontend_dim), dtype=np.float32)
        out["labels"] = zipf_tokens(_rng(seed, step, 1), (B, S),
                                    cfg.vocab_size)
    elif cfg.modality == "vision_text":
        st = S - cfg.num_vision_tokens
        out["vision_embeds"] = _rng(seed, step, 0).standard_normal(
            (B, cfg.num_vision_tokens, cfg.frontend_dim), dtype=np.float32)
        toks = zipf_tokens(_rng(seed, step, 1), (B, st + 1), cfg.vocab_size)
        out["tokens"] = toks[:, :-1]
        out["labels"] = toks[:, 1:]
    else:
        toks = zipf_tokens(_rng(seed, step, 1), (B, S + 1), cfg.vocab_size)
        out["tokens"] = toks[:, :-1]
        out["labels"] = toks[:, 1:]
    return out


@dataclasses.dataclass
class SyntheticDataset:
    """Step-indexed iterator facade with host sharding.

    In a multi-host launch each host materializes only its slice of the
    global batch (``host_index/host_count``); single-host runs see the full
    batch. ``state_dict`` is just the step counter — resume is exact.
    """

    cfg: ArchConfig
    shape: ShapeConfig
    seed: int = 0
    host_index: int = 0
    host_count: int = 1
    batch_override: int | None = None

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        full = make_batch(self.cfg, self.shape, step=step, seed=self.seed,
                          batch_override=self.batch_override)
        if self.host_count == 1:
            return full
        B = next(iter(full.values())).shape[0]
        per = B // self.host_count
        lo = self.host_index * per
        return {k: v[lo:lo + per] for k, v in full.items()}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


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
