"""Serving driver: the memory-controller scheduler applied to requests.

Counterpart of ``repro.launch.serve``. The paper's scheduler batches
memory requests under (batch_size, timeout) bounds before servicing them;
this driver applies the identical policy to *inference requests*: arrivals
accumulate into a prefill batch until the batch is full or the timeout
expires (``core.scheduler.form_batches``), then the batch is prefilled and
decoded in lockstep (greedy). Prefill attention is kernel B6 on the GPU,
and the embedding lookups of prefill and decode go through the
scheduler's sort (B1) and row gather (B2).

Each served batch also drives the *modeled* memory system: the KV-cache
access stream of prefill + lockstep decode (``kv_trace``) is replayed
through ``MemoryController.simulate`` (numpy on the host), so a serve run
reports modeled p50/p95/p99 memory sojourn per tenant next to the
functional outputs (``model_memory``); with ``slo_cycles`` also each
tenant's SLO attainment and the attribution component to blame.

On a device mesh (``Server(arch, mesh=mesh)``) the weights are DTensors
laid out by ``param_specs`` under the serving rules
(``models.sharding.serving_weight_overrides`` for the scheduler's batch
size), the cache by ``cache_specs``, and each prompt batch's rows split
over the data axes; a batch must split evenly over them.

Demo: ``python -m repro_torch.launch.serve --arch yi-34b --smoke
--device cpu`` (the default device is the GPU).
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.core.config import MemoryControllerConfig, SchedulerConfig
from repro_torch.core.controller import MemoryController
from repro_torch.core.scheduler import form_batches
from repro_torch.models.lm import build_lm
from repro_torch.models.sharding import full, serving_weight_overrides

#: KV page granularity of the modeled access stream (bytes per token row)
KV_PAGE_BYTES = 256


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray          # (S,) int32
    max_new_tokens: int = 16
    arrival_cycle: int = 0
    tenant: int = 0             # controller port this request issues from
    output: Optional[List[int]] = None


@dataclasses.dataclass
class ServeStats:
    batches: int = 0
    requests: int = 0
    decode_steps: int = 0
    prefill_tokens: int = 0
    wall_s: float = 0.0
    # Host-clock seconds in prefill (until its first tokens reach the host)
    # and in the decode steps after it; every step ends in a host read of
    # its tokens, so both include the device's work.
    prefill_s: float = 0.0
    decode_s: float = 0.0
    # modeled memory-system latency (FPGA cycles) of the KV access stream
    modeled_p50_cycles: float = 0.0
    modeled_p95_cycles: float = 0.0
    modeled_p99_cycles: float = 0.0
    modeled_makespan_cycles: float = 0.0
    modeled_per_tenant: Dict[int, dict] = dataclasses.field(
        default_factory=dict)
    # per-tenant SLO attainment + cycle-attribution blame (populated
    # only when the server was built with ``slo_cycles``): tenant ->
    # {n, attainment, violations, dominant_blame} where dominant_blame
    # is the attribution component (telemetry.COMPONENTS) contributing
    # the most cycles to that tenant's violating requests.
    modeled_slo_attainment: Dict[int, dict] = dataclasses.field(
        default_factory=dict)


class Server:
    """Batched prefill + lockstep decode with scheduler-based admission.

    Params are drawn on ``device`` from ``torch.Generator(device)`` seeded
    0 (on a ``mesh``, the same values, each rank keeping its shards).
    ``mem``, ``arb_policy``, ``arb_weights`` and ``slo_cycles`` set the
    modeled-memory replay (``model_memory``); ``decode_interval_cycles``
    spaces ``kv_trace``.
    """

    def __init__(self, arch: str, *, smoke: bool = False, mesh=None,
                 sched: SchedulerConfig | None = None,
                 mem: MemoryControllerConfig | None = None,
                 arb_policy: str = "round_robin",
                 arb_weights=None,
                 decode_interval_cycles: int = 64,
                 slo_cycles: float | None = None,
                 device: str | torch.device = "cuda"):
        self.cfg = get_arch(arch, smoke=smoke)
        if self.cfg.family == "encoder":
            raise ValueError("encoder-only architectures do not decode")
        self.device = torch.device(mesh.device_type if mesh is not None
                                   else device)
        self.sched = sched or SchedulerConfig(batch_size=8, timeout_cycles=32)
        self.lm = build_lm(self.cfg, mesh, global_batch=self.sched.batch_size,
                           device=self.device)
        overrides = serving_weight_overrides(self.cfg, self.sched.batch_size,
                                             mesh)
        if overrides:
            self.lm.rules = dataclasses.replace(self.lm.rules, **overrides)
        self.controller = MemoryController(mem or MemoryControllerConfig(),
                                           device=self.device)
        self.arb_policy = arb_policy
        self.arb_weights = arb_weights
        self.decode_interval_cycles = int(decode_interval_cycles)
        #: modeled per-request sojourn SLO (FPGA cycles). Setting it
        #: turns on lifecycle tracing of the KV replay so the serve
        #: stats carry per-tenant attainment + attribution blame.
        self.slo_cycles = None if slo_cycles is None else float(slo_cycles)
        self.params = self.lm.init(
            torch.Generator(self.device).manual_seed(0))

    def admit(self, requests: List[Request]) -> List[List[Request]]:
        """Scheduler-policy batch formation over the arrival stream."""
        if not requests:
            return []
        batches = form_batches(
            addrs=[r.rid for r in requests],
            rw=[0] * len(requests),
            arrival_cycle=[r.arrival_cycle for r in requests],
            config=self.sched)
        by_id = {r.rid: r for r in requests}
        return [[by_id[int(a)] for a in b.addr] for b in batches]

    def run_batch(self, batch: List[Request], stats: ServeStats) -> None:
        S = max(len(r.prompt) for r in batch)
        prompts = np.stack([np.pad(r.prompt, (S - len(r.prompt), 0))
                            for r in batch])     # left-pad to align ends
        max_new = max(r.max_new_tokens for r in batch)
        max_len = S + max_new + 8
        t0 = time.perf_counter()
        logits, cache, cur = self.lm.prefill(
            self.params, {"tokens": torch.from_numpy(prompts).to(
                self.device)}, max_len)
        stats.prefill_tokens += int(prompts.size)
        outs = [[] for _ in batch]
        tok = torch.argmax(full(logits), dim=-1).to(torch.int32)
        for step in range(max_new):
            host = tok.tolist()          # the step's one host sync
            if step == 0:
                t1 = time.perf_counter()
                stats.prefill_s += t1 - t0
            for i, r in enumerate(batch):
                if step < r.max_new_tokens:
                    outs[i].append(host[i])
            logits, cache = self.lm.decode_step(self.params, tok, cache, cur)
            cur += 1
            tok = torch.argmax(full(logits), dim=-1).to(torch.int32)
            stats.decode_steps += 1
        if max_new:
            tok.tolist()
            stats.decode_s += time.perf_counter() - t1
        for r, o in zip(batch, outs):
            r.output = o
        stats.batches += 1
        stats.requests += len(batch)

    def kv_trace(self, batches: List[List[Request]]):
        """Modeled KV-cache access stream of the batched-decode plan.

        Per batch: prefill appends every prompt token's KV page at the
        admission instant (the batch's last arrival); each lockstep
        decode step ``s`` then appends the new token's page and reads
        the latest context page plus one strided cold page,
        ``decode_interval_cycles`` apart. Requests keep their tenant as
        the controller port. Returns ``(pe_id, rows, rw, arrival_cycle)``
        in arrival order.
        """
        pe: List[int] = []
        rows: List[int] = []
        rw: List[int] = []
        arr: List[float] = []

        def emit(r, row, is_write, t):
            pe.append(r.tenant)
            rows.append(row)
            rw.append(is_write)
            arr.append(t)

        for batch in batches:
            base = float(max(r.arrival_cycle for r in batch))
            for r in batch:
                s0 = len(r.prompt)
                kv0 = r.rid * (s0 + r.max_new_tokens + 8)
                for p in range(s0):         # prefill: write prompt KV
                    emit(r, kv0 + p, 1, base)
                for s in range(r.max_new_tokens):
                    t = base + (s + 1) * self.decode_interval_cycles
                    emit(r, kv0 + s0 + s, 1, t)        # append new page
                    emit(r, kv0 + s0 + s - 1, 0, t)    # latest context
                    emit(r, kv0 + (s * 7) % max(1, s0), 0, t)  # cold page
        order = np.argsort(np.asarray(arr, np.float64), kind="stable")
        return (np.asarray(pe, np.int64)[order],
                np.asarray(rows, np.int64)[order],
                np.asarray(rw, np.int32)[order],
                np.asarray(arr, np.float64)[order])

    def model_memory(self, batches: List[List[Request]],
                     stats: ServeStats) -> None:
        """Replay the KV stream through the memory controller's
        open-loop serving pipeline and record modeled latency.

        With ``slo_cycles`` set, the replay runs under a
        :class:`~repro_torch.core.telemetry.TraceRecorder` and each
        tenant's SLO attainment is attributed: violating requests'
        sojourns are decomposed
        (:class:`~repro_torch.core.telemetry.CycleAttribution`) and the
        dominant component — the answer to "*why* is this tenant missing
        its SLO" (arbitration starvation vs reorder slip vs refresh vs
        replay ...) — lands in the stats.
        """
        pe, rows, rw, arr = self.kv_trace(batches)
        if rows.size == 0:
            return
        trace = None
        if self.slo_cycles is not None:
            from repro_torch.core.telemetry import TraceRecorder
            trace = TraceRecorder()
        res = self.controller.simulate(
            pe, rows, rw, KV_PAGE_BYTES,
            arbiter_policy=self.arb_policy, weights=self.arb_weights,
            arrival_cycle=arr, open_loop=True, trace=trace)
        s = res.serving
        stats.modeled_p50_cycles = s.p50_sojourn
        stats.modeled_p95_cycles = s.p95_sojourn
        stats.modeled_p99_cycles = s.p99_sojourn
        stats.modeled_makespan_cycles = res.makespan_fpga_cycles
        stats.modeled_per_tenant = s.per_port
        if trace is not None:
            from repro_torch.core.telemetry import CycleAttribution
            att = CycleAttribution.from_pipeline(res, trace)
            for p in np.unique(att.pe_id):
                m = att.pe_id == p
                viol = m & (att.sojourn > self.slo_cycles)
                blame = None
                if viol.any():
                    blame = max(
                        ((k, float(v[viol].sum()))
                         for k, v in att.components.items()),
                        key=lambda kv: kv[1])[0]
                stats.modeled_slo_attainment[int(p)] = {
                    "n": int(m.sum()),
                    "violations": int(viol.sum()),
                    "attainment": float(1.0 - viol.sum() / m.sum()),
                    "dominant_blame": blame,
                }

    def serve(self, requests: List[Request]) -> ServeStats:
        stats = ServeStats()
        t0 = time.perf_counter()
        batches = self.admit(requests)
        for batch in batches:
            self.run_batch(batch, stats)
        self.model_memory(batches, stats)
        stats.wall_s = time.perf_counter() - t0
        return stats


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-34b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--slo-cycles", type=float, default=None,
                    help="modeled sojourn SLO; turns on per-tenant "
                         "attainment attribution")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default: the GPU)")
    args = ap.parse_args()

    server = Server(args.arch, smoke=args.smoke,
                    slo_cycles=args.slo_cycles, device=args.device)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i,
                    prompt=rng.integers(
                        0, server.cfg.vocab_size, args.prompt_len
                    ).astype(np.int32),
                    max_new_tokens=args.new_tokens,
                    arrival_cycle=i * 3)
            for i in range(args.requests)]
    stats = server.serve(reqs)
    print(f"[serve] {stats.requests} requests in {stats.batches} batches, "
          f"{stats.decode_steps} decode steps, "
          f"{stats.prefill_tokens} prefill tokens, {stats.wall_s:.1f}s "
          f"on {server.device} (prefill {stats.prefill_s:.3f}s, decode "
          f"{stats.decode_s:.3f}s)")
    print(f"[serve] modeled KV latency (FPGA cycles): "
          f"p50={stats.modeled_p50_cycles:.1f} "
          f"p95={stats.modeled_p95_cycles:.1f} "
          f"p99={stats.modeled_p99_cycles:.1f}")
    for p, rec in sorted(stats.modeled_slo_attainment.items()):
        print(f"[serve] tenant {p}: SLO attainment "
              f"{100 * rec['attainment']:.1f}% "
              f"({rec['violations']}/{rec['n']} violations, "
              f"blame={rec['dominant_blame']})")
    print(f"[serve] sample output: {reqs[0].output}")


if __name__ == "__main__":
    main()
