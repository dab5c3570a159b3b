"""Unified memory controller — the data plane of the paper's top-level IP.

``MemoryController`` routes irregular row requests (embedding rows, KV
pages, graph adjacency) through the **scheduler** (batch → stable sort by
row → gather/scatter → unsort) and optionally the **cache engine**
(a pinned hot-row set, kept write-coherent), and bulk/streaming requests
(weight tiles, KV flushes) through the **DMA engine** (``bulk_read`` /
``bulk_write``). Counterpart of the data plane of the reference's
``repro.core.controller`` and of its modeled-timing entry points
(``simulate`` and the four ``modeled_*`` methods), which run the staged
pipeline of ``repro_torch.core.pipeline`` in numpy on the host, and of
its trace capture (``capture``: each data-plane call reports its request
batch into a ``TraceCapture``).

Every path has the value semantics of the naive access (``table[idx]`` /
the in-order write stream), so disabling an engine never changes results,
only performance (ARCHITECTURE §1). The JAX reference is functional, and
so is this API: no method changes the tensors it is given; scatters return
a new table.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import capture as capture_mod
from repro_torch.core import channels as channels_mod
from repro_torch.core import dma_engine, pipeline as pipeline_mod
from repro_torch.core import scatter_util, scheduler
from repro_torch.core.config import MemoryControllerConfig
from repro_torch.core.pipeline import PipelineResult, RequestStream
from repro_torch.core.timing import DDR4_2400, DRAMTimings, SimResult
from repro_torch.kernels.sorted_gather import ops as sg_ops
from repro_torch.kernels.sorted_scatter import ops as ss_ops


def _host(x):
    """A torch tensor (on any device) as its numpy value; anything else
    as it is — the modeled entry points take what the reference's take."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return x


def sorted_gather(table: torch.Tensor, indices: torch.Tensor, *,
                  use_kernels: bool = True) -> torch.Tensor:
    """Scheduler-path gather: reorder requests by row before touching
    device memory. Equivalent to ``table[indices]``; the stable sort
    preserves same-address arrival order (weak consistency rule). With
    ``use_kernels`` the row gather is the sorted-gather kernel."""
    idx_flat = indices.reshape(-1)
    if use_kernels:
        out = sg_ops.sorted_gather(table, idx_flat)
    else:
        _, perm, inv_perm = scheduler.sort_requests(idx_flat,
                                                    use_kernels=False)
        gathered = table.index_select(0, idx_flat.index_select(0, perm))
        out = gathered.index_select(0, inv_perm)
    return out.reshape(*indices.shape, table.shape[-1])


def sorted_scatter(table: torch.Tensor, indices: torch.Tensor,
                   values: torch.Tensor, *, mode: str = "set",
                   use_kernels: bool = True) -> torch.Tensor:
    """Scheduler-path scatter: reorder a WRITE batch by row before memory.

    Value-identical to the in-order write stream: for ``mode="set"`` the
    stable sort keeps same-address arrival order so the last writer wins;
    for ``mode="add"`` each run accumulates in promoted (≥f32) precision
    and rounds to the table dtype once. Each distinct row is written once.
    """
    return ss_ops.sorted_scatter(
        table, indices, values, mode=mode,
        backend="kernel" if use_kernels else "torch")


def scatter_set_last(table: torch.Tensor, idx: torch.Tensor,
                     vals: torch.Tensor) -> torch.Tensor:
    """Deterministic last-writer-wins scatter without sorting.

    ``index_put_`` leaves duplicate-index ordering undefined, so the winner
    of each row is found with a commutative reduction (max of arrival
    stamp), and only winners write; losers target a sacrificial padding
    row.
    """
    n = idx.shape[0]
    stamp = torch.arange(1, n + 1, dtype=torch.int32, device=idx.device)
    winner = torch.zeros(table.shape[0], dtype=torch.int32,
                         device=idx.device).scatter_reduce_(
        0, idx.long(), stamp, "amax")
    is_winner = winner.index_select(0, idx) == stamp
    return scatter_util.masked_row_set(table, idx, vals, is_winner)


@dataclasses.dataclass
class HotRowCache:
    """Cache-engine integration: a pinned hot-row set.

    The ``hot_ids`` rows are pinned at build time (paper §III: "only the
    re-usable data structures are globally cached"); lookups that hit them
    are served from ``hot_data``. Value-identical to ``table[idx]``.
    """

    hot_ids: torch.Tensor     # (H,) sorted unique int32 row ids
    hot_data: torch.Tensor    # (H, d) pinned rows

    @classmethod
    def build(cls, table: torch.Tensor, hot_ids) -> "HotRowCache":
        hot_ids = torch.sort(torch.as_tensor(
            hot_ids, dtype=torch.int32, device=table.device)).values
        return cls(hot_ids=hot_ids, hot_data=table.index_select(0, hot_ids))

    def _positions(self, idx: torch.Tensor):
        """(clipped searchsorted positions, hit mask) of flat ``idx``."""
        pos = torch.searchsorted(self.hot_ids, idx)
        pos = pos.clamp(0, self.hot_ids.shape[0] - 1)
        return pos, self.hot_ids.index_select(0, pos) == idx

    def gather(self, table: torch.Tensor,
               indices: torch.Tensor) -> torch.Tensor:
        idx = indices.reshape(-1)
        from_mem = table.index_select(0, idx)
        # Empty hot set: clipping positions to [0, H-1] would give -1 —
        # there is nothing to hit, so serve everything from memory.
        if self.hot_ids.shape[0] == 0:
            return from_mem.reshape(*indices.shape, table.shape[-1])
        pos, hit = self._positions(idx)
        from_cache = self.hot_data.index_select(0, pos)
        out = torch.where(hit[:, None], from_cache, from_mem)
        return out.reshape(*indices.shape, table.shape[-1])

    def hit_mask(self, indices: torch.Tensor) -> torch.Tensor:
        idx = indices.reshape(-1)
        if self.hot_ids.shape[0] == 0:      # see gather: all-miss
            return torch.zeros(idx.shape, dtype=torch.bool,
                               device=idx.device)
        return self._positions(idx)[1]

    def repin(self, table: torch.Tensor) -> "HotRowCache":
        """Refresh the pinned rows from an updated table (the
        write-allocate rule for the static hot set): after any write to
        ``table``, re-pinning keeps subsequent cached gathers coherent."""
        return HotRowCache(hot_ids=self.hot_ids,
                           hot_data=table.index_select(0, self.hot_ids))


@dataclasses.dataclass
class MemoryController:
    """The configured controller instance handed to models and pipelines.

    ``use_kernels`` routes the scheduler and DMA paths through the port's
    CUDA kernels (their plain versions for CPU tensors). ``device`` is where
    the controller's tensors must lie — every data-plane entry point
    raises ``ValueError`` for a tensor elsewhere, so the CPU runs only when
    a caller asks for it (``device="cpu"``).

    ``device`` governs the data plane only. The modeled-timing entry
    points (``simulate``, ``modeled_*``) are the reference's numpy
    simulator on the host: they take numpy arrays, take a torch tensor on
    any device as its numpy value, and touch no device tensor.
    """

    config: MemoryControllerConfig
    use_kernels: bool = True
    timings: DRAMTimings = dataclasses.field(default_factory=lambda: DDR4_2400)
    device: str | torch.device = "cuda"
    # Opt-in trace recorder (ARCHITECTURE §13). When set, the data-plane
    # entry points below report their request batches into it — values
    # are never touched (``capture=None`` is bit-identical and adds no
    # host sync; with a recorder, the row ids are copied to the host).
    # This field records *only* to itself, never to the ambient
    # ``capture.active_capture()``.
    capture: "capture_mod.TraceCapture | None" = None

    def _record(self, op: str, table: torch.Tensor, row_ids,
                rw: int) -> None:
        if self.capture is None:
            return
        n_rows = int(table.shape[0])
        row_bytes = int(table.shape[-1]) * table.element_size()
        self.capture.record(op, f"table:{n_rows}x{row_bytes}", n_rows,
                            row_bytes, row_ids, rw=rw)

    def _record_bulk(self, op: str, dst: torch.Tensor, nbytes: int, rw: int,
                     offset_bytes: int = 0) -> None:
        if self.capture is None:
            return
        total = dst.numel() * dst.element_size()
        rb = capture_mod.DEFAULT_ROW_BYTES
        pages = max(1, -(-total // rb))
        first = int(offset_bytes) // rb
        count = max(1, -(-int(nbytes) // rb))
        self.capture.record_slice(op, f"bulk:{pages}x{rb}", pages, rb,
                                  first, min(count, pages - first), rw=rw)

    def _on_device(self, *tensors: torch.Tensor) -> None:
        want = torch.device(self.device)
        for t in tensors:
            if t.device.type != want.type or (
                    want.index is not None and t.device.index != want.index):
                raise ValueError(f"tensor on {t.device}, but the controller "
                                 f"runs on {want}")

    # --- cache-line / irregular path ---------------------------------------
    def gather(self, table: torch.Tensor,
               indices: torch.Tensor) -> torch.Tensor:
        self._on_device(table, indices)
        self._record("gather", table, indices, rw=0)
        if self.config.scheduler.enabled:
            return sorted_gather(table, indices, use_kernels=self.use_kernels)
        return table.index_select(0, indices.reshape(-1)).reshape(
            *indices.shape, table.shape[-1])

    def cached_gather(self, table: torch.Tensor, indices: torch.Tensor,
                      cache: HotRowCache) -> torch.Tensor:
        if self.config.cache.enabled:
            self._on_device(table, indices, cache.hot_ids, cache.hot_data)
            self._record("gather", table, indices, rw=0)
            return cache.gather(table, indices)
        return self.gather(table, indices)

    # --- irregular write path ------------------------------------------------
    def scatter(self, table: torch.Tensor, indices: torch.Tensor,
                values: torch.Tensor, *, mode: str = "set") -> torch.Tensor:
        """Irregular row writes (embedding-gradient scatter, KV append).

        Value-identical to the in-order write stream whether or not the
        scheduler reorders the batch: ``mode="set"`` resolves duplicate
        rows last-writer-wins; ``mode="add"`` accumulates in promoted
        (≥f32) precision and rounds to the table dtype once — the values
        are cast to that accumulator, not to the table's dtype, so float32
        gradients into a bf16 table and ``add`` on an int32 table give the
        reference's result on every path.
        """
        if mode not in ("set", "add"):
            raise ValueError(f"mode must be 'set' or 'add', got {mode!r}")
        self._on_device(table, indices, values)
        self._record("scatter", table, indices, rw=1)
        if self.config.scheduler.enabled:
            return sorted_scatter(table, indices, values, mode=mode,
                                  use_kernels=self.use_kernels)
        idx = indices.reshape(-1)
        vals = values.reshape(idx.shape[0], table.shape[-1])
        if mode == "add":
            # Each row's addends summed as one run, in arrival order, and
            # the row written once: the same bits on every call and device
            # (``index_add_`` on CUDA adds duplicates with atomics, in an
            # order that changes from call to call). The stable sort only
            # groups the runs; no kernel runs.
            return sorted_scatter(table, idx, vals, mode="add",
                                  use_kernels=False)
        return scatter_set_last(table, idx, vals)

    def cached_scatter(
        self, table: torch.Tensor, indices: torch.Tensor,
        values: torch.Tensor, cache: HotRowCache, *, mode: str = "set",
    ) -> tuple[torch.Tensor, HotRowCache]:
        """Scatter that keeps a ``HotRowCache`` coherent: the pinned set
        is re-pinned from the updated table (one gather over the hot
        ids). Returns (new_table, new_cache); with the cache engine
        disabled the cache object passes through untouched (and reads
        bypass it, so results are unchanged)."""
        new_table = self.scatter(table, indices, values, mode=mode)
        if self.config.cache.enabled:
            return new_table, cache.repin(new_table)
        return new_table, cache

    # --- bulk path ----------------------------------------------------------
    def bulk_read(self, src: torch.Tensor) -> torch.Tensor:
        """Bulk/streaming read of ``src`` (a weight tile): a copy of it,
        through the DMA engine's staging path when the engine is on."""
        self._on_device(src)
        self._record_bulk("bulk_read", src, src.numel() * src.element_size(),
                          rw=0)
        if self.config.dma.enabled:
            return dma_engine.bulk_copy(src, config=self.config.dma,
                                        use_kernels=self.use_kernels)
        return src.clone(memory_format=torch.contiguous_format)

    def bulk_write(self, dst: torch.Tensor, src: torch.Tensor,
                   *, offset_elems: int = 0) -> torch.Tensor:
        """Bulk/streaming write of ``src`` into ``dst`` (weight tiles,
        activation spills, KV page flushes). Value-identical to writing
        the flat region ``[offset, offset+src.size)`` of a copy of ``dst``
        with ``src`` cast to ``dst``'s dtype; ``dst`` is not changed. A
        region outside ``dst`` raises ``ValueError`` on every path."""
        self._on_device(dst, src)
        if offset_elems < 0 or offset_elems + src.numel() > dst.numel():
            raise ValueError("bulk_write region out of destination bounds")
        item = dst.element_size()
        self._record_bulk("bulk_write", dst, src.numel() * item, rw=1,
                          offset_bytes=offset_elems * item)
        if self.config.dma.enabled:
            return dma_engine.bulk_write(dst, src, config=self.config.dma,
                                         offset_elems=offset_elems,
                                         use_kernels=self.use_kernels)
        out = dst.clone(memory_format=torch.contiguous_format)
        out.view(-1)[offset_elems:offset_elems + src.numel()] = \
            src.reshape(-1).to(dst.dtype)
        return out

    # --- modeled performance (benchmark substrate) ---------------------------
    # Every modeled number below is produced by the staged pipeline
    # (repro_torch.core.pipeline, ARCHITECTURE §7), numpy on the host.
    # ``simulate()`` runs the full composition — arbitration, address
    # mapping, cache filtering, batch scheduling, channel-parallel DRAM
    # service, DMA overlap — and the four ``modeled_*`` entry points are
    # thin wrappers over stage subsets, property-tested bit-identical to
    # their pre-refactor outputs (tests/core/test_pipeline.py).

    def _run(self, stream: RequestStream, *, faults=None, trace=None,
             **stage_kwargs) -> PipelineResult:
        ctx = pipeline_mod.PipelineContext.from_config(self.config,
                                                       self.timings)
        if faults is not None:
            ctx.faults = faults
        ctx.trace = trace
        stages = pipeline_mod.default_stages(ctx, **stage_kwargs)
        return pipeline_mod.run_pipeline(stream, ctx, stages)

    def simulate(
        self, pe_id, row_ids, rw, row_bytes: int,
        *, arbiter_policy: str = "round_robin", weights=None,
        coalesce_writes: bool = False,
        arrival_cycle=None, open_loop: bool | None = None,
        faults=None, trace=None,
    ) -> PipelineResult:
        """Full-pipeline simulation of an irregular row trace — the
        paper's headline composition (cache engine *and* batch scheduler
        *and* multi-channel service together).

        ``pe_id=None`` models a single-port front end (no arbitration);
        otherwise the ``config.num_pes`` per-channel arbiters merge the
        per-PE streams. ``rw=None`` means an all-read trace. Returns a
        :class:`~repro_torch.core.pipeline.PipelineResult` whose per-stage
        breakdown sums to ``makespan_fpga_cycles``; the legacy
        DRAM-only view is ``.as_channel_result()``.

        ``config.dram_sched`` selects each channel interface's DRAM
        *command* scheduler (fifo / frfcfs / frfcfs_cap + refresh,
        ARCHITECTURE §8): the default FIFO window-1 model is
        bit-identical to the earlier in-order service stage, pinned by the
        golden-trace suite (``tests/core/test_golden_pipeline.py``).

        ``arrival_cycle`` (per-request FPGA-cycle stamps) switches the
        run to *open-loop serving* (ARCHITECTURE §9): no request is
        granted or issued before it arrives, per-channel idle gaps
        advance the clock, and the result's ``.serving`` reports
        per-request sojourn times with p50/p95/p99 and sustained
        throughput. Serving runs the drop-free stage subset (no cache
        filter, no batch scheduler — both retire the per-request
        identity sojourn accounting needs). With all stamps zero the
        serving datapath is bit-identical to the closed-loop pipeline
        (property-tested); ``open_loop`` forces the mode explicitly.

        ``faults`` overrides ``config.faults`` for this run (RAS layer,
        ARCHITECTURE §10): error injection, ECC/CRC handling, bounded
        replay with backoff, outage windows and graceful degradation —
        the result then carries a ``.fault`` stats block (and, open
        loop, per-request ``.dropped`` flags). ``None`` inherits the
        config; an inactive :class:`~repro_torch.core.config.FaultConfig` is
        bit-identical to no fault layer at all (property-tested).

        ``trace`` (a :class:`~repro_torch.core.telemetry.TraceRecorder`)
        opts into per-request lifecycle tracing (ARCHITECTURE §11):
        every stage emits its events into the recorder — arrivals,
        grants, cache verdicts, batch ids, reorder-window entries,
        per-attempt DRAM issues, replays, completions, plus channel
        timeline events — for the Perfetto exporter
        (``repro_torch.launch.tracing``) and the cycle-attribution report
        (``repro_torch.core.telemetry.CycleAttribution``). ``trace=None``
        leaves every code path bit-identical.

        Raises ``ValueError`` on an empty trace — a zero-request
        simulation is almost always an upstream bug (an over-filtered
        trace or a bad selection), so it fails loudly here instead of
        returning an all-zero result that silently poisons derived
        bandwidth/latency numbers. Callers that genuinely want the
        degenerate run can build it from the pipeline primitives
        (``RequestStream.from_rows`` + ``run_pipeline``).
        """
        stream = RequestStream.from_rows(
            _host(row_ids), _host(rw), row_bytes=row_bytes,
            pe_id=_host(pe_id), arrival_cycle=_host(arrival_cycle))
        if len(stream) == 0:
            raise ValueError(
                "simulate() got an empty trace (0 requests) — refusing "
                "to report an all-zero result; check the upstream trace "
                "generation/filtering (use the pipeline primitives "
                "directly if a degenerate empty run is intended)")
        ports = self.config.num_pes if pe_id is not None else None
        serving = open_loop if open_loop is not None else \
            stream.has_arrivals
        if serving:
            ctx = pipeline_mod.PipelineContext.from_config(self.config,
                                                           self.timings)
            ctx.scheduler = None
            ctx.open_loop = True
            if faults is not None:
                ctx.faults = faults
            ctx.trace = trace
            stages = pipeline_mod.default_stages(
                ctx, ports=ports, arbiter_policy=arbiter_policy,
                weights=weights, cache=False)
            return pipeline_mod.run_pipeline(stream, ctx, stages)
        return self._run(
            stream,
            ports=ports, faults=faults, trace=trace,
            arbiter_policy=arbiter_policy, weights=weights,
            cache=True, coalesce_writes=coalesce_writes)

    def modeled_gather_time(
        self, row_ids: np.ndarray, row_bytes: int
    ) -> SimResult:
        """Modeled DRAM access time for an irregular read-only row trace,
        after the controller's scheduling policy is applied (Fig. 7
        methodology). Pipeline subset: AddressMap → BatchScheduler →
        DRAMService — so a multi-channel config reports the channel
        makespan here too (it used to fall back to single-channel
        numbers); ``num_channels=1`` is bit-identical to the seed
        ``schedule_trace`` + ``simulate_dram_access`` composition."""
        stream = RequestStream.from_rows(_host(row_ids), row_bytes=row_bytes)
        return self._run(stream, cache=False).as_sim_result()

    def modeled_access_time(
        self, row_ids: np.ndarray, rw: np.ndarray, row_bytes: int,
        *, coalesce_writes: bool = False,
    ) -> SimResult:
        """Modeled DRAM time for a mixed read/write row trace: the
        scheduler forms single-type batches and row-sorts each, then the
        stream is costed with open-row state *and* bus-turnaround
        penalties (the Fig. 7 methodology extended to writes).
        ``coalesce_writes`` also models per-batch VMEM write coalescing
        (what the sorted_scatter data plane does; fig7w uses it).

        The trace is first decomposed by the configured
        :class:`~repro_torch.core.channels.AddressMap`; each channel schedules
        and services its share independently, and the returned
        ``total_fpga_cycles`` is the multi-channel *makespan* (slowest
        channel). At ``num_channels=1`` the map is the identity and this
        is exactly the paper's single-interface pipeline (bit-identical:
        ``test_single_channel_matches_plain_simulator``). See
        :meth:`modeled_channel_access_time` for the full per-channel
        breakdown."""
        return self.modeled_channel_access_time(
            row_ids, rw, row_bytes,
            coalesce_writes=coalesce_writes).as_sim_result()

    def modeled_channel_access_time(
        self, row_ids: np.ndarray, rw: np.ndarray, row_bytes: int,
        *, coalesce_writes: bool = False,
    ) -> channels_mod.ChannelSimResult:
        """Multi-channel view of :meth:`modeled_access_time`: the
        configured AddressMap splits the trace, each channel runs its
        own scheduler front end + open-row simulation, and the result
        carries makespan, per-channel occupancy and hit counts.
        Pipeline subset: AddressMap → BatchScheduler → DRAMService."""
        stream = RequestStream.from_rows(_host(row_ids), _host(rw),
                                         row_bytes=row_bytes)
        return self._run(
            stream, cache=False,
            coalesce_writes=coalesce_writes).as_channel_result()

    def modeled_multiport_access_time(
        self, pe_id: np.ndarray, row_ids: np.ndarray, rw: np.ndarray,
        row_bytes: int, *, policy: str = "round_robin",
        weights=None, coalesce_writes: bool = False,
    ) -> channels_mod.ChannelSimResult:
        """Modeled completion time when ``config.num_pes`` ports contend
        for the channels: per-PE streams are merged by the per-channel
        arbiters (round_robin / priority / weighted), scheduled, and
        serviced channel-parallel. The result's ``port_stats`` report
        per-port grants, stall slots and Jain fairness. Pipeline subset:
        AddressMap → PortArbiter → BatchScheduler → DRAMService."""
        stream = RequestStream.from_rows(_host(row_ids), _host(rw),
                                         row_bytes=row_bytes,
                                         pe_id=_host(pe_id))
        return self._run(
            stream, ports=self.config.num_pes, arbiter_policy=policy,
            weights=weights, cache=False,
            coalesce_writes=coalesce_writes).as_channel_result()
