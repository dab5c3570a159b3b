"""Unified memory controller — the data plane of the paper's top-level IP.

``MemoryController`` routes irregular row requests (embedding rows, KV
pages, graph adjacency) through the **scheduler** (batch → stable sort by
row → gather/scatter → unsort) and optionally the **cache engine**
(a pinned hot-row set, kept write-coherent), and bulk/streaming requests
(weight tiles, KV flushes) through the **DMA engine** (``bulk_read`` /
``bulk_write``). Counterpart of the data plane of
``repro.core.controller``; trace capture and the modeled-timing entry
points come in later slices of the port.

Every path has the value semantics of the naive access (``table[idx]`` /
the in-order write stream), so disabling an engine never changes results,
only performance (ARCHITECTURE §1). The JAX reference is functional, and
so is this API: no method changes the tensors it is given; scatters return
a new table.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import dma_engine, scatter_util, scheduler
from repro_torch.core.config import MemoryControllerConfig
from repro_torch.core.timing import DDR4_2400, DRAMTimings
from repro_torch.kernels.sorted_gather import ops as sg_ops
from repro_torch.kernels.sorted_scatter import ops as ss_ops


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
    the controller's tensors must lie — every entry point raises
    ``ValueError`` for a tensor elsewhere, so the CPU runs only when a
    caller asks for it (``device="cpu"``).
    """

    config: MemoryControllerConfig
    use_kernels: bool = True
    timings: DRAMTimings = dataclasses.field(default_factory=lambda: DDR4_2400)
    device: str | torch.device = "cuda"

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
        if self.config.scheduler.enabled:
            return sorted_gather(table, indices, use_kernels=self.use_kernels)
        return table.index_select(0, indices.reshape(-1)).reshape(
            *indices.shape, table.shape[-1])

    def cached_gather(self, table: torch.Tensor, indices: torch.Tensor,
                      cache: HotRowCache) -> torch.Tensor:
        if self.config.cache.enabled:
            self._on_device(table, indices, cache.hot_ids, cache.hot_data)
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
        if self.config.dma.enabled:
            return dma_engine.bulk_write(dst, src, config=self.config.dma,
                                         offset_elems=offset_elems,
                                         use_kernels=self.use_kernels)
        out = dst.clone(memory_format=torch.contiguous_format)
        out.view(-1)[offset_elems:offset_elems + src.numel()] = \
            src.reshape(-1).to(dst.dtype)
        return out
