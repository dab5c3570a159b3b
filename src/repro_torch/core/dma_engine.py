"""DMA engine — parallel bulk transfers (paper §IV-B).

The FPGA DMA engine owns N buffers, each servicing one in-flight bulk
transfer; FLITs of a transfer accumulate in a buffer until the transfer is
complete, then the external access is issued. On the GPU the analogue is a
ring of shared-memory staging slots fed by asynchronous copies:
``num_parallel_dma`` copies of a ``max_transaction_bytes`` transaction in
flight, overlapping transfer with drain. This module plans transfers
(control plane) and executes them (data plane: the ``dma_copy`` kernel, or
its plain version). Counterpart of ``repro.core.dma_engine``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.config import DMAConfig
from repro_torch.core.timing import DDR4_2400, DRAMTimings
from repro_torch.kernels.dma_copy import ops as dma_ops


@dataclasses.dataclass(frozen=True)
class TransferPlan:
    """One bulk transfer split into channel-assigned transactions."""

    channel: np.ndarray      # (num_txn,) channel id
    offset: np.ndarray       # (num_txn,) byte offset
    size: np.ndarray         # (num_txn,) byte size
    total_bytes: int

    @property
    def num_transactions(self) -> int:
        return int(self.offset.shape[0])


def plan_transfer(total_bytes: int, config: DMAConfig) -> TransferPlan:
    """Split ``total_bytes`` into <=max_transaction chunks round-robined
    over the parallel DMA channels (the DMA Request Mapper's job)."""
    if total_bytes <= 0:
        raise ValueError("transfer must move at least one byte")
    txn = config.max_transaction_bytes
    offsets = np.arange(0, total_bytes, txn, dtype=np.int64)
    sizes = np.minimum(txn, total_bytes - offsets).astype(np.int64)
    channels = (np.arange(offsets.shape[0]) % config.num_parallel_dma
                ).astype(np.int32)
    return TransferPlan(channel=channels, offset=offsets, size=sizes,
                        total_bytes=total_bytes)


def modeled_transfer_cycles(
    plan: TransferPlan,
    config: DMAConfig,
    timings: DRAMTimings = DDR4_2400,
) -> float:
    """Modeled FPGA cycles for a planned transfer (feeds Fig. 5/8 benches).

    Each transaction streams sequentially (one row activation plus
    row-buffer-hit bursts); channels overlap ideally up to the DRAM's
    single-device bandwidth, which we honor by only overlapping the
    activation latency, not the burst streaming.
    """
    bursts = np.ceil(plan.size / timings.burst_bytes)
    act = (timings.t_rcd + timings.t_cl) * timings.clock_ratio
    stream = bursts * timings.t_burst * timings.clock_ratio
    per_channel_act = np.zeros(config.num_parallel_dma)
    for ch, _ in zip(plan.channel, plan.size):
        per_channel_act[ch] += act
    return float(per_channel_act.max() + stream.sum())


def bulk_copy(src: torch.Tensor, *, config: DMAConfig,
              use_kernels: bool = False) -> torch.Tensor:
    """Bulk-read ``src`` through the DMA staging path.

    With ``use_kernels`` the ``dma_copy`` kernel runs (its plain version
    for a CPU tensor); otherwise a plain copy. Returns a fresh copy of
    ``src`` — the value-level identity is what makes the engine droppable
    into any model (enable/disable is purely a performance decision).
    """
    if use_kernels:
        return dma_ops.dma_copy(src, config=config)
    return src.clone(memory_format=torch.contiguous_format)


def bulk_write(dst: torch.Tensor, src: torch.Tensor, *, config: DMAConfig,
               offset_elems: int = 0,
               use_kernels: bool = False) -> torch.Tensor:
    """Bulk-write ``src`` into a copy of ``dst`` (flat offset) through the
    DMA path.

    Write-side twin of :func:`bulk_copy`: ``src`` is cast to ``dst``'s
    dtype, then staged chunk by chunk into the flat region
    ``[offset_elems, offset_elems + src.numel())`` of a clone of ``dst``,
    which is returned — value-identical to
    ``dst.flat[offset:offset+src.size] = src``, so the engine can be
    toggled without changing results. ``dst`` is not changed. A region
    outside ``dst`` raises ``ValueError``.
    """
    src_flat = src.reshape(-1).to(dst.dtype)
    n = src_flat.shape[0]
    if offset_elems < 0 or offset_elems + n > dst.numel():
        raise ValueError("bulk_write region out of destination bounds")
    out = dst.clone(memory_format=torch.contiguous_format)
    region = out.view(-1)[offset_elems:offset_elems + n]
    if use_kernels:
        dma_ops.dma_copy(src_flat, config=config, out=region)
    else:
        region.copy_(src_flat)
    return out


def channel_vmem_bytes(config: DMAConfig) -> int:
    """Staging memory claimed by the engine (double-buffered, per channel)
    — the analogue of Fig. 5's URAM series; VMEM on the TPU, shared memory
    on Hopper. The name is the reference's."""
    return 2 * config.num_parallel_dma * config.buffer_bytes
