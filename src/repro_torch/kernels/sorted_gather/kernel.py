"""Sorted-gather — the scheduler's locality payoff.

``gather_rows(table, sorted_idx)`` returns ``table[sorted_idx]``. On a
CUDA tensor it launches the kernel of ``csrc/sorted_gather.cu``: each
block owns a span of consecutive slots, reads each run's row once into
shared memory and stores it to every slot of the run (TMA bulk stores
where the row pitch and both bases are 16-byte aligned); on a CPU tensor
it runs ``gather_rows_plain``, an ``index_select``. Counterpart of
``repro.kernels.sorted_gather.kernel``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels._build import I64, P, CudaLibrary

LIB = CudaLibrary("sorted_gather", {"gather_rows": (P, P, P, I64, I64, P)})


def check_index_kind(idx: torch.Tensor) -> None:
    """Raise ``ValueError`` unless ``idx`` is a 1-D int32 or int64 tensor
    (no device sync)."""
    if idx.ndim != 1 or idx.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"indices must be 1-D int32 or int64, got "
                         f"{idx.dtype} of shape {tuple(idx.shape)}")


def check_row_indices(idx: torch.Tensor, n_rows: int) -> None:
    """Raise ``ValueError`` unless ``idx`` is a 1-D integer tensor with
    every entry in ``[0, n_rows)`` — one device sync. The reference's
    ``jnp.take`` would instead fill rows past the end with NaN and wrap
    negative indices; the port's contract is in-range indices."""
    check_index_kind(idx)
    if idx.numel() and idx.device.type != "meta":   # meta holds no ids
        lo, hi = torch.stack(torch.aminmax(idx)).tolist()
        if lo < 0 or hi >= n_rows:
            raise ValueError(f"row index range [{lo}, {hi}] outside "
                             f"[0, {n_rows})")


def gather_rows_plain(table: torch.Tensor,
                      sorted_idx: torch.Tensor) -> torch.Tensor:
    return table.index_select(0, sorted_idx)


def gather_rows(table: torch.Tensor, sorted_idx: torch.Tensor) -> torch.Tensor:
    """Gather ``table[sorted_idx]`` from a contiguous 2-D table; callers
    pass sorted indices for locality (unsorted input is still correct).
    CPU and ``meta`` tensors take the plain version.
    Raises ``ValueError`` on an index outside ``[0, R)``, a device
    mismatch or a non-contiguous table."""
    if table.ndim != 2 or not table.is_contiguous():
        raise ValueError("table must be a contiguous 2-D tensor")
    if sorted_idx.device != table.device:
        raise ValueError(f"indices on {sorted_idx.device}, table on "
                         f"{table.device}")
    if table.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"no kernel for device {table.device}")
    check_row_indices(sorted_idx, table.shape[0])
    n = sorted_idx.shape[0]
    if table.device.type in ("cpu", "meta"):
        return gather_rows_plain(table, sorted_idx)
    if n >= 1 << 31:
        raise ValueError(f"{n} indices exceed the kernel's grid")
    out = table.new_empty((n, table.shape[1]))
    if n == 0:
        return out
    idx32 = sorted_idx.to(torch.int32).contiguous()
    LIB.launch("gather_rows", table.data_ptr(), idx32.data_ptr(),
               out.data_ptr(), n, table.shape[1] * table.element_size(),
               torch.cuda.current_stream(table.device).cuda_stream)
    return out
