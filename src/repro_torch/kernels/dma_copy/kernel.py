"""DMA copy — the DMA engine's data plane (paper §IV-B).

``staged_copy(dst, src, chunk_elems=..., channels=...)`` writes the flat
payload ``src`` into ``dst`` chunk by chunk through ``channels`` staging
slots, the paper's parallel DMA buffers. On a CUDA tensor it launches a
kernel of ``csrc/dma_copy.cu``, chosen there by alignment: a ring of TMA
bulk copies where both addresses, the chunk and the total are 16-byte
aligned, cp.async otherwise (up to ``channels`` copies in flight either
way, the ragged last chunk masked); on a CPU tensor it runs
``staged_copy_plain``, ``dst.copy_(src)``: the staging changes no value.
Counterpart of ``repro.kernels.dma_copy.kernel``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels._build import I32, I64, P, CudaLibrary

LIB = CudaLibrary("dma_copy", {"dma_copy": (P, P, I64, I64, I32, I32, P)})
MAX_CHANNELS = 8


def staged_copy_plain(dst: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    return dst.copy_(src)


def _overlap(a: torch.Tensor, b: torch.Tensor) -> bool:
    a0, b0 = a.data_ptr(), b.data_ptr()
    return a0 < b0 + b.numel() * b.element_size() and \
        b0 < a0 + a.numel() * a.element_size()


def staged_copy(dst: torch.Tensor, src: torch.Tensor, *, chunk_elems: int,
                channels: int) -> torch.Tensor:
    """Copy ``src`` into ``dst`` in place and return ``dst``.

    Both are 1-D, contiguous, of one dtype (any: the kernel copies bytes),
    one size and one device, and do not overlap; ``chunk_elems >= 1`` and
    ``1 <= channels <= 8``. Anything else raises ``ValueError``.
    """
    if dst.device != src.device:
        raise ValueError(f"dst on {dst.device}, src on {src.device}")
    if dst.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {dst.device}")
    if dst.ndim != 1 or src.ndim != 1 or not dst.is_contiguous() \
            or not src.is_contiguous():
        raise ValueError("dst and src must be contiguous 1-D tensors")
    if dst.dtype != src.dtype or dst.shape != src.shape:
        raise ValueError(f"dst {dst.dtype} {tuple(dst.shape)} != src "
                         f"{src.dtype} {tuple(src.shape)}")
    if chunk_elems < 1 or not 1 <= channels <= MAX_CHANNELS:
        raise ValueError(f"chunk_elems={chunk_elems}, channels={channels}: "
                         f"need chunk_elems >= 1, 1 <= channels <= "
                         f"{MAX_CHANNELS}")
    if src.numel() and _overlap(dst, src):
        raise ValueError("dst and src overlap")
    if dst.device.type == "cpu":
        return staged_copy_plain(dst, src)
    if src.numel() == 0:
        return dst
    item = src.element_size()
    LIB.launch("dma_copy", dst.data_ptr(), src.data_ptr(), src.numel() * item,
               chunk_elems * item, channels, dst.device.index,
               torch.cuda.current_stream(dst.device).cuda_stream)
    return dst
