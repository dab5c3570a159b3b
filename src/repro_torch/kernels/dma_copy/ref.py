"""Oracle for dma_copy: the identity copy."""

import torch


def dma_copy_ref(src: torch.Tensor) -> torch.Tensor:
    return src.clone()
