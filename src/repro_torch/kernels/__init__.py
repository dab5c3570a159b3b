"""CUDA kernels for the memory-controller hot paths, written by hand for
Hopper (``sm_90a``).

Each kernel directory carries ``kernel.py`` (the wrapper: checks, a launch
counter on its ``LIB``, the kernel for CUDA tensors and its plain-torch
version for CPU tensors), ``ops.py`` (the public op) and ``ref.py`` (the
plain-torch oracle); the CUDA sources are ``csrc/*.cu``, built on first
use by ``_build``:

* ``bitonic_sort``   — the scheduler's reordering network (paper Fig. 2)
* ``sorted_gather``  — the row gather behind the scheduled read path
* ``sorted_scatter`` — the run-coalescing row write behind the write path
* ``dma_copy``       — the DMA engine's staged bulk copy (paper §IV-B)
* ``cache_lookup``   — the cache engine's tag/LRU pipeline (paper §IV-A)
* ``flash_attention`` — online-softmax GQA attention, the model's prefill
  (the DMA engine's staging applied to K/V streaming)

Counterpart of ``repro.kernels`` (Pallas, TPU).
"""
