"""Bitonic sorting network — the scheduler's reordering engine (paper Fig. 2).

``bitonic_sort_batched`` sorts each row of ``(G, N)`` int32 keys with an
int32 payload, comparing ``(key, arrival_id)`` so the network is a total
order and equals a stable sort. On a CUDA tensor it launches the kernel of
``csrc/bitonic_sort.cu`` (one launch per network stage); on a CPU tensor
it runs ``sort_network``, the same network as a loop of reshapes and
``torch.where``s. Counterpart of ``repro.kernels.bitonic_sort.kernel``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels._build import I32, P, CudaLibrary

LIB = CudaLibrary("bitonic_sort", {"bitonic_sort_rows": (P, P, P, I32, I32, P)})


def _compare_exchange(keys, ids, vals, j_exp: int, k_exp: int):
    """One network stage on (G, N) rows: stride 2^j_exp within direction
    blocks of 2^k_exp."""
    g, n = keys.shape
    j = 1 << j_exp
    shape = (g, n // (2 * j), 2, j)

    def split(x):
        return x.reshape(shape).unbind(2)

    ka, kb = split(keys)
    ia, ib = split(ids)
    va, vb = split(vals)
    # Direction of the sub-block each pair lives in: the pair's first slot
    # is c*2j + t; its K-block is (c*2j) >> k_exp.
    c = torch.arange(shape[1], device=keys.device).view(1, -1, 1)
    ascending = ((c * 2 * j) >> k_exp) % 2 == 0
    gt = (ka > kb) | ((ka == kb) & (ia > ib))   # composite (key, id) order
    swap = torch.where(ascending, gt, ~gt)

    def merge(a, b):
        lo = torch.where(swap, b, a)
        hi = torch.where(swap, a, b)
        return torch.stack([lo, hi], dim=2).reshape(g, n)

    return merge(ka, kb), merge(ia, ib), merge(va, vb)


def sort_network(keys, ids, vals):
    """The plain network on (G, N) rows, N a power of two."""
    n = keys.shape[-1]
    m = n.bit_length() - 1
    for k_exp in range(1, m + 1):
        for j_exp in range(k_exp - 1, -1, -1):
            keys, ids, vals = _compare_exchange(keys, ids, vals, j_exp, k_exp)
    return keys, ids, vals


def bitonic_sort_batched(keys: torch.Tensor, vals: torch.Tensor):
    """Sort each row of ``keys (G, N)`` with payload ``vals``; returns
    (sorted_keys, perm, sorted_vals), all int32.

    Both inputs are contiguous int32 tensors of one shape on one device,
    and N is a power of two >= 2; anything else raises ``ValueError``.
    """
    if keys.dtype != torch.int32 or vals.dtype != torch.int32:
        raise ValueError(f"keys and vals must be int32, got {keys.dtype} "
                         f"and {vals.dtype}")
    if keys.ndim != 2 or keys.shape != vals.shape:
        raise ValueError(f"keys {tuple(keys.shape)} and vals "
                         f"{tuple(vals.shape)} must be one (G, N) shape")
    g, n = keys.shape
    if n < 2 or n & (n - 1):
        raise ValueError(f"row length {n} must be a power of two >= 2")
    if keys.device != vals.device:
        raise ValueError(f"keys on {keys.device}, vals on {vals.device}")
    if not (keys.is_contiguous() and vals.is_contiguous()):
        raise ValueError("keys and vals must be contiguous")
    if keys.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {keys.device}")
    ids = torch.arange(n, dtype=torch.int32,
                       device=keys.device).expand(g, n).contiguous()
    if keys.device.type == "cpu":
        return sort_network(keys, ids, vals)
    if g * n >= 1 << 31:
        raise ValueError(f"{g} x {n} keys exceed the kernel's int32 grid")
    out_keys, out_vals = keys.clone(), vals.clone()
    LIB.launch("bitonic_sort_rows", out_keys.data_ptr(), ids.data_ptr(),
               out_vals.data_ptr(), g, n,
               torch.cuda.current_stream(keys.device).cuda_stream)
    return out_keys, ids, out_vals
