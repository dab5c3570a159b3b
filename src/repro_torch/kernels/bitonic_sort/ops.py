"""Public wrapper for the bitonic-sort scheduler kernel.

Handles non-power-of-two batch sizes by padding with a +inf sentinel key
(INT32_MAX), which sorts to the tail and is sliced off — matching the FPGA
scheduler's behaviour of issuing a partially filled batch at timeout.
Counterpart of ``repro.kernels.bitonic_sort.ops``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.bitonic_sort.kernel import bitonic_sort_batched

_I32 = torch.iinfo(torch.int32)


def _next_pow2(n: int) -> int:
    return 1 << max(1, (n - 1).bit_length())


def as_int32_keys(keys: torch.Tensor) -> torch.Tensor:
    """``keys`` as int32, raising ``ValueError`` for a non-integer type or
    a value outside int32 (a cast would wrap it silently)."""
    if keys.dtype == torch.int32:
        return keys
    if keys.dtype.is_floating_point or keys.dtype.is_complex \
            or keys.dtype == torch.bool:
        raise ValueError(f"sort keys must be integers, got {keys.dtype}")
    if keys.numel():
        lo, hi = torch.aminmax(keys)
        if int(lo) < _I32.min or int(hi) > _I32.max:
            raise ValueError("sort keys outside the int32 range")
    return keys.to(torch.int32)


def sort_with_indices(keys: torch.Tensor, vals: torch.Tensor | None = None):
    """Stable-sort ``keys`` (1-D or (G, N)) along the last axis through the
    bitonic network.

    Returns (sorted_keys, perm) when ``vals`` is None else
    (sorted_keys, perm, sorted_vals), all int32. ``perm`` indexes arrival
    order — apply it to payloads, invert it to unsort responses.
    """
    squeeze = keys.ndim == 1
    k2 = as_int32_keys(keys[None, :] if squeeze else keys)
    v2 = (torch.zeros_like(k2) if vals is None
          else (vals[None, :] if squeeze else vals))
    g, n = k2.shape
    n_pad = _next_pow2(n)
    if n_pad != n:
        k2 = torch.cat([k2, k2.new_full((g, n_pad - n), _I32.max)], dim=1)
        v2 = torch.cat([v2, v2.new_zeros((g, n_pad - n))], dim=1)
    skeys, perm, svals = bitonic_sort_batched(k2.contiguous(),
                                              v2.contiguous())
    skeys, perm, svals = skeys[:, :n], perm[:, :n], svals[:, :n]
    if squeeze:
        skeys, perm, svals = skeys[0], perm[0], svals[0]
    if vals is None:
        return skeys, perm
    return skeys, perm, svals


def inverse_permutation(perm: torch.Tensor) -> torch.Tensor:
    """Inverse of each permutation along the last axis, in ``perm``'s
    dtype: ``inv[..., perm[..., i]] = i``. Equal to a stable argsort of
    ``perm``; written as one scatter because every target is distinct."""
    order = torch.arange(perm.shape[-1], dtype=perm.dtype,
                         device=perm.device).expand_as(perm)
    return torch.empty_like(perm).scatter_(-1, perm.long(), order)
