"""Memory scheduler — the data plane (paper Fig. 2): the stable request sort.

Counterpart of the data-plane part of ``repro.core.scheduler``
(``sort_requests``). Batch formation, the control plane, stays in the
reference package until the simulator slice of the port.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.bitonic_sort import ops as bitonic_ops


def sort_requests(keys: torch.Tensor, *, use_kernels: bool = True):
    """Return (sorted_keys, perm, inv_perm) with a *stable* sort along the
    last axis (1-D, or one scheduler batch per row of a 2-D tensor).

    ``perm`` gathers request payloads into service order; ``inv_perm``
    unsorts responses back to arrival order (the read-pointer writeback in
    Fig. 2); both are int32. With ``use_kernels`` the bitonic network
    kernel runs the sort (its plain version on a CPU tensor); otherwise
    ``torch.sort(stable=True)`` does — identical semantics.
    """
    if use_kernels:
        sorted_keys, perm = bitonic_ops.sort_with_indices(keys)
    else:
        sorted_keys, perm = torch.sort(keys, stable=True)
        perm = perm.to(torch.int32)
    return sorted_keys, perm, bitonic_ops.inverse_permutation(perm)
