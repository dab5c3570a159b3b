"""Public flash-attention op in the model layout (B, S, H, hd).

Counterpart of ``repro.kernels.flash_attention.ops``. The reference op
flattens to ``(B*H, S, hd)`` for its Pallas grid; the kernel here reads
the model layout through its strides, so nothing is transposed.
"""

from __future__ import annotations

from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd


def flash_attention(q, k, v, *, causal=True, window=None, q_block=128,
                    kv_block=128):
    """GQA flash attention; value-matches ``ref.attention_ref``.

    ``q_block`` / ``kv_block`` tile the plain version (CPU tensors); a
    CUDA tensor runs the kernel of B6, whose tiles are fixed."""
    return flash_attention_fwd(q, k, v, causal=causal, window=window,
                               q_block=q_block, kv_block=kv_block)
