"""Gradient parity of the port's ``LM.loss`` for the MoE family
(mixtral-8x7b, qwen2-moe-a2.7b smoke configs, the aux losses included)
against ``jax.grad`` of the reference's; ``check_grads`` and its
tolerances in tests/test_torch_grads.py. Float32 only (ROADMAP C18)."""

import pytest

from test_torch_grads import check_grads


@pytest.mark.parametrize("arch", ["mixtral_8x7b", "qwen2_moe_a2p7b"])
def test_loss_grads_match_reference(arch):
    check_grads(arch)
