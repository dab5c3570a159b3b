"""Gradient parity of the port's ``LM.loss`` for the hybrid family
(jamba-v0.1-52b's smoke config, one period of 8 layers: attention at
position 4, Mamba elsewhere, MoE at the odd positions, the aux losses
included) against ``jax.grad`` of the reference's; ``check_grads`` and
its tolerances in tests/test_torch_grads.py. Float32 only (ROADMAP
C18)."""

from test_torch_grads import check_grads


def test_loss_grads_match_reference():
    check_grads("jamba_v0p1_52b")
