"""Gradient parity of the port's ``LM.loss`` for the SSM family (the
mamba2-2.7b smoke config: the SSD forward's chunked scan, the causal
conv and the gated norm under autograd) against ``jax.grad`` of the
reference's; ``check_grads`` and its tolerances in
tests/test_torch_grads.py."""

from test_torch_grads import check_grads


def test_loss_grads_match_reference():
    check_grads("mamba2_2p7b")
