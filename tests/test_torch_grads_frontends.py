"""Gradient parity of the port's ``LM.loss`` for the audio encoder
(hubert-xlarge: float32 frames through the connector, bidirectional
attention) and the VLM (internvl2-76b: projected patches ahead of the
text, masked out of the loss) smoke configs against ``jax.grad`` of the
reference's; ``check_grads`` and its tolerances in
tests/test_torch_grads.py. The audio model makes no embedding lookup: its
unused ``embed`` leaves, if any, get zero gradients in both packages."""

import pytest

from test_torch_grads import check_grads


@pytest.mark.parametrize("arch", ["hubert_xlarge", "internvl2_76b"])
def test_loss_grads_match_reference(arch):
    check_grads(arch)
