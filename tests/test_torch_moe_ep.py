"""Expert-parallel MoE (``repro_torch.models.moe_ep``, ROADMAP A7.7) on a
(2,4) gloo mesh, as the reference's
``tests/distribution/test_sharded.py::test_ep_dispatch_matches_tp_and_trains``
(which fails on jax 0.9.0, ROADMAP C5): the all-to-all dispatch equals the
token-choice dispatch on one device at capacity factor 8 (jamba smoke,
float32, within 1e-4), and a whole EP model trains with a finite loss and
finite gradients. One spawn of 8 ranks carries every check."""

import numpy as np
import pytest

from _torch_spawn import spawn
import _torch_dist_workers as W
from repro_torch.configs import get_arch
from repro_torch.models.lm import build_lm

EP_REL = 1e-4


@pytest.fixture(scope="module")
def ep(tmp_path_factory):
    return spawn(W.ep_2x4, 8, tmp_path_factory.mktemp("ep"))


def test_ep_dispatch_matches_tp(ep):
    for r in ep:
        assert r["err"] <= EP_REL, r["err"]


def test_ep_aux_losses_match_tp(ep):
    for r in ep:
        assert r["aux_err"] <= 1e-6


def test_ep_output_is_batch_sharded_and_model_replicated(ep):
    assert ep[0]["layout"] == ["S(0)", "R"]


def test_ep_experts_live_on_their_owner_shard(ep):
    """(layers, expert, d, f): the expert dim split over ``model``,
    replicated over ``data``."""
    assert ep[0]["expert_layout"] == ["R", "S(1)"]


def test_ep_model_trains_with_finite_loss_and_gradients(ep):
    for r in ep:
        assert np.isfinite(r["loss"]) and np.isfinite(r["step_loss"])
        assert r["grads_finite"]
        assert r["expert_grads_nonzero"]


def test_ep_needs_a_mesh_and_divisible_experts():
    cfg = get_arch("jamba-v0.1-52b", smoke=True)
    with pytest.raises(ValueError, match="needs a mesh"):
        build_lm(cfg, moe_strategy="ep", device="cpu")
    with pytest.raises(ValueError, match="needs a mesh"):
        build_lm(get_arch("yi-34b", smoke=True), moe_strategy="ep",
                 device="cpu")
