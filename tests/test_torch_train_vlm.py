"""The port's ``Trainer`` on the internvl2-76b smoke config (projected
patches ahead of the text tokens, masked out of the loss) against the
reference's trainer, float32, from the reference's init: the same losses
and a bit-for-bit resume (``_torch_train_parity.check_trainer``)."""

from _torch_train_parity import check_trainer, one_thread  # noqa: F401


def test_trainer_matches_reference_and_resumes(tmp_path):
    check_trainer("internvl2-76b", tmp_path)
