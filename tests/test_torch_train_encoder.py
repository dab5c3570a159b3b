"""The port's ``Trainer`` on the hubert-xlarge smoke config (float32
frames through the audio connector, bidirectional attention, no token
lookup) against the reference's trainer, float32, from the reference's
init: the same losses and a bit-for-bit resume
(``_torch_train_parity.check_trainer``)."""

from _torch_train_parity import check_trainer, one_thread  # noqa: F401


def test_trainer_matches_reference_and_resumes(tmp_path):
    check_trainer("hubert-xlarge", tmp_path)
