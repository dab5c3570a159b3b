"""The port's ``Trainer`` on the qwen2-moe-a2.7b smoke config (60 -> 8
experts, top-4, shared experts; the aux losses in the loss) against the
reference's trainer, float32, from the reference's init: the same losses,
a bit-for-bit resume, and checkpoints loaded across both ways
(``_torch_train_parity.check_trainer``). The MoE dispatch's backward is a
fixed-order sum (ROADMAP C23), so a resume repeats its bits."""

from _torch_train_parity import check_trainer, one_thread  # noqa: F401


def test_trainer_matches_reference_and_resumes_across(tmp_path):
    check_trainer("qwen2-moe-a2.7b", tmp_path, across=True)
