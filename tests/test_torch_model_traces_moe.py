"""The model trace zoo's capture against the reference's live capture
for the MoE smoke configs (mixtral-8x7b, qwen2-moe-a2.7b): the whole
trace in float32, the value-independent rows in bf16, and mixtral's
pinned trace. See ``test_torch_model_traces.py``, whose helpers run
both."""

import pytest

from test_torch_model_traces import check_bf16, check_float32, check_pinned

ARCHS = ["mixtral_8x7b", "qwen2_moe_a2p7b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_capture_matches_reference_float32(arch):
    check_float32(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_capture_value_independent_rows_match_reference_bf16(arch):
    check_bf16(arch)


def test_pinned_trace_value_independent_rows_and_op_counts():
    check_pinned("mixtral_8x7b")
