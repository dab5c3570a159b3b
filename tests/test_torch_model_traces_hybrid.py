"""The model trace zoo's capture against the reference's live capture
for the hybrid smoke config (jamba-v0.1-52b: Mamba state rewrites, MoE
routes and one attention position's KV appends in one trace): the whole
trace in float32, the value-independent rows in bf16, and its pinned
trace. See
``test_torch_model_traces.py``, whose helpers run both."""

from test_torch_model_traces import check_bf16, check_float32, check_pinned

ARCH = "jamba_v0p1_52b"


def test_capture_matches_reference_float32():
    check_float32(ARCH)


def test_capture_value_independent_rows_match_reference_bf16():
    check_bf16(ARCH)


def test_pinned_trace_value_independent_rows_and_op_counts():
    check_pinned(ARCH)
