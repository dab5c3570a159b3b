"""Port parity for the runtime substrate (``repro_torch.runtime``, plain
Python): the reference's tests/runtime/test_watchdog.py,
test_fault_tolerance.py and test_elastic.py on the port, and the elastic
planner against ``repro.runtime``'s over a grid of fleets.

Step durations come from a fake clock: each test replaces the
watchdog module's ``time`` with one whose ``monotonic`` returns what the
test sets (``monkeypatch`` restores it), so no assertion reads the wall
clock and nothing sleeps."""

import types

import pytest

from repro.runtime import plan_rescale as jplan_rescale
from repro.runtime import elastic_mesh_shape as jelastic_mesh_shape
from repro_torch.runtime import (RescalePlan, StepWatchdog,
                                 elastic_mesh_shape, plan_rescale)
from repro_torch.runtime import watchdog as watchdog_mod


class FakeClock:
    def __init__(self):
        self.now = 1000.0

    def monotonic(self) -> float:
        return self.now


@pytest.fixture
def clock(monkeypatch):
    fake = FakeClock()
    monkeypatch.setattr(watchdog_mod, "time",
                        types.SimpleNamespace(monotonic=fake.monotonic))
    return fake


def _step(wd, clock, dt, step):
    wd.start()
    clock.now += dt
    return wd.stop(step)


def _dp(plan):
    sizes = dict(zip(plan.axis_names, plan.new_shape))
    return sizes.get("pod", 1) * sizes.get("data", 1)


# ---------------------------------------------------------------------------
# tests/runtime/test_watchdog.py and test_fault_tolerance.py's watchdog
# ---------------------------------------------------------------------------

def test_watchdog_flags_persistent_straggler(clock):
    wd = StepWatchdog(window=20, threshold=2.0, patience=2)
    for s in range(10):
        _step(wd, clock, 0.01, s)
    # two consecutive slow steps -> alert on the second
    assert _step(wd, clock, 0.1, 10) is None
    alert = _step(wd, clock, 0.1, 11)
    assert alert is not None and alert.ratio == pytest.approx(10.0)


def test_watchdog_ignores_single_blip(clock):
    wd = StepWatchdog(window=20, threshold=2.0, patience=2)
    for s in range(10):
        _step(wd, clock, 0.01, s)
    assert _step(wd, clock, 0.2, 10) is None     # one blip
    assert _step(wd, clock, 0.01, 11) is None    # recovered
    assert wd.alerts == []


def test_no_alerts_during_warmup(clock):
    """Until max(5, window//5) samples exist there is no baseline."""
    wd = StepWatchdog(window=50, threshold=2.0, patience=1)
    for s in range(10):                      # warmup floor is 10 here
        assert _step(wd, clock, 10.0 if s % 2 else 0.01, s) is None
    assert wd.alerts == []


def test_baseline_is_median_not_mean(clock):
    wd = StepWatchdog(window=20, threshold=2.0, patience=1)
    for s in range(8):
        _step(wd, clock, 0.01, s)
    for s in range(8, 11):                   # 3 outliers of 11 samples
        _step(wd, clock, 1.0, s)
    assert wd.median_step_s == pytest.approx(0.01)
    alert = _step(wd, clock, 0.03, 11)       # 3x the median trips
    assert alert is not None
    assert alert.baseline_s == pytest.approx(0.01)
    assert alert.ratio == pytest.approx(3.0)


def test_patience_requires_consecutive_breaches(clock):
    wd = StepWatchdog(window=20, threshold=2.0, patience=2)
    for s in range(10):
        _step(wd, clock, 0.01, s)
    assert _step(wd, clock, 0.1, 10) is None
    assert _step(wd, clock, 0.01, 11) is None     # resets the count
    assert _step(wd, clock, 0.1, 12) is None      # count restarts at 1
    assert wd.alerts == []


def test_breach_counter_resets_after_alert(clock):
    wd = StepWatchdog(window=20, threshold=2.0, patience=2)
    for s in range(10):
        _step(wd, clock, 0.01, s)
    assert _step(wd, clock, 0.08, 10) is None
    assert _step(wd, clock, 0.08, 11) is not None  # fires at patience=2
    assert _step(wd, clock, 0.08, 12) is None      # counter was reset
    assert len(wd.alerts) == 1


def test_on_alert_callback_and_alert_fields(clock):
    seen = []
    wd = StepWatchdog(window=20, threshold=2.0, patience=1,
                      on_alert=seen.append)
    for s in range(10):
        _step(wd, clock, 0.01, s)
    alert = _step(wd, clock, 0.05, 10)
    assert seen == [alert] == wd.alerts
    assert alert.step == 10
    assert alert.step_time_s == pytest.approx(0.05)
    assert alert.ratio == pytest.approx(alert.step_time_s / alert.baseline_s)


def test_baseline_adapts_to_new_regime(clock):
    wd = StepWatchdog(window=10, threshold=2.0, patience=1)
    for s in range(10):
        _step(wd, clock, 0.01, s)
    for s in range(10, 30):                  # the window turns over
        _step(wd, clock, 0.05, s)
    assert wd.median_step_s == pytest.approx(0.05)
    assert _step(wd, clock, 0.06, 30) is None
    assert len(wd.times) == 10               # deque bounded by window


def test_stop_without_start_asserts():
    wd = StepWatchdog()
    with pytest.raises(AssertionError):
        wd.stop(0)


def test_median_of_empty_history_is_zero():
    assert StepWatchdog().median_step_s == 0.0


# ---------------------------------------------------------------------------
# tests/runtime/test_elastic.py and test_fault_tolerance.py's planner
# ---------------------------------------------------------------------------

def test_mesh_shape_exact_and_truncated_fits():
    assert elastic_mesh_shape(256, 16) == (16, 16)
    assert elastic_mesh_shape(250, 16) == (15, 16)
    assert elastic_mesh_shape(244, 16) == (15, 16)
    assert elastic_mesh_shape(512, 16, pods=2) == (2, 16, 16)
    assert elastic_mesh_shape(510, 16, pods=2) == (2, 15, 16)


def test_mesh_shape_never_shrinks_tp():
    with pytest.raises(ValueError, match="cannot shrink TP"):
        elastic_mesh_shape(8, 16)
    with pytest.raises(ValueError):
        elastic_mesh_shape(24, 16, pods=2)


@pytest.mark.parametrize("lost", [0, 16, 48, 112])
def test_plan_preserves_model_axis_size(lost):
    plan = plan_rescale((16, 16), ("data", "model"),
                        available_devices=256 - lost, global_batch=512)
    assert dict(zip(plan.axis_names, plan.new_shape))["model"] == 16


def test_plan_no_loss_is_identity():
    plan = plan_rescale((16, 16), ("data", "model"),
                        available_devices=256, global_batch=512)
    assert plan.new_shape == (16, 16)
    assert plan.grad_accum == 1 and plan.dropped_devices == 0


@pytest.mark.parametrize("available,want_dp,want_accum", [
    (128, 8, 2), (240, 15, 2), (64, 4, 4)])
def test_plan_preserves_global_batch(available, want_dp, want_accum):
    plan = plan_rescale((16, 16), ("data", "model"),
                        available_devices=available, global_batch=256)
    assert _dp(plan) == want_dp
    assert plan.grad_accum == want_accum
    assert _dp(plan) * plan.grad_accum >= 16


def test_plan_drops_partial_pod_wholesale():
    plan = plan_rescale((2, 8, 16), ("pod", "data", "model"),
                        available_devices=200, global_batch=256)
    assert plan.axis_names == ("data", "model")
    assert plan.new_shape == (12, 16)
    assert plan.grad_accum == 2
    assert plan.dropped_devices == 200 - 12 * 16


def test_plan_keeps_both_pods_when_complete():
    plan = plan_rescale((2, 8, 16), ("pod", "data", "model"),
                        available_devices=300, global_batch=256)
    assert plan.axis_names == ("pod", "data", "model")
    assert plan.new_shape == (2, 9, 16)
    assert plan.dropped_devices == 300 - 2 * 9 * 16
    assert "grad_accum" in plan.describe()


def test_plan_rescale_drops_dead_pod():
    plan = plan_rescale((2, 16, 16), ("pod", "data", "model"),
                        available_devices=256, global_batch=256)
    assert plan.new_shape == (16, 16)
    assert plan.grad_accum == 2


@pytest.mark.parametrize("old,names", [
    ((16, 16), ("data", "model")), ((8, 4), ("data", "model")),
    ((2, 8, 16), ("pod", "data", "model")),
    ((4, 4, 8), ("pod", "data", "model"))])
def test_planner_matches_reference(old, names):
    """Every plan, description and refusal equals the reference's, from
    the whole fleet down to a single model-axis group and below."""
    full = 1
    for n in old:
        full *= n
    model = old[-1]
    for available in range(1, full + 1):
        try:
            want = jplan_rescale(old, names, available, global_batch=256)
        except ValueError as e:
            with pytest.raises(ValueError, match=str(e).split(";")[0]):
                plan_rescale(old, names, available, global_batch=256)
            continue
        got = plan_rescale(old, names, available, global_batch=256)
        assert isinstance(got, RescalePlan)
        assert (got.old_shape, got.new_shape, got.axis_names,
                got.grad_accum, got.dropped_devices) == \
            (want.old_shape, want.new_shape, want.axis_names,
             want.grad_accum, want.dropped_devices)
        assert got.describe() == want.describe()
        for pods in (1, 2):
            try:
                shape = jelastic_mesh_shape(available, model, pods=pods)
            except ValueError:
                with pytest.raises(ValueError):
                    elastic_mesh_shape(available, model, pods=pods)
                continue
            assert elastic_mesh_shape(available, model, pods=pods) == shape
