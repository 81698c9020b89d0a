"""The port's closed-loop adaptation cells against the JAX package's: on the
virtual clock every report card and trace is equal, bit for bit; one short
wall-clock cell on ``local://`` is held to the reference test's checks."""

import numpy as np
import pytest

from repro.core import miniapp as ref
from repro_torch.core import miniapp as port

# the sweep's fits (launch/characterize.py's first design, numpy backend)
USL = {"serverless": (0.0, 0.000817924786266873, 1.004326633014317),
       "wrangler": (0.9424143687864105, 0.023124471989004528, 1.335794106947696)}
POLICIES = ["usl", "usl_online", "reactive", "static"]
FAULT_SPEC = dict(crash_rate_hz=0.08, duplicate_rate_hz=0.05, stall_rate_hz=0.02,
                  stall_s=3.0, preempt_times=[35.0, 70.0], preempt_count=2, seed=3)


def _records_equal(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(
        a[k] == b[k] or (isinstance(a[k], float) and a[k] != a[k] and b[k] != b[k])
        for k in a)


def _cell(machine, policy, **kw):
    sigma, kappa, gamma = USL[machine]
    usl = dict(usl_sigma=sigma, usl_kappa=kappa, usl_gamma=gamma) \
        if policy.startswith("usl") else {}
    return {"machine": machine, "scaling_policy": policy, "points": 16000,
            "centroids": 1024, **usl, **kw}


def assert_cells_equal(kw):
    got = port.run_adaptation(port.AdaptationExperiment(**kw))
    want = ref.run_adaptation(ref.AdaptationExperiment(**kw))
    assert _records_equal(got.record(), want.record())
    assert got.alloc_trace == want.alloc_trace and got.lag_trace == want.lag_trace
    for field in ("final_allocation", "drained", "drain_s", "wall_virtual_s", "des_events",
                  "refits", "tick_error_log", "member_ledger"):
        assert getattr(got, field) == getattr(want, field), field
    assert _records_equal(got.latency_px, want.latency_px)
    return got


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("machine", ["serverless", "wrangler"])
def test_sim_cell_equals_reference(machine, policy):
    res = assert_cells_equal(_cell(machine, policy))
    assert res.drained and res.lost == 0 and res.ticks > 0


def test_drifting_cell_equals_reference():
    res = assert_cells_equal(_cell(
        "serverless", "usl_online", points=8000, usl_sigma=0.0, usl_kappa=3.0e-4,
        usl_gamma=1.94, horizon_s=150.0, drift_t_s=40.0,
        drift_factor=1.8, rate=dict(kind="step", base_hz=2.0, high_hz=12.0, t_step=25.0,
                                    t_end=120.0),
        stabilization_s=0.0, scale_down_hysteresis=0.08, headroom=0.0,
        catchup_horizon_s=8.0, refit_interval_s=5.0, refit_half_life_s=25.0,
        max_step_up=2))
    assert res.refits > 0


@pytest.mark.parametrize("machine", ["serverless", "wrangler"])
def test_faulted_cell_equals_reference(machine):
    res = assert_cells_equal(dict(
        machine=machine, scaling_policy="reactive", faults=FAULT_SPEC,
        rate=dict(kind="step", base_hz=2.0, high_hz=8.0, t_step=20.0), horizon_s=60.0,
        initial_partitions=2, max_partitions=8, points=2000, centroids=256, seed=3,
        max_retries=5, retry_backoff_s=0.1))
    assert res.faults_injected > 0 and res.lost == 0


def test_policy_specs_and_errors_equal_reference():
    for policy in POLICIES:
        kw = _cell("wrangler", policy, max_step_up=3)
        assert port.scaling_policy_spec(port.AdaptationExperiment(**kw)) == \
            ref.scaling_policy_spec(ref.AdaptationExperiment(**kw))
        assert port.AdaptationExperiment(**kw).cost_estimate() == \
            ref.AdaptationExperiment(**kw).cost_estimate()
    bad = [dict(machine="serverless", scaling_policy="usl"),
           dict(machine="serverless", scaling_policy="bogus"),
           dict(machine="serverless", scaling_policy="static", engine="bogus"),
           dict(machine="federated", scaling_policy="static"),
           dict(machine="federated", scaling_policy="static", federation={"members": []})]
    for kw in bad:
        with pytest.raises(ValueError) as want:
            ref.run_adaptation(ref.AdaptationExperiment(**kw))
        with pytest.raises(ValueError) as got:
            port.run_adaptation(port.AdaptationExperiment(**kw))
        assert str(got.value) == str(want.value)


def test_profile_factory_equals_reference():
    kw = dict(machine="wrangler", drift_t_s=10.0, drift_factor=1.5, points=4000,
              centroids=512)
    clock, alloc = [0.0], [1]
    fns = [m.adaptation_profile_factory(m.AdaptationExperiment(**kw), lambda: clock[0],
                                        lambda: alloc[0]) for m in (port, ref)]
    for t, n in ((0.0, 1), (5.0, 4), (12.0, 4), (30.0, 9)):
        clock[0], alloc[0] = t, n
        got, want = (f([]) for f in fns)
        assert [getattr(got, k) for k in vars(want)] == list(vars(want).values())


def test_threaded_cell_runs_and_accounts():
    """The wall-clock path end to end, with the checks of the reference's
    ``test_threaded_adaptation_runs_and_accounts`` at half its horizon:
    the ticker thread drives the loop, ``local://`` grants capacity, and
    every produced message is accounted for."""
    exp = port.AdaptationExperiment(
        machine="serverless", engine="threaded", scaling_policy="usl",
        rate=dict(kind="step", base_hz=5.0, high_hz=40.0, t_step=2.0), horizon_s=5.0,
        control_interval_s=0.25, slo_lag=24, initial_partitions=1, max_partitions=6,
        static_partitions=6, catchup_horizon_s=2.0, stabilization_s=3.0, seed=0,
        usl_sigma=0.02, usl_kappa=1e-4, usl_gamma=20.0)      # ~50 ms a message
    res = port.run_adaptation(exp)
    assert res.drained
    assert res.processed == res.produced > 0 and res.lost == 0
    assert res.ticks >= 10
    assert res.scale_events >= 1 and res.final_allocation > 1
    assert len(res.alloc_trace) == res.ticks == len(res.lag_trace)
    ts = [t for t, _v in res.alloc_trace]
    assert 0.0 < ts[0] < 1.0 and ts[-1] < exp.horizon_s + 5.0
    assert np.all(np.diff(ts) > 0)
    assert res.cost_integral > 0 and res.tick_error_log == []
