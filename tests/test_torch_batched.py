"""The port's fast replay and lockstep seed scans against the JAX package's.

``run_plan`` summaries of the reference's replay cells (serverless, fault
plans, wrangler coupling chains, an undrained cell) equal the reference's
field for field, and the port's own scalar ``run_adaptation``; declines and
mid-run fallbacks carry the reference's reasons.  The lockstep scans run
their plain PyTorch versions here: within rtol 1e-5 of the reference's jax
scans, and within ``LOCKSTEP_RTOL`` of the float64 replay and the scalar
latency percentiles.
"""

import dataclasses
import logging

import numpy as np
import pytest
import torch

from repro.core import miniapp as ref
from repro.sim import batched as ref_batched
from repro_torch.core import miniapp as port
from repro_torch.core.metrics import percentile_summary
from repro_torch.kernels.lockstep_scan import ops as lockstep_ops
from repro_torch.kernels.lockstep_scan.ref import grid_lockstep_scan_ref, lockstep_scan_ref
from repro_torch.sim import batched

# tests/test_batched.py's cells: fig8's serverless drift cell at a 90 s
# horizon, its fault-grid shape and its wrangler coupling-chain shape
DRIFT_CELL = dict(
    machine="serverless", usl_sigma=0.0, usl_kappa=3.0e-4, usl_gamma=1.94,
    horizon_s=90.0, max_partitions=16, slo_lag=32, control_interval_s=2.0,
    stabilization_s=0.0, scale_down_hysteresis=0.08, headroom=0.0,
    catchup_horizon_s=8.0, refit_interval_s=5.0, max_step_up=2,
    drift_t_s=25.0, drift_factor=1.8, refit_half_life_s=25.0,
    rate=dict(kind="step", base_hz=2.0, high_hz=10.0, t_step=15.0, t_end=70.0))
FAULT_OVER = dict(max_retries=5, retry_backoff_s=0.1,
                  faults=dict(crash_rate_hz=0.03, duplicate_rate_hz=0.015,
                              preempt_times=[35.0, 60.0], preempt_count=3))
WRANGLER_OVER = dict(machine="wrangler", policy="update_locked", drift_t_s=40.0,
                     drift_factor=0.25, refit_half_life_s=30.0)
UNDRAINED = dict(machine="serverless", scaling_policy="static", static_partitions=1,
                 seed=0, horizon_s=30.0, max_partitions=4, control_interval_s=2.0,
                 points=60000, backend_attrs=dict(flops_per_vcpu=2.4e7),
                 faults=dict(duplicate_rate_hz=0.2),
                 rate=dict(kind="constant", rate_hz=5.0))
LOCK_CELL = dict(machine="serverless", scaling_policy="static", static_partitions=1,
                 horizon_s=60.0, rate=dict(kind="step", base_hz=2.0, high_hz=4.0, t_step=30.0))
SEEDS = (0, 3, 6)
JAX_RTOL = 1e-5      # plain torch scan vs the reference's jax scan, both float32

SUMMARY_FIELDS = ("slo_violations", "ticks", "cost_integral", "scale_events", "produced",
                  "processed", "throughput", "latency_px", "final_allocation", "drained",
                  "drain_s", "refits", "abandoned", "dup_delivered", "lost",
                  "faults_injected", "preemptions", "fault_windows", "member_ledger",
                  "fast_path", "fallback_reason")


def _kw(scaling_policy, seed, **over):
    return {**DRIFT_CELL, "scaling_policy": scaling_policy, "seed": seed, **over}


def _same(a, b) -> bool:
    if isinstance(a, float) and isinstance(b, float) and a != a and b != b:
        return True
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    return a == b


def assert_summaries_equal(got, want, fields=SUMMARY_FIELDS):
    for f in fields:
        assert _same(getattr(got, f), getattr(want, f)), \
            f"{f}: {getattr(got, f)!r} != {getattr(want, f)!r}"
    assert _same(got.record(), want.record())


def run_both(kw, fast=True):
    got = port.run_plan(port.AdaptationPlan(experiment=port.AdaptationExperiment(**kw),
                                            fast=fast))
    want = ref.run_plan(ref.AdaptationPlan(experiment=ref.AdaptationExperiment(**kw),
                                           fast=fast))
    assert_summaries_equal(got, want)
    return got


@pytest.mark.parametrize("policy", ["usl", "usl_online"])
@pytest.mark.parametrize("cell", ["serverless", "faults", "wrangler"])
def test_fast_replay_equals_reference_and_scalar(cell, policy):
    over = {"serverless": {}, "faults": FAULT_OVER, "wrangler": WRANGLER_OVER}[cell]
    for seed in SEEDS:
        kw = _kw(policy, seed, **over)
        got = run_both(kw)
        assert got.fast_path and got.fallback_reason is None
        scalar = port.summarize_adaptation(port.run_adaptation(port.AdaptationExperiment(**kw)))
        assert_summaries_equal(got, scalar, SUMMARY_FIELDS[:-2])


def test_undrained_cell_reports_lost_as_the_reference():
    got = run_both(UNDRAINED)
    assert got.fast_path and not got.drained and got.lost > 0


@pytest.mark.parametrize("label,over,fragment", [
    ("federated", dict(machine="federated",
                       federation=dict(members=[dict(machine="serverless")])), "federated"),
    ("batch", dict(batch_max=2), "batch_max"),
    ("memory", dict(memory_mb=48), "working set"),
])
def test_declines_carry_the_reference_reasons(label, over, fragment):
    kw = _kw("usl", 0, **over)
    got, reason = batched.try_fast_adaptation(
        port.AdaptationPlan(experiment=port.AdaptationExperiment(**kw)))
    want, want_reason = ref_batched.try_fast_adaptation(
        ref.AdaptationPlan(experiment=ref.AdaptationExperiment(**kw)))
    assert got is None and want is None
    assert reason == want_reason and fragment in reason
    # run_plan then runs the scalar DES and stamps the reason
    summary = run_both(kw)
    assert not summary.fast_path and summary.fallback_reason == reason


def test_threaded_cell_declines_with_the_reference_reason():
    kw = _kw("usl", 0, engine="threaded", threaded_service_s=0.02)
    _s, reason = batched.try_fast_adaptation(
        port.AdaptationPlan(experiment=port.AdaptationExperiment(**kw)))
    _r, want = ref_batched.try_fast_adaptation(
        ref.AdaptationPlan(experiment=ref.AdaptationExperiment(**kw)))
    assert reason == want and "threaded" in reason


def test_mid_run_fallback_equals_reference_and_logs(caplog):
    kw = _kw("usl", 0, points=60000, backend_attrs=dict(flops_per_vcpu=6e6))
    with caplog.at_level(logging.INFO, logger="repro_torch.sim.batched"):
        got = run_both(kw)
    assert not got.fast_path and "walltime" in got.fallback_reason
    assert any("fast replay fallback" in r.message for r in caplog.records
               if r.name == "repro_torch.sim.batched")


def test_static_decline_logs_at_debug(caplog):
    kw = _kw("usl", 0, machine="federated",
             federation=dict(members=[dict(machine="serverless")]))
    with caplog.at_level(logging.DEBUG, logger="repro_torch.sim.batched"):
        batched.try_fast_adaptation(
            port.AdaptationPlan(experiment=port.AdaptationExperiment(**kw)))
    mine = [r for r in caplog.records if r.name == "repro_torch.sim.batched"]
    assert mine and all(r.levelno == logging.DEBUG for r in mine)
    assert all("fast replay ineligible" in r.message for r in mine)


def test_fast_false_runs_the_scalar_des():
    got = run_both(_kw("usl", 0), fast=False)
    assert not got.fast_path and got.fallback_reason is None


# -- lockstep scans -------------------------------------------------------------

def _port(kw):
    return port.AdaptationExperiment(**kw)


def _ref(kw):
    return ref.AdaptationExperiment(**kw)


@pytest.mark.parametrize("over", [{}, dict(scaling_policy="usl", usl_sigma=0.0,
                                           usl_kappa=3e-4, usl_gamma=1.94),
                                  dict(static_partitions=2),
                                  dict(drift_t_s=20.0, drift_factor=2.0),
                                  dict(machine="wrangler"),
                                  dict(faults=dict(crash_rate_hz=0.05))])
def test_lockstep_eligibility_equals_reference(over):
    kw = {**LOCK_CELL, "seed": 0, **over}
    assert batched.lockstep_eligibility(_port(kw)) == ref_batched.lockstep_eligibility(_ref(kw))
    gkw = {**_kw("usl", 0), **over} if over else _kw("usl", 0)
    assert batched.grid_lockstep_eligibility(_port(gkw)) == \
        ref_batched.grid_lockstep_eligibility(_ref(gkw))


def test_lockstep_within_rtol_of_the_reference_jax_scan():
    seeds = list(range(16))
    kw = {**LOCK_CELL, "seed": 0}
    got, appends = batched.lockstep_completion_times(_port(kw), seeds, with_appends=True,
                                                     device="cpu")
    want, want_appends = ref_batched.lockstep_completion_times(_ref(kw), seeds,
                                                               with_appends=True)
    assert got.dtype == np.float32 and got.shape == want.shape == (16, len(appends))
    assert np.array_equal(appends, want_appends)
    np.testing.assert_allclose(got, want, rtol=JAX_RTOL, atol=0)


def test_lockstep_matches_scalar_latency_within_rtol():
    seeds = list(range(8))
    exp = _port({**LOCK_CELL, "seed": 0})
    finishes, appends = batched.lockstep_completion_times(exp, seeds, with_appends=True,
                                                          device="cpu")
    assert np.all(np.diff(finishes, axis=1) >= 0)
    for i, seed in enumerate(seeds):
        res = port.run_adaptation(dataclasses.replace(exp, seed=seed))
        lat = percentile_summary(list(finishes[i] - appends))
        for q in ("p50", "p95"):
            assert abs(lat[q] - res.latency_px[q]) <= batched.LOCKSTEP_RTOL * res.latency_px[q]


def test_lockstep_equal_seeds_give_equal_columns():
    a = batched.lockstep_completion_times(_port({**LOCK_CELL, "seed": 0}), [0, 1, 0],
                                          device="cpu")
    assert np.array_equal(a[0], a[2]) and not np.array_equal(a[0], a[1])


@pytest.mark.parametrize("cell", ["usl", "usl_online", "reactive"])
def test_grid_lockstep_equals_reference_and_float64_replay(cell):
    seeds = list(range(8))
    kw = _kw(cell, 0)
    got, ref_fin = batched.grid_lockstep_completion_times(_port(kw), seeds,
                                                          with_reference=True, device="cpu")
    want, want_fin = ref_batched.grid_lockstep_completion_times(_ref(kw), seeds,
                                                                with_reference=True)
    assert got.shape == want.shape and got.shape[1] == len(ref_fin) > 0
    assert np.array_equal(ref_fin, want_fin)
    np.testing.assert_allclose(got, want, rtol=JAX_RTOL, atol=0)
    err = np.abs(got[0].astype(np.float64) - ref_fin) / np.maximum(ref_fin, 1e-9)
    assert float(err.max()) <= batched.LOCKSTEP_RTOL


def test_grid_lockstep_equal_seeds_give_equal_columns():
    fins = batched.grid_lockstep_completion_times(_port(_kw("usl", 1)), [1, 4, 1], device="cpu")
    assert np.array_equal(fins[0], fins[2]) and not np.array_equal(fins[0], fins[1])


def test_lockstep_rejects_what_the_reference_rejects():
    hpc = _port(_kw("usl", 0, **WRANGLER_OVER))
    with pytest.raises(ValueError):
        batched.grid_lockstep_completion_times(hpc, [0], device="cpu")
    with pytest.raises(ValueError):
        batched.grid_lockstep_completion_times(_port(_kw("usl", 0)), [], device="cpu")
    with pytest.raises(ValueError):
        batched.lockstep_completion_times(_port(_kw("usl", 0)), [0], device="cpu")


def test_lockstep_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        batched.lockstep_completion_times(_port({**LOCK_CELL, "seed": 0}), [0])
    with pytest.raises(RuntimeError, match="cuda"):
        batched.grid_lockstep_completion_times(_port(_kw("usl", 0)), [0])


# -- the wrappers on CPU tensors ------------------------------------------------------

def _chain_inputs(s, n, seed=0):
    rng = np.random.default_rng(seed)
    appends = np.cumsum(rng.exponential(0.3, n)).astype(np.float32)
    means = rng.uniform(0.1, 0.5, n).astype(np.float32)
    z = rng.standard_normal((s, n)).astype(np.float32)
    return torch.from_numpy(appends), torch.from_numpy(means), torch.from_numpy(z)


def test_chain_wrapper_runs_the_plain_version_on_cpu():
    appends, means, z = _chain_inputs(5, 300)
    before = dict(lockstep_ops.LAUNCHES)
    got = lockstep_ops.lockstep_scan(appends, means, z, -0.02, 0.2)
    assert lockstep_ops.LAUNCHES == before
    assert torch.equal(got, lockstep_scan_ref(appends, means, z, -0.02, 0.2))
    # the recurrence, step by step in float64 from the same float32 inputs
    a32, b32 = np.float32(-0.02), np.float32(0.2)
    dt = means.numpy()[None] * np.exp(a32 + b32 * z.numpy())
    fin = np.zeros(5)
    for i in range(300):
        fin = np.maximum(appends[i].item(), fin) + dt[:, i]
        np.testing.assert_allclose(got[:, i].numpy(), fin, rtol=1e-5)


def test_grid_wrapper_runs_the_plain_version_on_cpu():
    rng = np.random.default_rng(1)
    n, s = 400, 6
    floors = torch.from_numpy(np.cumsum(rng.exponential(0.1, n)).astype(np.float32))
    parts = torch.from_numpy(rng.integers(0, 5, n).astype(np.int32))
    conts = torch.from_numpy(rng.integers(0, 9, n).astype(np.int32))
    dt = torch.from_numpy(rng.uniform(0.05, 0.6, (s, n)).astype(np.float32))
    before = dict(lockstep_ops.LAUNCHES)
    got = lockstep_ops.grid_lockstep_scan(floors, parts, conts, dt, 5, 9)
    assert lockstep_ops.LAUNCHES == before
    part_last, cont_last = np.zeros((s, 5), np.float32), np.zeros((s, 9), np.float32)
    for k in range(n):
        p, c = int(parts[k]), int(conts[k])
        fin = np.maximum(floors[k].numpy(), np.maximum(part_last[:, p], cont_last[:, c])) \
            + dt[:, k].numpy()
        part_last[:, p] = cont_last[:, c] = fin
        assert np.array_equal(got[:, k].numpy(), fin)
    assert torch.equal(got, grid_lockstep_scan_ref(floors, parts, conts, dt, 5, 9))


def test_wrappers_check_their_operands():
    appends, means, z = _chain_inputs(2, 10)
    with pytest.raises(ValueError):
        lockstep_ops.lockstep_scan(appends[:5], means, z, 0.0, 1.0)
    with pytest.raises(TypeError):
        lockstep_ops.lockstep_scan(appends.double(), means, z, 0.0, 1.0)
    with pytest.raises(ValueError):
        lockstep_ops.lockstep_scan(appends, means, z.t(), 0.0, 1.0)
    idx = torch.zeros(10, dtype=torch.int32)
    with pytest.raises(TypeError):
        lockstep_ops.grid_lockstep_scan(appends, idx.long(), idx, z, 1, 1)
    with pytest.raises(ValueError):
        lockstep_ops.grid_lockstep_scan(appends, idx, idx, z, 0, 1)
