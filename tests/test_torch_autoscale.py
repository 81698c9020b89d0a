"""The port's autoscaler, online estimator and policies against the JAX
package's: on the same observations (made in numpy from a seed) every
decision and every re-fit is equal, bit for bit."""

import dataclasses
import sys
import threading

import numpy as np
import pytest

from repro.core import autoscale as ref
from repro.core.usl import USLFit as RefFit
from repro_torch.core import autoscale as port
from repro_torch.core.usl import USLFit as PortFit
from repro_torch.streaming.engine import _WallTicker

FITS = [(0.0, 0.000817924786266873, 1.004326633014317),      # serverless sweep
        (0.9424143687864105, 0.023124471989004528, 1.335794106947696),  # wrangler
        (0.05, 0.0, 3.0), (0.3, 2e-3, 12.0)]


def _fits(params):
    kw = dict(sigma=params[0], kappa=params[1], gamma=params[2], r2=1.0, rmse=0.0, n_obs=0)
    return PortFit(**kw), RefFit(**kw)


def _fields(fit) -> tuple:
    return tuple(getattr(fit, f.name) for f in dataclasses.fields(fit) if f.name != "history")


@pytest.mark.parametrize("params", FITS)
def test_autoscaler_queries_and_plan_equal_reference(params):
    pf, rf = _fits(params)
    rates = np.random.default_rng(1).uniform(0.0, 1.5 * params[2] * 8, 64)
    for policy in ({}, dict(headroom=0.0, max_partitions=16, scale_down_hysteresis=0.08)):
        p = port.Autoscaler(pf, port.AutoscalePolicy(**policy), current=3)
        r = ref.Autoscaler(rf, ref.AutoscalePolicy(**policy), current=3)
        assert (p.usable_peak_n(), p.max_sustainable_rate()) == \
            (r.usable_peak_n(), r.max_sustainable_rate())
        assert [p.partitions_for(x) for x in rates] == [r.partitions_for(x) for x in rates]
        assert [p.throttle_rate(x) for x in rates] == [r.throttle_rate(x) for x in rates]
        assert p.plan(rates) == r.plan(rates) and p.current == r.current


def _observations(seed, count=120):
    """A control-tick stream: a rate step, lag that builds and drains, and
    the allocation the policy asked for echoed back."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(count):
        out.append(dict(t=2.0 * (i + 1), lag=int(rng.integers(0, 200)),
                        arrival_rate=float(rng.uniform(0.5, 14.0)),
                        completion_rate=float(rng.uniform(0.0, 12.0)),
                        window_stable=bool(rng.uniform() < 0.8)))
    return out


def _drive(module, policy, obs_list):
    decisions, alloc = [], 2
    for o in obs_list:
        want = int(policy.decide(module.ControlObservation(allocation=alloc, **o)))
        decisions.append(want)
        alloc = max(1, min(want, 16))
    return decisions


SPECS = [dict(kind="usl", headroom=0.15, max_partitions=16, catchup_horizon_s=20.0,
              downscale_lag=16, stabilization_s=60.0, max_step_up=None),
         dict(kind="usl", stabilization_s=0.0, max_step_up=2, scale_down_hysteresis=0.08),
         dict(kind="usl_online", refit_interval_s=10.0, refit_window=64,
              refit_half_life_s=45.0, max_partitions=16),
         dict(kind="reactive", hi_lag=32, lo_lag=4, max_partitions=16),
         dict(kind="static", partitions=6), dict(kind="static")]


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: s["kind"])
@pytest.mark.parametrize("params", FITS[:2], ids=["serverless", "wrangler"])
def test_policies_decide_as_the_reference(spec, params):
    spec = dict(spec, sigma=params[0], kappa=params[1], gamma=params[2])
    for seed in (0, 1):
        obs = _observations(seed)
        p = port.policy_from_spec(spec, initial=2)
        r = ref.policy_from_spec(spec, initial=2)
        assert type(p).__name__ == type(r).__name__ and p.name == r.name
        assert _drive(port, p, obs) == _drive(ref, r, obs)
        est_p, est_r = getattr(p, "estimator", None), getattr(r, "estimator", None)
        if est_r is not None:
            assert est_p.refits == est_r.refits and est_r.refits > 0
            assert est_p.observations == est_r.observations
            assert _fields(est_p.fit) == _fields(est_r.fit)


def test_policy_spec_errors_match_reference():
    for spec in (dict(kind="usl"), dict(kind="bogus")):
        with pytest.raises(ValueError) as want:
            ref.policy_from_spec(spec, initial=1)
        with pytest.raises(ValueError) as got:
            port.policy_from_spec(spec, initial=1)
        assert str(got.value) == str(want.value)


def test_online_estimator_on_the_references_falsifying_example():
    """The reference's stationary-convergence property fails at sigma 0,
    kappa 0.00390625, gamma 1 (its refit predicts ~1.058 at N = 1); the
    port copies the estimator, so it must give the reference's numbers."""
    sigma, kappa, gamma = 0.0, 0.00390625, 1.0
    prior = (0.0, 1e-4, gamma * 1.7)
    ests = [m.OnlineUSLEstimator(f, window=64, half_life_s=500.0)
            for m, f in zip((port, ref), _fits(prior))]
    levels = [1, 2, 4, 8]
    for i in range(64):
        n = levels[i % len(levels)]
        rate = gamma * n / (1.0 + sigma * (n - 1) + kappa * n * (n - 1))
        assert [e.observe(t=2.0 * i, n=n, rate=rate, lag=1000) for e in ests] == [True, True]
    fp, fr = (e.refit(now=128.0) for e in ests)
    assert _fields(fp) == _fields(fr)
    assert [fp.predict(n) for n in levels] == [fr.predict(n) for n in levels]
    assert np.array_equal(ests[0].observation_weights(130.0),
                          ests[1].observation_weights(130.0))


def test_online_estimator_gating_and_cadence_equal_reference():
    pf, rf = _fits((0.1, 1e-3, 4.0))
    ests = [m.OnlineUSLEstimator(f, refit_interval_s=5.0, window=16, min_obs=4)
            for m, f in zip((port, ref), (pf, rf))]
    rng = np.random.default_rng(7)
    for i in range(80):
        n, rate, lag = int(rng.integers(1, 9)), float(rng.uniform(0, 30)), int(rng.integers(0, 40))
        kept = [e.observe(t=float(i), n=n, rate=rate, lag=lag) for e in ests]
        assert kept[0] == kept[1]
        fits = [e.maybe_refit(float(i)) for e in ests]
        assert (fits[0] is None) == (fits[1] is None)
        if fits[0] is not None:
            assert _fields(fits[0]) == _fields(fits[1])
    assert (ests[0].refits, ests[0].rejected, len(ests[0])) == \
        (ests[1].refits, ests[1].rejected, len(ests[1]))
    with pytest.raises(ValueError):
        port.OnlineUSLEstimator(pf, window=1)


def test_ticker_runs_a_handed_function_between_its_callbacks():
    """``run_now`` (behind ``run_on_clock`` and ``ControlLoop.stop``) runs
    on the ticker thread, after the callbacks that are due, and re-raises;
    with the ticker stopped it runs inline."""
    ticker = _WallTicker()
    order, threads = [], []
    gate = threading.Event()
    ticker.call_later(0.0, lambda: (gate.wait(10.0), order.append("tick")))
    ticker.start()

    def settle():
        threads.append(threading.current_thread())
        order.append("settle")

    gate.set()
    ticker.run_now(settle)
    assert order == ["tick", "settle"] and threads == [ticker]
    with pytest.raises(KeyError):
        ticker.run_now(lambda: {}["missing"])
    assert ticker.last_error is None
    ticker.stop()
    ticker.join(10.0)
    ticker.run_now(settle)
    assert order[-1] == "settle" and threads[-1] is threading.current_thread()


def test_ticker_runs_every_handed_function_alone_under_contention():
    """16 threads hand the ticker 50 unguarded read-modify-writes each while
    it runs its own callbacks, at a 1 us switch interval: none is lost,
    because every one runs on the ticker thread."""
    ticker = _WallTicker()
    ticker.start()
    state = {"n": 0}
    threads_seen = set()

    def bump():
        threads_seen.add(threading.get_ident())
        n = state["n"]
        state["n"] = n + 1

    for _ in range(200):
        ticker.call_later(0.0, bump)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=lambda: [ticker.run_now(bump) for _ in range(50)])
                   for _ in range(16)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(60.0)
        assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(interval)
        ticker.stop()
        ticker.join(10.0)
    assert state["n"] == 200 + 16 * 50
    assert threads_seen == {ticker.ident}
