"""The port's discrete-event core (``repro_torch.sim.des``) against the
reference's (``repro.sim.des``): the same seeded scenario, driven through
both, must give the same trace bit for bit — event order, cancellation,
processor sharing, lock handoffs and the batched normal stream."""

import math

import numpy as np
import pytest

from repro.sim import des as ref_des
from repro_torch.sim import des as port_des

MODULES = {"ref": ref_des, "port": port_des}


def _both(scenario, *args):
    return {name: scenario(mod, *args) for name, mod in MODULES.items()}


def _event_order(mod, seed: int) -> list:
    """Random schedule/schedule_fast/schedule_at/cancel traffic whose
    callbacks schedule more events and draw jitter from the simulator."""
    sim = mod.Simulator(seed=seed)
    plan = np.random.default_rng([seed, 1])
    trace, handles = [], []

    def fire(tag: int, depth: int) -> None:
        trace.append((sim.now, tag, sim.lognormal_jitter(1.0, 0.1 * (tag % 4))))
        if depth < 2:
            for j in range(int(plan.integers(0, 3))):
                child = tag * 10 + j
                if plan.random() < 0.5:
                    handles.append(sim.schedule(float(plan.exponential(0.5)),
                                                lambda c=child, d=depth: fire(c, d + 1)))
                else:
                    sim.schedule_fast(float(plan.choice([0.0, 0.25, 1.0])),
                                      lambda c=child, d=depth: fire(c, d + 1))
        if handles and plan.random() < 0.3:
            sim.cancel(handles[int(plan.integers(0, len(handles)))])

    for tag in range(1, 25):
        handles.append(sim.schedule(float(plan.uniform(0, 3)), lambda t=tag: fire(t, 0)))
    sim.schedule_at(1.5, lambda: fire(99, 2))
    sim.run_until(t=2.0)
    mid = (sim.now, sim.events_processed)
    sim.run()
    return [trace, mid, sim.now, sim.events_processed]


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_event_order_cancel_and_jitter_match(seed):
    got = _both(_event_order, seed)
    assert got["port"] == got["ref"]
    assert len(got["port"][0]) > 24


def test_cancel_and_predicate_stops_match():
    def scenario(mod):
        sim = mod.Simulator(seed=3)
        fired = []
        evs = [sim.schedule(float(t), lambda t=t: fired.append((sim.now, t)))
               for t in range(10)]
        for ev in evs[::3]:
            sim.cancel(ev)
        sim.run_until(predicate=lambda: len(fired) >= 4)
        first = (list(fired), sim.now, sim.events_processed)
        sim.run_until(t=100.0)
        return first, fired, sim.now, sim.events_processed

    got = _both(scenario)
    assert got["port"] == got["ref"]
    assert [t for _, t in got["port"][1]] == [1, 2, 4, 5, 7, 8]


def test_negative_delays_and_past_timestamps_raise_alike():
    for mod in MODULES.values():
        sim = mod.Simulator()
        with pytest.raises(ValueError):
            sim.schedule(-1.0, lambda: None)
        with pytest.raises(ValueError):
            sim.schedule_fast(-1e-9, lambda: None)
        sim.schedule_fast(5.0, lambda: None)
        sim.run()
        with pytest.raises(ValueError):
            sim.schedule_at(4.0, lambda: None)


@pytest.mark.parametrize("seed", [0, 5])
def test_shared_resource_trace_matches(seed):
    """Processor sharing under staggered arrivals, zero work included."""
    def scenario(mod, seed):
        sim = mod.Simulator(seed=seed)
        res = mod.SharedResource(sim, capacity=1e6, name="fs")
        plan = np.random.default_rng(seed)
        done = []
        for i in range(40):
            work = 0.0 if i % 9 == 0 else float(plan.exponential(2e5))
            sim.schedule_fast(float(plan.uniform(0, 1.5)),
                              lambda i=i, w=work: res.submit(
                                  w, lambda i=i: done.append((sim.now, i, res.active_flows))))
        sim.run()
        return done, sim.now, sim.events_processed

    got = _both(scenario, seed)
    assert got["port"] == got["ref"]
    assert len(got["port"][0]) == 40


def test_simlock_handoff_trace_matches():
    """FIFO handoffs: synchronous when uncontended, queued otherwise."""
    def scenario(mod):
        sim = mod.Simulator(seed=11)
        lock = mod.SimLock(sim, name="model")
        log = []

        def worker(w: int, hold: float) -> None:
            def acquired() -> None:
                log.append(("acq", w, sim.now, lock.queue_len))
                sim.schedule_fast(sim.lognormal_jitter(hold, 0.08), release)

            def release() -> None:
                log.append(("rel", w, sim.now))
                lock.release()

            lock.acquire(acquired)

        for w in range(12):
            sim.schedule_fast(0.01 * (w % 4), lambda w=w: worker(w, 0.2 + 0.05 * w))
        sim.run()
        return log, sim.now

    got = _both(scenario)
    assert got["port"] == got["ref"]
    assert [e[1] for e in got["port"][0] if e[0] == "acq"] == \
        [e[1] for e in got["port"][0] if e[0] == "rel"]


@pytest.mark.parametrize("cv", [0.0, 0.03, 0.08, 0.5])
def test_lognormal_jitter_stream_matches(cv):
    def scenario(mod):
        sim = mod.Simulator(seed=42)
        return [sim.lognormal_jitter(2.5, cv) for _ in range(600)]

    got = _both(scenario)
    assert got["port"] == got["ref"]
    if cv == 0.0:
        assert set(got["port"]) == {2.5}


def test_normals_share_the_scalar_stream():
    """``normals(k)`` consumes the same 256-draw blocks as ``_next_normal``,
    across block edges, in both packages; ``jitter_coeffs`` fills the same
    cache as ``lognormal_jitter``."""
    def scenario(mod):
        sim = mod.Simulator(seed=9)
        a = [float(sim._next_normal()) for _ in range(100)]
        b = sim.normals(300).tolist()
        c = [sim.lognormal_jitter(1.0, 0.2) for _ in range(5)]
        coeffs = sim.jitter_coeffs(0.2)
        d = sim.normals(0).tolist() + sim.normals(257).tolist()
        return a, b, c, coeffs, d

    got = _both(scenario)
    assert got["port"] == got["ref"]
    a, b, _, (mu, sig), _ = got["port"]
    fresh = np.random.default_rng(9).standard_normal(512)
    assert a + b == fresh[:400].tolist()
    assert math.isclose(sig * sig, math.log1p(0.2 * 0.2)) and mu == -0.5 * math.log1p(0.2 * 0.2)
