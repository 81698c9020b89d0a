"""The port's federated backend against the JAX package's.

``tests/test_federated.py``'s simulated cells (fault free, a member outage
on either member, grant starvation, an outage on a plain backend) and fig8's
federation scenarios give the reference's report cards, traces and member
ledgers bit for bit; spec validation raises what the reference raises; the
sim engine's failover keeps the reference's commits, message for message.
"""

from collections import defaultdict

import pytest

from repro.core import miniapp as ref
from repro.core.metrics import MetricRegistry as RefRegistry
from repro.pilot import api as ref_api
from repro.streaming import broker as ref_broker
from repro.streaming import engine as ref_engine
from repro_torch.core import miniapp as port
from repro_torch.core.metrics import MetricRegistry
from repro_torch.pilot import api as port_api
from repro_torch.streaming import broker as port_broker
from repro_torch.streaming import engine as port_engine

MEMBERS = [
    dict(name="aws", machine="serverless", price=1.0, usl=(0.05, 1e-3, 2.0)),
    dict(name="wrangler", machine="wrangler", price=0.6, usl=(0.1, 5e-4, 1.9),
         grant_latency_s=10.0),
]
TWINS = [dict(machine="serverless", name="a"), dict(machine="serverless", name="b")]


def _fed_cell(**kw) -> dict:
    """tests/test_federated.py's federated cell, with ``kw`` overriding."""
    return {**dict(machine="federated", federation=dict(members=[dict(m) for m in MEMBERS]),
                   scaling_policy="usl", policy="update_locked", usl_sigma=0.05,
                   usl_kappa=1e-3, usl_gamma=2.0,
                   rate=dict(kind="step", base_hz=2.0, high_hz=8.0, t_step=20.0),
                   horizon_s=90.0, control_interval_s=2.0, initial_partitions=2,
                   max_partitions=8, points=2000, centroids=256, seed=0,
                   max_retries=5, retry_backoff_s=0.1), **kw}


def _outage(target, t=30.0, duration_s=15.0):
    return dict(events=[dict(t=t, kind="backend_outage", target=target,
                             duration_s=duration_s)])


CELLS = {
    "fault-free": _fed_cell(),
    "outage-0": _fed_cell(faults=_outage(0)),
    "outage-1": _fed_cell(faults=_outage(1)),
    "starvation": _fed_cell(faults=dict(events=[dict(t=15.0, kind="grant_starvation",
                                                      target=1, duration_s=60.0)])),
    "plain-backend": _fed_cell(machine="serverless", federation=None, faults=_outage(1)),
    "twins-outage": _fed_cell(federation=dict(members=[dict(m) for m in TWINS]),
                              faults=_outage(0, t=20.0, duration_s=25.0), seed=3),
    # fig8's federation scenarios (fed_design): outage of member 0 for 25 s at
    # 45 s, a deeper retry budget, 120 s
    "fig8-mix": _fed_cell(federation=dict(members=[
        dict(name="serverless", machine="serverless", usl=(0.0, 3e-4, 1.94), price=1.0,
             grant_latency_s=0.0),
        dict(name="wrangler", machine="wrangler", usl=(0.3, 2e-3, 1.3), price=0.6,
             grant_latency_s=10.0)]),
        faults=_outage(0, t=45.0, duration_s=25.0), usl_sigma=0.0, usl_kappa=3e-4,
        usl_gamma=1.94, horizon_s=120.0, max_retries=12, seed=1),
    "fig8-wrangler": _fed_cell(federation=dict(members=[
        dict(name="wrangler", machine="wrangler", usl=(0.3, 2e-3, 1.3), price=0.6,
             grant_latency_s=10.0)]),
        faults=_outage(0, t=45.0, duration_s=25.0), usl_sigma=0.3, usl_kappa=2e-3,
        usl_gamma=1.3, horizon_s=120.0, max_retries=12, seed=2),
}


def _same(a, b) -> bool:
    if isinstance(a, float) and isinstance(b, float) and a != a and b != b:
        return True
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    return a == b


@pytest.mark.parametrize("name", list(CELLS))
def test_federated_cell_equals_reference(name):
    kw = CELLS[name]
    got = port.run_adaptation(port.AdaptationExperiment(**kw))
    want = ref.run_adaptation(ref.AdaptationExperiment(**kw))
    assert _same(got.record(), want.record())
    assert _same(got.latency_px, want.latency_px)
    for field in ("alloc_trace", "lag_trace", "member_ledger", "tick_error_log",
                  "final_allocation", "drained", "drain_s", "wall_virtual_s", "des_events",
                  "refits"):
        assert getattr(got, field) == getattr(want, field), field
    assert got.drained and got.lost == 0
    if kw["machine"] == "federated":
        assert all(m["dirty_samples"] == 0 for m in got.member_ledger)


@pytest.mark.parametrize("name", ["fault-free", "fig8-mix"])
def test_federated_plan_falls_back_as_the_reference(name):
    kw = CELLS[name]
    got = port.run_plan(port.AdaptationPlan(experiment=port.AdaptationExperiment(**kw)))
    want = ref.run_plan(ref.AdaptationPlan(experiment=ref.AdaptationExperiment(**kw)))
    assert not got.fast_path and got.fallback_reason == want.fallback_reason
    assert "federated" in got.fallback_reason
    assert _same(got.record(), want.record()) and got.member_ledger == want.member_ledger


def _submit_into(pcs, api, members=None, partitions=4, **fed_kw):
    return pcs.submit_pilot(api.PilotDescription(
        resource="federated://mix", partitions=partitions, concurrency=partitions,
        attrs=dict(federation=dict(members=members or [dict(m) for m in MEMBERS],
                                   **fed_kw))))


def _submit(api, members=None):
    pcs = api.PilotComputeService(seed=0)
    return pcs, _submit_into(pcs, api, members)


@pytest.mark.parametrize("kwargs,match", [
    (dict(members=[dict(resource="federated://mix")]), "do not nest"),
    (dict(open_cooldwn_s=5.0), "unknown federation keys"),
])
def test_spec_validation_raises_as_the_reference(kwargs, match):
    for api in (port_api, ref_api):
        pcs = api.PilotComputeService(seed=0)
        try:
            with pytest.raises(ValueError, match=match):
                _submit_into(pcs, api, **kwargs)
        finally:
            pcs.close()
        pcs = api.PilotComputeService(seed=0)
        try:
            with pytest.raises(ValueError, match="members"):
                pcs.submit_pilot(api.PilotDescription(resource="federated://mix"))
        finally:
            pcs.close()


@pytest.mark.parametrize("members,target", [
    (TWINS, 8), ([dict(machine="serverless", name="dear", price=1.0),
                  dict(machine="serverless", name="cheap", price=0.5)], 6),
    (MEMBERS, 5)])
def test_placement_and_ledger_equal_reference(members, target):
    ledgers = []
    for api in (port_api, ref_api):
        pcs, pilot = _submit(api, members=[dict(m) for m in members])
        try:
            backend = pilot.backend
            assert backend.scale_to(pilot, target) == target
            backend.drive_until(lambda: backend.effective_allocation(pilot) >= target,
                                timeout=300.0)
            preempted = backend.preempt(pilot, 2)
            ledgers.append((preempted, backend.allocation(pilot),
                            backend.effective_allocation(pilot),
                            backend.member_ledger(pilot)))
        finally:
            pcs.close()
    assert ledgers[0] == ledgers[1]


def _failover_commits(api, broker_mod, engine_mod, metrics, member, run_s, shrink_to):
    """tests/test_federated.py's harness: a federated pilot under the sim
    engine, an outage of ``member`` after ``run_s`` virtual seconds, then a
    shrink to ``shrink_to`` partitions; returns every commit in order and
    the ledger."""
    pcs, pilot = _submit(api, members=[dict(m) for m in TWINS])
    backend = pilot.backend
    broker = broker_mod.Broker()
    broker.create_topic("t", 4)
    commits = defaultdict(list)
    inner = broker.commit

    def recording_commit(group, topic, partition, offset):
        commits[partition].append(offset)
        inner(group, topic, partition, offset)

    broker.commit = recording_commit
    done = []
    profile = api.TaskProfile(flops=1e7)
    engine = engine_mod.SimStreamingEngine(
        backend.sim, broker, "t", pilot,
        engine_mod.Workload(profile_for=lambda msgs: profile, name="fed-conform"),
        metrics, "fed-conform", batch_max=2, max_retries=5,
        is_input_complete=lambda: bool(done))
    engine.start()
    produced = 0
    try:
        for p in range(4):
            for v in range(6):
                broker.append("t", v, ts=engine.now(), partition=p, run_id="fed-conform")
                produced += 1
        backend.sim.run_until(t=backend.sim.now + run_s)
        backend.inject_outage(pilot, member=member, duration_s=3.0)
        broker.repartition("t", shrink_to)
        engine.repartition()
        for v in range(4):
            broker.append("t", v, ts=engine.now(), run_id="fed-conform")
            produced += 1
        done.append(True)
        engine.run_to_completion()
        core = engine.core
        assert core.processed + core.abandoned == produced
        for p, end in enumerate(broker.end_offsets("t")):
            assert broker.committed("engine", "t", p) == end
        for seq in commits.values():
            assert seq == sorted(seq)
        return dict(commits), core.processed, backend.sim.now, backend.member_ledger(pilot)
    finally:
        pcs.close()


@pytest.mark.parametrize("member,run_s,shrink_to", [(0, 0.5, 2), (1, 0.1, 1), (0, 2.0, 4),
                                                    (1, 1.3, 3)])
def test_sim_failover_commits_equal_reference(member, run_s, shrink_to):
    got = _failover_commits(port_api, port_broker, port_engine, MetricRegistry(), member,
                            run_s, shrink_to)
    want = _failover_commits(ref_api, ref_broker, ref_engine, RefRegistry(), member,
                             run_s, shrink_to)
    assert got == want
