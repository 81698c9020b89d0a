"""The port's Streaming Mini-App slice end to end on the CPU, plus parity of
its broker and metrics with the JAX package's.

producer -> Broker -> ThreadedStreamingEngine -> torch:// pilot -> MiniBatch
K-Means, as ``examples/quickstart.py`` builds it.  This module is
sim-classified by simlint (no wall clock), so append timestamps come from a
counter.
"""

import itertools
import threading

import jax
import numpy as np
import pytest
import torch

from repro.core.metrics import MetricRegistry as JaxMetricRegistry
from repro.core.metrics import percentile_summary as jax_percentile_summary
from repro.streaming.broker import Broker as JaxBroker
from repro.streaming.broker import stable_hash as jax_stable_hash
from repro_torch.core.metrics import MetricRegistry, new_run_id, percentile_summary
from repro_torch.models import kmeans
from repro_torch.pilot.api import PilotComputeService, PilotDescription, State
from repro_torch.streaming.broker import Broker, stable_hash
from repro_torch.streaming.engine import ThreadedStreamingEngine, Workload

N_MESSAGES, POINTS, DIM, CENTROIDS = 24, 512, 9, 32


def _clustered(rng, n_messages=N_MESSAGES):
    centers = rng.normal(size=(4, DIM)) * 3
    return [(centers[rng.integers(0, 4, POINTS)]
             + rng.normal(size=(POINTS, DIM))).astype(np.float32)
            for _ in range(n_messages)]


def _run_slice(fn, n_messages, partitions=2, max_retries=2, batch_max=2):
    """Drive ``fn(msgs)`` through the slice; returns (engine, metrics, run_id)."""
    pcs = PilotComputeService()
    pilot = pcs.submit_pilot(PilotDescription(resource="torch://",
                                              attrs={"device": "cpu"}))
    broker = Broker()
    broker.create_topic("points", partitions)
    metrics = MetricRegistry()
    run_id = new_run_id("torch-slice")
    engine = ThreadedStreamingEngine(broker, "points", pilot,
                                     Workload(fn=fn, name="kmeans"), metrics,
                                     run_id, batch_max=batch_max,
                                     max_retries=max_retries)
    engine.start()
    clock = itertools.count()
    try:
        for i, pts in enumerate(_clustered(np.random.default_rng(0), n_messages)):
            ts = float(next(clock))
            broker.append("points", pts, ts=ts, run_id=run_id,
                          msg_id=f"{run_id}/{i}", size_bytes=pts.nbytes)
            metrics.record(run_id, "broker", "append", ts, msg_id=f"{run_id}/{i}")
        engine.drain(n_messages, timeout=120)
    finally:
        engine.stop()
        pcs.close()
    return engine, metrics, run_id


def test_minibatch_kmeans_slice_on_cpu():
    gen = torch.Generator().manual_seed(0)
    state = kmeans.init_state(CENTROIDS, DIM, generator=gen, device="cpu")
    before, after = [], []
    lock = threading.Lock()

    def process(msgs):
        nonlocal state
        for m in msgs:
            pts = torch.from_numpy(m.value)
            with lock:
                before.append(float(kmeans.inertia(pts, state.centroids)))
                state = kmeans.minibatch_step(state, pts)
                after.append(float(kmeans.inertia(pts, state.centroids)))

    engine, metrics, run_id = _run_slice(process, N_MESSAGES)
    assert engine.core.processed == N_MESSAGES
    assert engine.core.abandoned == 0 and engine.core.retried == 0
    assert len(after) == N_MESSAGES
    assert after[-1] < before[0]            # the model learned the stream
    assert float(state.counts.sum()) == N_MESSAGES * POINTS
    lat = metrics.latencies(run_id, "append", "complete")
    assert lat.size == N_MESSAGES
    assert percentile_summary(lat)["count"] == N_MESSAGES
    assert len(metrics.events(run_id, "engine", "complete")) == N_MESSAGES


def test_failing_batches_are_retried_then_abandoned():
    calls = itertools.count()

    def flaky(msgs):
        if any(m.offset == 0 for m in msgs):
            raise ValueError("poison batch")
        next(calls)

    engine, _, _ = _run_slice(flaky, 8, partitions=2, max_retries=1, batch_max=1)
    core = engine.core
    # offset 0 of each partition fails twice (one retry), then is abandoned
    assert core.failed_batches == 2 and core.abandoned == 2
    assert core.retried == 4 and core.processed == 6 and next(calls) == 6
    assert core.broker.lag(core.group, core.topic) == 0


def test_redelivered_message_settles_once():
    pcs = PilotComputeService()
    pilot = pcs.submit_pilot(PilotDescription(resource="torch://",
                                              attrs={"device": "cpu"}))
    broker = Broker()
    broker.create_topic("t", 1)
    seen = []
    engine = ThreadedStreamingEngine(broker, "t", pilot,
                                     Workload(fn=lambda msgs: seen.extend(msgs)),
                                     MetricRegistry(), "r", batch_max=1)
    for i in range(3):
        broker.append("t", i, ts=float(i), msg_id=f"m{i}")
    broker.append("t", 1, ts=3.0, msg_id="m1")          # at-least-once redelivery
    engine.start()
    try:
        engine.drain(3, timeout=60)
    finally:
        engine.stop()
    core = engine.core
    assert core.processed == 3 and core.dup_delivered == 1
    assert [m.offset for m in seen] == [0, 1, 2, 3]
    assert broker.committed(core.group, "t", 0) == 4


def test_torch_pilot_runs_units_inline():
    pcs = PilotComputeService()
    pilot = pcs.submit_pilot(PilotDescription(resource="torch://",
                                              attrs={"device": "cpu"}))
    assert pilot.device == torch.device("cpu")
    cu = pilot.submit_compute_unit(func=lambda a: a * 2, args=(21,))
    assert cu.state == State.DONE and cu.result(timeout=1) == 42
    bad = pilot.submit_compute_unit(func=lambda: 1 / 0)
    assert bad.state == State.FAILED
    with pytest.raises(ZeroDivisionError):
        bad.result(timeout=1)
    pilot.wait_all(timeout=1)
    with pytest.raises(ValueError, match="no backend"):
        pcs.submit_pilot(PilotDescription(resource="nowhere://"))


def test_torch_pilot_raises_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        PilotComputeService().submit_pilot(PilotDescription(resource="torch://"))


def _broker_script(broker):
    """The same operations on either package's broker; returns what it saw."""
    seen = []
    broker.create_topic("t", 3)
    broker.subscribe("t", lambda m: seen.append((m.partition, m.offset, m.msg_id)))
    for i in range(7):
        broker.append("t", i, ts=float(i), key=None if i % 2 else f"k{i}")
    broker.append("t", "again", ts=9.0, partition=1, msg_id="t/0/0")
    broker.commit("g", "t", 0, 2)
    broker.commit("g", "t", 0, 1)            # commits never move back
    fetched = [[m.value for m in broker.fetch("t", p, 0, 10)] for p in range(3)]
    return (seen, fetched, broker.end_offsets("t"), broker.lag("g", "t"),
            broker.committed("g", "t", 0), broker.total_messages("t"),
            broker.appended_total("t"))


def test_broker_matches_jax_broker():
    assert _broker_script(Broker()) == _broker_script(JaxBroker())
    for key in ("a", b"b", 7, ("x", 1)):
        assert stable_hash(key) == jax_stable_hash(key)


def test_metrics_match_jax_registry():
    rng = np.random.default_rng(5)
    ours, theirs = MetricRegistry(), JaxMetricRegistry()
    appends = np.cumsum(rng.exponential(size=40))
    done = appends + rng.exponential(size=40)
    for reg in (ours, theirs):
        rec = reg.recorder("r", "engine", "complete")
        for i, (a, c) in enumerate(zip(appends, done)):
            reg.record("r", "broker", "append", float(a), msg_id=i)
            rec(float(c), msg_id=i)
    np.testing.assert_array_equal(ours.latencies("r", "append", "complete"),
                                  theirs.latencies("r", "append", "complete"))
    assert ours.throughput("r", "complete") == theirs.throughput("r", "complete")
    assert percentile_summary(done - appends) == jax_percentile_summary(done - appends)
    assert [(e.component, e.kind, e.ts, e.attrs) for e in ours.events("r")] \
        == [(e.component, e.kind, e.ts, e.attrs) for e in theirs.events("r")]
    assert ours.latencies("none", "append", "complete").size == 0
