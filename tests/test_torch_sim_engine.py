"""The port's engines against the reference's.

* ``SimStreamingEngine`` through ``run_experiment``: every cell of
  ``benchmarks/fig5_throughput.py``'s grid gives the reference's
  ``record()``, ``des_events`` and ``wall_virtual_s`` bit for bit, and a
  faulted serverless and wrangler cell, wired identically in both packages
  around one ``FaultInjector`` plan, give equal counters, fault ledgers and
  append -> complete latencies.
* ``ThreadedStreamingEngine``'s ticker, live repartitioning, partition
  stalls and straggler speculation, as ``tests/test_engine_conformance.py``
  checks them on the reference.  This module reads no wall clock: waits are
  ``threading.Event.wait`` with a timeout.
"""

import itertools
import math
import sys
import threading

import numpy as np
import pytest

from repro.core import miniapp as ref_miniapp
from repro.core.metrics import MetricRegistry as RefRegistry
from repro.core.metrics import new_run_id as ref_run_id
from repro.pilot import api as ref_api
from repro.streaming import engine as ref_engine
from repro.streaming import faults as ref_faults
from repro.streaming import producer as ref_producer
from repro.streaming.broker import Broker as RefBroker
from repro_torch.core import miniapp
from repro_torch.core.metrics import MetricRegistry, new_run_id
from repro_torch.pilot import api
from repro_torch.streaming import engine, faults, producer
from repro_torch.streaming.broker import Broker

from _sim_kmeans import KMeansMessageUpdate, message_points

FIG5 = [dict(machine=m, partitions=n, points=16000, centroids=c, n_messages=40, seed=3)
        for m in ("serverless", "wrangler") for c in (1024, 8192)
        for n in (1, 2, 4, 8, 16)]
PKGS = {
    "ref": dict(miniapp=ref_miniapp, api=ref_api, engine=ref_engine, faults=ref_faults,
                producer=ref_producer, Broker=RefBroker, Registry=RefRegistry,
                run_id=ref_run_id),
    "port": dict(miniapp=miniapp, api=api, engine=engine, faults=faults,
                 producer=producer, Broker=Broker, Registry=MetricRegistry,
                 run_id=new_run_id),
}


def _same(a, b) -> bool:
    """``==`` with NaN equal to NaN (empty percentile summaries)."""
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a):
        return math.isnan(b)
    return a == b


def _records_equal(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)


@pytest.mark.parametrize("cell", FIG5, ids=lambda c: f"{c['machine']}-c{c['centroids']}"
                                                       f"-N{c['partitions']}")
def test_fig5_cell_matches_reference(cell):
    ref = ref_miniapp.run_experiment(ref_miniapp.StreamExperiment(**cell))
    got = miniapp.run_experiment(miniapp.StreamExperiment(**cell))
    assert _records_equal(got.record(), ref.record())
    assert got.des_events == ref.des_events
    assert got.wall_virtual_s == ref.wall_virtual_s
    assert got.processed == cell["n_messages"] and got.faults is None


FAULT_PLAN = dict(seed=5, horizon_s=20.0, crash_rate_hz=0.5, duplicate_rate_hz=0.4,
                  stall_rate_hz=0.3, stall_s=1.0, preempt_times=[2.0, 5.0], preempt_count=1)


def _faulted_cell(pkg: dict, machine: str, retry_backoff_s: float) -> dict:
    """``run_experiment``'s wiring by hand, plus a ``FaultInjector`` armed
    after the producer and the engine start, in either package."""
    exp = pkg["miniapp"].StreamExperiment(machine=machine, partitions=4, points=8000,
                                          centroids=1024, n_messages=60, seed=2)
    metrics, run_id = pkg["Registry"](), pkg["run_id"]("faulted")
    pcs = pkg["api"].PilotComputeService(seed=exp.seed)
    pilot = pcs.submit_pilot(pkg["api"].PilotDescription(
        resource=exp.resource_url, memory_mb=exp.memory_mb, partitions=exp.partitions,
        concurrency=exp.partitions))
    sim = pilot.backend.sim
    broker = pkg["Broker"]()
    broker.create_topic("points", exp.partitions)
    wl = pkg["miniapp"].KMeansStreamWorkload(points=exp.points, centroids=exp.centroids,
                                             policy=exp.effective_policy,
                                             n_partitions=exp.partitions)
    profile = wl.profile()
    workload = pkg["engine"].Workload(profile_for=lambda msgs: profile, name="kmeans")
    prod = pkg["producer"]
    ingest = (prod.PartitionIngest(sim, exp.partitions, bw_per_partition=1e6)
              if machine == "serverless"
              else prod.SharedFsIngest(sim, pilot.backend.shared_resource(pilot, "fs")))
    producer_ = prod.SyntheticProducer(
        sim, broker, "points", n_messages=exp.n_messages, run_id=run_id, metrics=metrics,
        msg_factory=lambda i: (None, {"n_points": exp.points, "seed": i}, wl.msg_bytes),
        aimd=prod.AIMD(rate_hz=8.0, hi_watermark=16, lo_watermark=4), ingest=ingest)
    eng = pkg["engine"].SimStreamingEngine(
        sim, broker, "points", pilot, workload, metrics, run_id, batch_max=1,
        retry_backoff_s=retry_backoff_s, is_input_complete=lambda: producer_.done)
    injector = pkg["faults"].FaultInjector(pkg["faults"].FaultPlan.from_spec(FAULT_PLAN),
                                           eng, broker, "points", pilot,
                                           metrics=metrics, run_id=run_id)
    producer_.start()
    eng.start()
    armed = injector.start()
    eng.run_to_completion()
    core = eng.core
    out = dict(
        counters=[core.processed, core.failed_batches, core.abandoned, core.duplicates,
                  core.dup_delivered, core.retried, core.idle_fetches],
        ledger=[armed, injector.injected, injector.crashes, injector.preemptions,
                injector.stalls, injector.dup_injected, injector.skipped],
        latencies=metrics.latencies(run_id, "append", "complete").tolist(),
        retries=sorted((e.ts, e.attrs["attempt"], e.attrs["backoff"])
                       for e in metrics.events(run_id, kind="retry")),
        clock=[sim.now, sim.events_processed],
        units=[(cu.state.value, cu.start_ts, cu.end_ts) for cu in pilot.compute_units])
    pcs.close()
    return out


@pytest.mark.parametrize("machine", ["serverless", "wrangler"])
@pytest.mark.parametrize("retry_backoff_s", [0.0, 0.5])
def test_faulted_cell_matches_reference(machine, retry_backoff_s):
    got = {name: _faulted_cell(pkg, machine, retry_backoff_s) for name, pkg in PKGS.items()}
    assert got["port"] == got["ref"]
    counters, ledger = got["port"]["counters"], got["port"]["ledger"]
    assert counters[0] + counters[2] == 60               # processed + abandoned
    assert ledger[2] > 0 and ledger[5] > 0 and counters[4] == ledger[5]
    assert counters[5] > 0 and len(got["port"]["retries"]) == counters[5]


def test_run_experiment_with_faults_and_fn_keeps_the_virtual_record():
    """``fn`` runs once per message at completion without moving the clock;
    a fault plan leaves every message processed exactly once."""
    exp = miniapp.StreamExperiment(machine="serverless", partitions=4, points=8000,
                                   centroids=1024, n_messages=60, seed=2)
    seen = []
    plain = miniapp.run_experiment(exp, faults=FAULT_PLAN)
    carried = miniapp.run_experiment(
        exp, fn=lambda msgs: seen.extend(m.value["seed"] for m in msgs), faults=FAULT_PLAN)
    assert _records_equal(carried.record(), plain.record())
    assert (carried.des_events, carried.wall_virtual_s) == (plain.des_events,
                                                            plain.wall_virtual_s)
    assert carried.faults == plain.faults and carried.faults["injected"] > 0
    assert carried.processed == 60 and carried.dup_delivered == carried.faults["dup_injected"]
    assert sorted(set(seen)) == [2 * 100003 + i for i in range(60)]
    assert len(seen) >= 60 + carried.dup_delivered


def test_kmeans_update_rides_a_simulated_cell_on_the_cpu():
    """The real update as ``fn`` (asked for on the CPU): one call a message,
    payloads logged in completion order, the plain replay's model and
    inertias equal to the update's, and the cell's virtual record untouched."""
    import torch

    exp = miniapp.StreamExperiment(machine="wrangler", partitions=2, points=256,
                                   centroids=16, n_messages=12, seed=1)
    update = KMeansMessageUpdate(16, device="cpu", seed=2)
    carried = miniapp.run_experiment(exp, fn=update)
    plain = miniapp.run_experiment(exp)
    assert _records_equal(carried.record(), plain.record())
    assert update.calls == 12 and len(update.payloads) == 12
    assert sorted(p["seed"] for p in update.payloads) == [100003 + i for i in range(12)]
    assert float(update.inertia[-1]) < float(update.inertia[0])
    replay, replay_inertia = update.replay()
    assert torch.equal(replay.centroids, update.state.centroids)
    assert torch.equal(torch.stack(replay_inertia), torch.stack(update.inertia))
    assert float(update.state.counts.sum()) == 12 * 256
    pts = message_points({"n_points": 256, "seed": 5})
    assert pts.shape == (256, 9) and pts.dtype == np.float32
    assert np.array_equal(pts, message_points({"n_points": 256, "seed": 5}))


def test_metric_registry_queries_match_reference():
    """Series, counters, kind queries, steady-state throughput and the
    cross-process summaries, fed the same events in both packages."""
    from repro.core.metrics import Timer as RefTimer
    from repro_torch.core.metrics import Timer, TraceEvent

    rng = np.random.default_rng(6)
    events = [(f"r{int(rng.integers(0, 2))}", str(rng.choice(["engine", "broker"])),
               str(rng.choice(["append", "complete", "retry"])), float(rng.uniform(0, 50)),
               int(rng.integers(0, 40))) for _ in range(300)]
    worker = {"r9": {"engine/complete": [3, 1.5, 9.0]},
              "r0": {"engine/complete": [2, -1.0, 99.0], "x/y": [1, 2.0, 2.0]}}

    def scenario(Registry, TimerCls):
        m = Registry()
        for rid, comp, kind, ts, mid in events:
            m.record(rid, comp, kind, ts, msg_id=f"m{mid}")
        for i in range(50):
            m.observe("lag", 0.1 * i, float(rng_values[i]))
            m.incr("ticks", float(rng_values[i]))
        m.merge_summary(worker)
        m.merge_summary(worker)
        clock = iter([1.0, 3.5])
        with TimerCls(m, "timed", clock=lambda: next(clock)) as t:
            pass
        return (m.series("lag").tolist(), m.counter("ticks"), m.counter("none"),
                m.kind_count("r0", "complete"), m.kind_timestamps("r1", "append").tolist(),
                m.steady_state_throughput("r0"), m.steady_state_throughput("r1", "append", 0.5),
                m.throughput("r0", "retry"), m.latencies("r1", "append", "complete").tolist(),
                m.export_summary(), m.trace_summary("r9"), m.trace_summary("r0"),
                m.run_ids(), m.series("timed").tolist(), t.elapsed)

    rng_values = rng.standard_normal(50)
    got = scenario(MetricRegistry, Timer)
    assert got == scenario(RefRegistry, RefTimer)
    assert got[10] == {"engine/complete": [6, 1.5, 9.0]} and got[-1] == 2.5
    port = MetricRegistry()
    port.emit(TraceEvent("r", "engine", "complete", 1.0, {"msg_id": "a"}))
    assert port.kind_count("r", "complete") == 1


def test_engine_core_keywords_and_backoff_stream_match():
    """The constructors take the reference's keywords with its defaults,
    and the seeded backoff jitter is the reference's stream."""
    def delays(pkg, rng_seed=None, **kw):
        broker = pkg["Broker"]()
        broker.create_topic("t", 2)
        if rng_seed is not None:
            kw["rng"] = np.random.default_rng(rng_seed)
        core = pkg["engine"]._EngineCore(broker, "t", None, pkg["engine"].Workload(),
                                         pkg["Registry"](), "r", **kw)
        return [core.retry_delay(a) for a in range(1, 9)]

    for kw in (dict(retry_backoff_s=0.25), dict(retry_backoff_s=0.25, seed=9),
               dict(retry_backoff_s=1.0, retry_backoff_cap_s=3.0, rng_seed=4), dict()):
        assert delays(PKGS["port"], **kw) == delays(PKGS["ref"], **kw)
    broker = Broker()
    broker.create_topic("t", 1)
    eng = engine.ThreadedStreamingEngine(
        broker, "t", None, engine.Workload(), MetricRegistry(), "r", poll_interval=0.02,
        retry_backoff_s=0.1, straggler_mitigation=False, seed=3)
    assert (eng.poll_interval, eng.straggler_mitigation, eng.core.retry_backoff_s) == \
        (0.02, False, 0.1)
    assert eng.core.retry_delay(1) == delays(PKGS["ref"], retry_backoff_s=0.1, rng_seed=3)[0]


# -- the threaded engine -------------------------------------------------------------

class _ThreadBackend(api.Backend):
    """Each unit runs on a thread of its own, so a slow unit can be
    overtaken (the ``torch://`` pilot runs units inline).  This module reads
    no clock: every unit reports a runtime of 0.05 s, which sets the
    straggler timeout to 0.2 s (4x the median)."""

    scheme = "threads"

    def __init__(self, **_kw) -> None:
        pass

    def start_pilot(self, pilot) -> None:
        pilot.state = api.State.RUNNING

    def submit(self, pilot, cu) -> None:
        cu._set_running(0.0)

        def run() -> None:
            try:
                out = cu.desc.func() if cu.desc.func else None
            except Exception as exc:  # noqa: BLE001 — the unit carries it
                cu._set_failed(0.0, exc)
                return
            cu._set_done(0.05, out)

        threading.Thread(target=run, daemon=True).start()


api.register_backend("threads", _ThreadBackend)


class _Threaded:
    """A threaded engine on the ``threads://`` or ``torch://`` (CPU) pilot."""

    def __init__(self, fn, partitions=2, resource="torch://", **kw) -> None:
        self.pcs = api.PilotComputeService()
        self.pilot = self.pcs.submit_pilot(api.PilotDescription(
            resource=resource, attrs={"device": "cpu"}))
        self.broker = Broker()
        self.broker.create_topic("t", partitions)
        self.engine = engine.ThreadedStreamingEngine(
            self.broker, "t", self.pilot, engine.Workload(fn=fn), MetricRegistry(),
            new_run_id("threaded"), batch_max=1, poll_interval=0.005, **kw)
        self.clock = itertools.count()
        self.engine.start()

    def produce(self, values, partition=None) -> None:
        for v in values:
            self.broker.append("t", v, ts=float(next(self.clock)), partition=partition)

    def close(self) -> None:
        self.engine.stop(timeout=2.0)
        self.pcs.close()


def test_ticker_orders_rearms_and_surfaces_errors():
    h = _Threaded(fn=lambda msgs: None)
    try:
        order, done = [], threading.Event()

        def tick() -> None:
            order.append("tick")
            if order.count("tick") < 3:
                h.engine.call_later(0.005, tick)
            else:
                done.set()

        def boom() -> None:
            raise ValueError("tick failed")

        h.engine.call_later(0.5, lambda: order.append("late"))
        h.engine.call_later(0.0, boom)
        h.engine.call_later(0.0, lambda: order.append("first"))
        h.engine.call_later(0.01, tick)
        assert done.wait(10.0)
        late = threading.Event()
        h.engine.call_later(0.6, late.set)
        assert late.wait(10.0)
        assert order == ["first", "tick", "tick", "tick", "late"]
        assert isinstance(h.engine.ticker_error, ValueError)
        errors = h.engine.drain_ticker_errors()
        assert [str(e) for e in errors] == ["tick failed"]
        assert h.engine.drain_ticker_errors() == []
    finally:
        h.close()


def test_repartition_grow_shrink_and_append_race():
    h = _Threaded(fn=lambda msgs: None, partitions=2)
    try:
        core = h.engine.core
        h.produce(range(4))
        h.engine.drain(4, timeout=30)
        h.broker.repartition("t", 4)
        h.engine.repartition(migration_s=0.05)
        assert len(core.parts) == 4 and core.n_partitions == 4
        h.produce(range(8))                      # round-robin over 4 partitions
        h.engine.drain(12, timeout=30)
        assert [h.broker.committed("engine", "t", p) for p in range(4)] == [4, 4, 2, 2]
        h.broker.repartition("t", 2)             # seal partitions 2 and 3
        h.produce(range(4))
        h.engine.drain(16, timeout=30)
        assert [h.broker.committed("engine", "t", p) for p in range(4)] == [6, 6, 2, 2]
        h.broker.repartition("t", 6)             # no engine.repartition call
        h.produce(["x"], partition=5)
        h.engine.drain(17, timeout=30)
        assert h.broker.committed("engine", "t", 5) == 1
        assert sorted(h.engine._consumers) == list(range(6))
        assert len(h.engine.core.metrics.events(kind="migrate")) == 1
    finally:
        h.close()


def test_stall_partition_holds_dispatch_then_resumes():
    seen = {0: threading.Event(), 1: threading.Event()}
    h = _Threaded(fn=lambda msgs: seen[msgs[0].partition].set(), partitions=2)
    try:
        h.engine.stall_partition(0, 3600.0)
        h.produce(["a"], partition=0)
        h.produce(["b"], partition=1)
        assert seen[1].wait(10.0)
        assert not seen[0].wait(0.2)
        assert h.engine.core.parts[0].next_offset == 0
    finally:
        h.close()
    seen[0].clear()
    h = _Threaded(fn=lambda msgs: seen[msgs[0].partition].set(), partitions=2)
    try:
        h.engine.stall_partition(0, 0.05)
        h.produce(["a"], partition=0)
        assert seen[0].wait(10.0)
        h.engine.drain(1, timeout=30)
    finally:
        h.close()


def test_speculative_copy_wins_and_the_straggler_settles_as_duplicate():
    release, runs = threading.Event(), {}

    def fn(msgs) -> None:
        k = msgs[0].offset
        runs[k] = n = runs.get(k, 0) + 1
        if msgs[0].value == "straggler" and n == 1:
            release.wait(30.0)          # the stuck first execution

    h = _Threaded(fn=fn, partitions=1, resource="threads://")
    try:
        core = h.engine.core
        h.produce(range(4))
        h.engine.drain(4, timeout=30)               # >= 3 runtimes arm the check
        h.produce(["straggler"])
        h.engine.drain(5, timeout=30)               # the copy won
        assert runs[4] == 2 and core.duplicates == 0
        assert len(core.metrics.events(kind="straggler_dup")) == 1
        settled = threading.Event()
        h.pilot.compute_units[-2].add_done_callback(lambda cu: settled.set())
        release.set()
        assert settled.wait(30.0)
        assert core.duplicates == 1 and core.processed == 5
    finally:
        release.set()
        h.close()


def test_done_callbacks_fire_once_across_threads():
    pcs = api.PilotComputeService()
    pilot = pcs.submit_pilot(api.PilotDescription(resource="threads://"))
    counts = []
    for _ in range(200):
        go, both = threading.Event(), threading.Event()
        cu = pilot.submit_compute_unit(func=lambda go=go: go.wait(5.0))
        hits = []

        def hit(tag, hits=hits, both=both) -> None:
            hits.append(tag)
            if len(hits) >= 2:
                both.set()

        go.set()                 # the unit finishes while callbacks are added
        cu.add_done_callback(lambda c: hit(1))
        cu.add_done_callback(lambda c: hit(2))
        assert both.wait(5.0)
        counts.append(sorted(hits))
    assert all(c == [1, 2] for c in counts)
    pcs.close()


def test_concurrent_repartitions_and_counters_lose_nothing():
    """16 threads adopt 23 new partitions and bump one counter at once,
    with the interpreter switching threads as often as it can: each
    partition gets one state and one consumer, and no increment is lost."""
    switch = sys.getswitchinterval()
    h = _Threaded(fn=lambda msgs: None, partitions=1)
    try:
        entered, consume = [], h.engine._consume

        def counted(partition: int) -> None:
            entered.append(partition)
            consume(partition)

        h.engine._consume = counted
        metrics = h.engine.core.metrics
        h.broker.repartition("t", 24)
        barrier = threading.Barrier(16)

        def hammer() -> None:
            barrier.wait(10.0)
            h.engine.repartition()
            for _ in range(200):
                metrics.incr("hits", 0.5)

        sys.setswitchinterval(1e-6)
        threads = [threading.Thread(target=hammer) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60.0)
        sys.setswitchinterval(switch)
        assert not any(t.is_alive() for t in threads)
        assert sorted(entered) == list(range(1, 24))
        assert h.engine.core.n_partitions == 24 and sorted(h.engine.core.parts) == list(range(24))
        assert metrics.counter("hits") == 16 * 200 * 0.5
        for p in range(24):
            h.produce([p], partition=p)
        h.engine.drain(24, timeout=30)
        assert [h.broker.committed("engine", "t", p) for p in range(24)] == [1] * 24
    finally:
        sys.setswitchinterval(switch)
        h.close()
