"""The port's producer (rate programs, AIMD, ingest paths) and fault plans
against the reference's: the same specs and seeds through both packages
must give the same rates, integrals, controller traces, production traces
and fault schedules, bit for bit."""

import json

import numpy as np
import pytest

from repro.core.metrics import MetricRegistry as RefRegistry
from repro.sim.des import SharedResource as RefResource
from repro.sim.des import Simulator as RefSimulator
from repro.streaming import faults as ref_faults
from repro.streaming import producer as ref_producer
from repro.streaming.broker import Broker as RefBroker
from repro_torch.core.metrics import MetricRegistry
from repro_torch.sim.des import SharedResource, Simulator
from repro_torch.streaming import faults as port_faults
from repro_torch.streaming import producer as port_producer
from repro_torch.streaming.broker import Broker

PRODUCER = {"ref": (ref_producer, RefSimulator, RefResource, RefBroker, RefRegistry),
            "port": (port_producer, Simulator, SharedResource, Broker, MetricRegistry)}
FAULTS = {"ref": ref_faults, "port": port_faults}

RATE_SPECS = [
    dict(kind="constant", rate_hz=12.5),
    dict(kind="step", base_hz=2, high_hz=20, t_step=30),
    dict(kind="step", base_hz=3, high_hz=9, t_step=10, t_end=25),
    dict(kind="ramp", start_hz=1, end_hz=40, t0=5, t1=50),
    dict(kind="diurnal", mean_hz=10, amplitude=0.6, period_s=40, phase=0.3),
    dict(kind="burst", base_hz=2, burst_hz=30, burst_len_s=3, mean_gap_s=8, seed=4),
    dict(kind="sum", parts=[dict(kind="constant", rate_hz=1),
                            dict(kind="ramp", start_hz=0, end_hz=5, t0=0, t1=20)]),
    dict(kind="scale", factor=2.5, part=dict(kind="diurnal", mean_hz=4, amplitude=1.0,
                                             period_s=17)),
]
TIMES = np.linspace(0.0, 80.0, 97).tolist() + [5.0, 30.0, 50.0]


@pytest.mark.parametrize("spec", RATE_SPECS, ids=lambda s: s["kind"])
def test_rate_programs_from_spec_match(spec):
    def scenario(mod):
        prog = mod.rate_program_from_spec(json.loads(json.dumps(spec)))
        rates = [prog.rate(t) for t in TIMES]
        integrals = [prog.mean_messages(t0, t1)
                     for t0, t1 in [(0, 10), (3.5, 47.25), (20, 80), (9, 9), (50, 10)]]
        return rates, integrals, type(prog).__name__

    got = {name: scenario(mods[0]) for name, mods in PRODUCER.items()}
    assert got["port"] == got["ref"]
    assert all(r >= 0 for r in got["port"][0])


def test_custom_program_uses_the_numeric_integral_alike():
    def scenario(mod):
        class Square(mod.RateProgram):
            def rate(self, t):
                return 4.0 if int(t) % 2 else 1.0

        prog = Square() * 1.5 + mod.ConstantRate(2.0)
        return prog.mean_messages(0.0, 37.3), (3 * Square()).rate(1.2)

    got = {name: scenario(mods[0]) for name, mods in PRODUCER.items()}
    assert got["port"] == got["ref"]


@pytest.mark.parametrize("bad", [dict(rate_hz=1), dict(kind="warp"),
                                 dict(kind="sum", parts=[]),
                                 dict(kind="scale", factor=2, part=dict(kind="constant",
                                                                         rate_hz=1), x=1),
                                 dict(kind="diurnal", mean_hz=1, amplitude=2, period_s=1),
                                 dict(kind="ramp", start_hz=1, end_hz=2, t0=5, t1=5)])
def test_bad_rate_specs_raise_alike(bad):
    for mods in PRODUCER.values():
        with pytest.raises(ValueError):
            mods[0].rate_program_from_spec(bad)


def test_aimd_trace_matches():
    lags = np.random.default_rng(3).integers(0, 60, 400).tolist()

    def scenario(mod):
        ctl = mod.AIMD(rate_hz=5.0, hi_watermark=16, lo_watermark=2)
        return [ctl.update(lag) for lag in lags]

    got = {name: scenario(mods[0]) for name, mods in PRODUCER.items()}
    assert got["port"] == got["ref"]
    assert min(got["port"]) >= 0.5


@pytest.mark.parametrize("mode", ["aimd-shards", "aimd-fs", "program", "program-keys"])
def test_producer_traces_match(mode):
    """Closed-loop AIMD over Kinesis shards or the shared FS, and an
    open-loop program with a horizon (keyed routing in the last case)."""
    def scenario(mod, Sim, Res, Brk, Reg):
        sim, broker, metrics = Sim(seed=1), Brk(), Reg()
        broker.create_topic("t", 3)
        if mode == "aimd-shards":
            ingest = mod.PartitionIngest(sim, 3, bw_per_partition=2e5)
        elif mode == "aimd-fs":
            ingest = mod.SharedFsIngest(sim, Res(sim, 5e5, name="fs"))
        else:
            ingest = None
        keyed = mode == "program-keys"
        prod = mod.SyntheticProducer(
            sim, broker, "t", run_id="r", metrics=metrics, n_messages=150,
            msg_factory=lambda i: (f"k{i % 5}" if keyed else None, i, 1000 + 37 * i),
            aimd=mod.AIMD(rate_hz=6.0, hi_watermark=12, lo_watermark=3),
            ingest=ingest,
            rate_program=None if mode.startswith("aimd") else
            dict(kind="burst", base_hz=0, burst_hz=25, burst_len_s=1.5, mean_gap_s=2, seed=2),
            horizon_s=None if mode.startswith("aimd") else 12.0)
        committed = []

        def consume(msg):   # commits every second message, so lag moves
            if msg.offset % 2:
                broker.commit("engine", "t", msg.partition, msg.offset + 1)
                committed.append(msg.offset)

        broker.subscribe("t", consume)
        prod.start()
        sim.run()
        rows = sorted((e.ts, e.kind, e.attrs["msg_id"], e.attrs["partition"])
                      for e in metrics.events("r"))
        return rows, prod.sent, prod.appended, prod.done, broker.end_offsets("t"), committed

    got = {name: scenario(*mods) for name, mods in PRODUCER.items()}
    assert got["port"] == got["ref"]
    assert got["port"][3] and got["port"][1] == got["port"][2] > 0


PLAN_SPECS = [
    dict(crash_rate_hz=0.08, duplicate_rate_hz=0.05, stall_rate_hz=0.02, stall_s=3.0,
         preempt_times=[35.0, 70.0], preempt_count=2),
    dict(seed=11, horizon_s=300.0, crash_rate_hz=0.3,
         events=[dict(t=5.0, kind="stall", target=1, duration_s=2.5),
                 dict(t=5.0, kind="duplicate"), dict(t=1.0, kind="preempt", count=3),
                 dict(t=9.0, kind="backend_outage", target=0, duration_s=4.0)]),
    dict(),
]


@pytest.mark.parametrize("spec", PLAN_SPECS, ids=["rates", "explicit", "empty"])
@pytest.mark.parametrize("horizon", [None, 60.0])
def test_fault_plan_expansion_and_round_trip_match(spec, horizon):
    def scenario(mod):
        plan = mod.FaultPlan.from_spec(json.loads(json.dumps(spec)), default_seed=3,
                                       default_horizon_s=90.0)
        events = plan.events_for(horizon)
        again = mod.FaultPlan.from_spec(json.loads(json.dumps(plan.to_spec())))
        expanded = mod.expand_plan(spec, default_seed=3, default_horizon_s=90.0)[1]
        return ([e.to_spec() for e in events], plan.to_spec(), again == plan,
                [e.to_spec() for e in expanded],
                [mod.FaultEvent.from_spec(e.to_spec()) == e for e in events])

    got = {name: scenario(mod) for name, mod in FAULTS.items()}
    assert got["port"] == got["ref"]
    assert got["port"][2] and all(got["port"][4])


@pytest.mark.parametrize("bad", [dict(crash_rate=0.1), dict(events=[dict(t=1, kind="meteor")])])
def test_bad_fault_plans_raise_alike(bad):
    for mod in FAULTS.values():
        with pytest.raises(ValueError):
            mod.FaultPlan.from_spec(bad)
