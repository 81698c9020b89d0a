"""Declarative fault injection: failure semantics as a scenario axis.

Ports ``repro.streaming.faults``.

* ``FaultPlan`` — a seeded schedule of crashes and preemptions (explicit
  times or Poisson rates), partition stalls and duplicate redeliveries;
  ``events_for(horizon)`` expands the rates through one
  ``np.random.default_rng(seed)`` stream, so the same seed gives the same
  schedule.
* ``FaultInjector`` — fires a plan through the engine's ``call_later``
  (a DES event on the virtual clock, the ticker thread on the wall clock):
  crashes and preemptions through ``Backend.inject_crash``/``preempt``,
  stalls through ``engine.stall_partition``, duplicates as re-appends with
  the original stable ``msg_id``, which the engine settles as
  ``dup_delivered``.  ``window_dirty()`` is the latched "did anything fire"
  read of the control loop.

Plan spec (JSON-able; every key optional):

    dict(seed=0, horizon_s=120.0, crash_rate_hz=0.05,
         duplicate_rate_hz=0.1, stall_rate_hz=0.02, stall_s=5.0,
         preempt_times=[45.0, 80.0], preempt_count=4,
         events=[dict(t=30.0, kind="crash", count=2), ...])
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

__all__ = ["FaultEvent", "FaultPlan", "FaultInjector", "FAULT_KINDS",
           "expand_plan"]

FAULT_KINDS = ("crash", "stall", "duplicate", "preempt",
               "backend_outage", "grant_starvation")


@dataclass(frozen=True, slots=True)
class FaultEvent:
    """One scheduled fault.

    ``target`` is a partition index for stall/duplicate (``None`` → the
    injector picks round-robin over active partitions) and a federation
    member index for backend_outage/grant_starvation; ``duration_s`` is
    the stall/outage/starvation length; ``count`` the multiplicity for
    crash/preempt.
    """

    t: float
    kind: str
    target: int | None = None
    duration_s: float = 5.0
    count: int = 1

    @classmethod
    def from_spec(cls, spec: dict) -> "FaultEvent":
        kind = spec["kind"]
        if kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {kind!r}; known: {FAULT_KINDS}")
        return cls(t=float(spec["t"]), kind=kind,
                   target=spec.get("target"),
                   duration_s=float(spec.get("duration_s", 5.0)),
                   count=int(spec.get("count", 1)))

    def to_spec(self) -> dict:
        """Inverse of ``from_spec``: a JSON-able dict that round-trips
        losslessly (``FaultEvent.from_spec(e.to_spec()) == e``), so fault
        scenarios serialize into cache keys and fig8 cell descriptions."""
        spec: dict = dict(t=self.t, kind=self.kind,
                          duration_s=self.duration_s, count=self.count)
        if self.target is not None:
            spec["target"] = self.target
        return spec


@dataclass
class FaultPlan:
    """Seeded, declarative fault schedule (see module docstring for the
    JSON spec)."""

    seed: int = 0
    horizon_s: float = 120.0
    crash_rate_hz: float = 0.0
    duplicate_rate_hz: float = 0.0
    stall_rate_hz: float = 0.0
    stall_s: float = 5.0
    preempt_times: tuple = ()
    preempt_count: int = 1
    events: list = field(default_factory=list)     # explicit FaultEvents

    @classmethod
    def from_spec(cls, spec: dict, *, default_seed: int = 0,
                  default_horizon_s: float = 120.0) -> "FaultPlan":
        unknown = set(spec) - {"seed", "horizon_s", "crash_rate_hz",
                               "duplicate_rate_hz", "stall_rate_hz", "stall_s",
                               "preempt_times", "preempt_count", "events"}
        if unknown:
            raise ValueError(f"unknown FaultPlan keys: {sorted(unknown)}")
        return cls(
            seed=int(spec.get("seed", default_seed)),
            horizon_s=float(spec.get("horizon_s", default_horizon_s)),
            crash_rate_hz=float(spec.get("crash_rate_hz", 0.0)),
            duplicate_rate_hz=float(spec.get("duplicate_rate_hz", 0.0)),
            stall_rate_hz=float(spec.get("stall_rate_hz", 0.0)),
            stall_s=float(spec.get("stall_s", 5.0)),
            preempt_times=tuple(float(t) for t in spec.get("preempt_times", ())),
            preempt_count=int(spec.get("preempt_count", 1)),
            events=[FaultEvent.from_spec(e) for e in spec.get("events", ())],
        )

    def to_spec(self) -> dict:
        """Inverse of ``from_spec``: a JSON-able spec dict such that
        ``FaultPlan.from_spec(plan.to_spec()) == plan``."""
        return dict(seed=self.seed, horizon_s=self.horizon_s,
                    crash_rate_hz=self.crash_rate_hz,
                    duplicate_rate_hz=self.duplicate_rate_hz,
                    stall_rate_hz=self.stall_rate_hz, stall_s=self.stall_s,
                    preempt_times=list(self.preempt_times),
                    preempt_count=self.preempt_count,
                    events=[e.to_spec() for e in self.events])

    def _poisson_times(self, rng: np.random.Generator, rate_hz: float,
                       horizon: float) -> list[float]:
        """Deterministic Poisson arrivals on [0, horizon): exponential gaps
        accumulated from one seeded stream."""
        times: list[float] = []
        if rate_hz <= 0.0 or horizon <= 0.0:
            return times
        t = float(rng.exponential(1.0 / rate_hz))
        while t < horizon:
            times.append(t)
            t += float(rng.exponential(1.0 / rate_hz))
        return times

    def events_for(self, horizon_s: float | None = None) -> list[FaultEvent]:
        """Expand the plan into a concrete, time-sorted event list.

        Rates are sampled in a fixed kind order from one seeded stream, so
        the schedule is a pure function of the plan — the determinism the
        fault benchmark cells and the conformance tests rely on.
        """
        horizon = self.horizon_s if horizon_s is None else float(horizon_s)
        rng = np.random.default_rng(self.seed)
        out: list[FaultEvent] = []
        for t in self._poisson_times(rng, self.crash_rate_hz, horizon):
            out.append(FaultEvent(t=t, kind="crash"))
        for t in self._poisson_times(rng, self.duplicate_rate_hz, horizon):
            out.append(FaultEvent(t=t, kind="duplicate"))
        for t in self._poisson_times(rng, self.stall_rate_hz, horizon):
            out.append(FaultEvent(t=t, kind="stall", duration_s=self.stall_s))
        for t in self.preempt_times:
            out.append(FaultEvent(t=float(t), kind="preempt",
                                  count=self.preempt_count))
        out.extend(self.events)
        # (t, kind) sort: ties resolve identically on every run
        return sorted(out, key=lambda e: (e.t, e.kind, e.count))


def expand_plan(spec, *, default_seed: int = 0,
                default_horizon_s: float = 120.0) -> tuple["FaultPlan", list[FaultEvent]]:
    """Pre-expand a fault plan spec into ``(plan, events)``.

    This is the plan-side contract the fast replay (``sim.batched``)
    depends on: the entire fault schedule is known *before* the run
    starts — rates expand through one ``default_rng(plan.seed)`` stream
    at plan time, never at fire time — so a replay can arm the exact
    event list the scalar ``FaultInjector`` would arm, in the same
    order, without constructing an injector at all.

    ``spec`` is a JSON-able plan dict (see module docstring) or an
    already-built ``FaultPlan``; defaults mirror ``miniapp``'s wiring
    (``default_seed`` = experiment seed, ``default_horizon_s`` =
    experiment horizon).  The returned event list is exactly
    ``plan.events_for()`` — time-sorted with deterministic ties.
    """
    if isinstance(spec, FaultPlan):
        plan = spec
    else:
        plan = FaultPlan.from_spec(spec, default_seed=default_seed,
                                   default_horizon_s=default_horizon_s)
    return plan, plan.events_for()


class FaultInjector:
    """Binds a ``FaultPlan`` to a live pipeline and fires its events.

    Clock-agnostic by construction: every event is scheduled through the
    engine's ``call_later`` (DES event on the sim clock, ticker callback on
    the wall clock), and every action goes through clock-agnostic surfaces
    (backend fault hooks, ``engine.stall_partition``, ``broker.append``).
    On the wall-clock path all callbacks run on the single ticker thread —
    the same thread that runs control ticks — so the counters need no lock.
    """

    def __init__(self, plan: FaultPlan, engine, broker, topic: str, pilot, *,
                 metrics=None, run_id: str | None = None) -> None:
        self.plan = plan
        self.engine = engine
        self.broker = broker
        self.topic = topic
        self.pilot = pilot
        self.metrics = metrics
        self.run_id = run_id
        # outcome counters (the experiment report card reads these)
        self.injected = 0
        self.crashes = 0
        self.preemptions = 0
        self.stalls = 0
        self.dup_injected = 0
        self.outages = 0          # backend_outage events that acted
        self.starvations = 0      # grant_starvation events that acted
        self.skipped = 0          # events that found nothing to act on
        self._rr = 0              # deterministic round-robin target pick
        self._fired_since_probe = 0
        self._stall_until = 0.0

    # -- lifecycle -----------------------------------------------------------
    def start(self, horizon_s: float | None = None) -> int:
        """Schedule every plan event relative to ``engine.now()``; returns
        the number of events armed."""
        events = self.plan.events_for(horizon_s)
        for ev in events:
            self.engine.call_later(ev.t, lambda ev=ev: self._fire(ev))
        return len(events)

    # -- control-loop signal --------------------------------------------------
    def window_dirty(self) -> bool:
        """Latched read: True if any fault fired since the last probe, or a
        partition stall is still in effect.  The control loop calls this
        once per tick to mark fault epochs as unstable windows."""
        dirty = self._fired_since_probe > 0 \
            or self.engine.now() < self._stall_until
        self._fired_since_probe = 0
        return dirty

    # -- firing ----------------------------------------------------------------
    def _pick_partition(self, ev: FaultEvent) -> int:
        n = max(1, self.broker.num_partitions(self.topic))
        if ev.target is not None:
            return ev.target % n
        self._rr += 1
        return (self._rr - 1) % n

    def _fire(self, ev: FaultEvent) -> None:
        self.injected += 1
        self._fired_since_probe += 1
        acted = 0
        if ev.kind == "crash":
            acted = self.pilot.backend.inject_crash(self.pilot, ev.count)
            self.crashes += acted
        elif ev.kind == "preempt":
            acted = self.pilot.backend.preempt(self.pilot, ev.count)
            self.preemptions += acted
        elif ev.kind == "stall":
            p = self._pick_partition(ev)
            self.engine.stall_partition(p, ev.duration_s)
            until = self.engine.now() + ev.duration_s
            self._stall_until = max(self._stall_until, until)
            self.stalls += 1
            acted = 1
        elif ev.kind == "duplicate":
            acted = self._inject_duplicate(ev)
        elif ev.kind == "backend_outage":
            # federation-level fault: only backends exposing the hook (the
            # federated backend) can act; everything else skips gracefully
            fn = getattr(self.pilot.backend, "inject_outage", None)
            if fn is not None:
                acted = fn(self.pilot, member=ev.target,
                           duration_s=ev.duration_s)
                self.outages += 1 if acted else 0
        elif ev.kind == "grant_starvation":
            fn = getattr(self.pilot.backend, "inject_grant_starvation", None)
            if fn is not None:
                acted = fn(self.pilot, member=ev.target,
                           duration_s=ev.duration_s)
                self.starvations += 1 if acted else 0
        if not acted:
            self.skipped += 1
        if self.metrics is not None and self.run_id is not None:
            self.metrics.record(self.run_id, "fault", ev.kind,
                                self.engine.now(), count=ev.count, acted=acted)

    def _inject_duplicate(self, ev: FaultEvent) -> int:
        """Re-append the newest message of a partition with its original
        stable ``msg_id`` — the broker-side shape of a producer retry /
        redelivery.  The engine commits the new offset but settles the
        message as ``dup_delivered``, not ``processed``."""
        p = self._pick_partition(ev)
        end = self.broker.end_offset(self.topic, p)
        if end == 0:
            return 0
        orig = self.broker.fetch(self.topic, p, end - 1, 1)[0]
        self.broker.append(self.topic, orig.value, ts=self.engine.now(),
                           key=orig.key, partition=p, run_id=orig.run_id,
                           msg_id=orig.msg_id, size_bytes=orig.size_bytes)
        self.dup_injected += 1
        return 1
