"""Synthetic data producer: intelligent backoff or open-loop rate programs.

Ports ``repro.streaming.producer``.  Closed loop (paper §IV): AIMD on the
production rate, driven by the consumer group's lag, so production settles
just under the system's maximum sustained throughput.  Open loop (paper
§V): a ``RateProgram`` imposes the incoming rate r(t) — constant, step,
ramp, diurnal sine, Poisson-modulated bursts, and ``+`` / ``*``
combinators, built from JSON-able specs (``rate_program_from_spec``);
``mean_messages(t0, t1)`` is the integral of r.  The programs are plain
functions of time, so a wall-clock producer can pace appends with them too.

Ingest: Kinesis shards cap ingest per partition (``PartitionIngest``),
Kafka appends ride the HPC backend's shared filesystem
(``SharedFsIngest``).
"""

from __future__ import annotations

import bisect
import math
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np

from repro_torch.core.metrics import MetricRegistry
from repro_torch.sim.des import SharedResource, Simulator
from repro_torch.streaming.broker import Broker

__all__ = ["AIMD", "PartitionIngest", "SyntheticProducer", "RateProgram",
           "ConstantRate", "StepRate", "RampRate", "DiurnalRate", "BurstyRate",
           "rate_program_from_spec"]


# -- time-varying rate programs ----------------------------------------------

class RateProgram:
    """Deterministic rate trace r(t) ≥ 0 on the virtual clock.

    Programs compose: ``a + b`` superimposes rates, ``a * k`` scales one.
    ``mean_messages(t0, t1)`` is ∫r dt — exact for every built-in program,
    midpoint-rule numeric for arbitrary compositions that do not override
    it.
    """

    def rate(self, t: float) -> float:
        raise NotImplementedError

    def mean_messages(self, t0: float, t1: float) -> float:
        """Expected messages in [t0, t1] (∫ r dt); numeric fallback."""
        if t1 <= t0:
            return 0.0
        n = max(64, min(8192, int((t1 - t0) * 8)))
        mids = np.linspace(t0, t1, n, endpoint=False) + (t1 - t0) / (2 * n)
        return float(sum(self.rate(float(t)) for t in mids) * (t1 - t0) / n)

    def __add__(self, other: "RateProgram") -> "RateProgram":
        return _SumRate(self, other)

    def __mul__(self, k: float) -> "RateProgram":
        return _ScaledRate(self, float(k))

    __rmul__ = __mul__


class _SumRate(RateProgram):
    def __init__(self, a: RateProgram, b: RateProgram) -> None:
        self.a, self.b = a, b

    def rate(self, t: float) -> float:
        return self.a.rate(t) + self.b.rate(t)

    def mean_messages(self, t0: float, t1: float) -> float:
        return self.a.mean_messages(t0, t1) + self.b.mean_messages(t0, t1)


class _ScaledRate(RateProgram):
    def __init__(self, inner: RateProgram, k: float) -> None:
        self.inner, self.k = inner, k

    def rate(self, t: float) -> float:
        return self.k * self.inner.rate(t)

    def mean_messages(self, t0: float, t1: float) -> float:
        return self.k * self.inner.mean_messages(t0, t1)


class ConstantRate(RateProgram):
    def __init__(self, rate_hz: float) -> None:
        self.rate_hz = float(rate_hz)

    def rate(self, t: float) -> float:
        return self.rate_hz

    def mean_messages(self, t0: float, t1: float) -> float:
        return self.rate_hz * max(t1 - t0, 0.0)


class StepRate(RateProgram):
    """Piecewise-constant: ``base_hz`` until ``t_step``, then ``high_hz``
    (until optional ``t_end``, after which the rate falls back to base)."""

    def __init__(self, base_hz: float, high_hz: float, t_step: float,
                 t_end: float | None = None) -> None:
        self.base_hz = float(base_hz)
        self.high_hz = float(high_hz)
        self.t_step = float(t_step)
        self.t_end = float(t_end) if t_end is not None else None

    def rate(self, t: float) -> float:
        if t < self.t_step:
            return self.base_hz
        if self.t_end is not None and t >= self.t_end:
            return self.base_hz
        return self.high_hz

    def mean_messages(self, t0: float, t1: float) -> float:
        if t1 <= t0:
            return 0.0
        hi_end = self.t_end if self.t_end is not None else t1
        hi = max(0.0, min(t1, hi_end) - max(t0, self.t_step))
        return self.base_hz * (t1 - t0 - hi) + self.high_hz * hi


class RampRate(RateProgram):
    """Linear ramp from ``start_hz`` at ``t0`` to ``end_hz`` at ``t1``,
    constant outside the ramp window."""

    def __init__(self, start_hz: float, end_hz: float, t0: float, t1: float) -> None:
        if t1 <= t0:
            raise ValueError("ramp needs t1 > t0")
        self.start_hz, self.end_hz = float(start_hz), float(end_hz)
        self.t0, self.t1 = float(t0), float(t1)

    def rate(self, t: float) -> float:
        if t <= self.t0:
            return self.start_hz
        if t >= self.t1:
            return self.end_hz
        frac = (t - self.t0) / (self.t1 - self.t0)
        return self.start_hz + frac * (self.end_hz - self.start_hz)

    def mean_messages(self, t0: float, t1: float) -> float:
        if t1 <= t0:
            return 0.0
        # exact: piecewise (constant, linear, constant); the linear piece's
        # integral is the trapezoid of its endpoint rates
        total = 0.0
        lo = max(t0, self.t0)
        hi = min(t1, self.t1)
        if t0 < self.t0:
            total += self.start_hz * (min(t1, self.t0) - t0)
        if hi > lo:
            total += 0.5 * (self.rate(lo) + self.rate(hi)) * (hi - lo)
        if t1 > self.t1:
            total += self.end_hz * (t1 - max(t0, self.t1))
        return total


class DiurnalRate(RateProgram):
    """Sinusoidal load curve: ``mean_hz * (1 + amplitude*sin(...))`` with
    period ``period_s`` (amplitude is a fraction of the mean, ≤ 1)."""

    def __init__(self, mean_hz: float, amplitude: float, period_s: float,
                 phase: float = 0.0) -> None:
        if not 0.0 <= amplitude <= 1.0:
            raise ValueError("amplitude is a fraction of the mean (0..1)")
        self.mean_hz = float(mean_hz)
        self.amplitude = float(amplitude)
        self.period_s = float(period_s)
        self.phase = float(phase)

    def _angle(self, t: float) -> float:
        return 2.0 * math.pi * t / self.period_s + self.phase

    def rate(self, t: float) -> float:
        return self.mean_hz * (1.0 + self.amplitude * math.sin(self._angle(t)))

    def mean_messages(self, t0: float, t1: float) -> float:
        if t1 <= t0:
            return 0.0
        w = 2.0 * math.pi / self.period_s
        anti = lambda t: self.mean_hz * (t - self.amplitude / w   # noqa: E731
                                         * math.cos(self._angle(t)))
        return anti(t1) - anti(t0)


class BurstyRate(RateProgram):
    """Poisson-modulated bursts: ``base_hz`` background plus ``burst_hz``
    during burst windows.  Burst starts arrive as a Poisson process with
    mean gap ``mean_gap_s`` (exponential inter-arrivals drawn from
    ``seed``); each burst lasts ``burst_len_s``.  Fully deterministic given
    the seed — windows are generated lazily and memoized, so two programs
    built from the same spec agree everywhere."""

    def __init__(self, base_hz: float, burst_hz: float, burst_len_s: float,
                 mean_gap_s: float, seed: int = 0) -> None:
        self.base_hz = float(base_hz)
        self.burst_hz = float(burst_hz)
        self.burst_len_s = float(burst_len_s)
        self.mean_gap_s = float(mean_gap_s)
        self.seed = int(seed)
        self._rng = np.random.default_rng(self.seed)
        self._starts: list[float] = []
        self._next_start = float(self._rng.exponential(self.mean_gap_s))

    def _extend_to(self, t: float) -> None:
        while self._next_start <= t:
            self._starts.append(self._next_start)
            self._next_start += self.burst_len_s + float(
                self._rng.exponential(self.mean_gap_s))

    def _in_burst(self, t: float) -> bool:
        self._extend_to(t)
        i = bisect.bisect_right(self._starts, t)
        return i > 0 and t < self._starts[i - 1] + self.burst_len_s

    def rate(self, t: float) -> float:
        return self.base_hz + (self.burst_hz if self._in_burst(t) else 0.0)

    def mean_messages(self, t0: float, t1: float) -> float:
        if t1 <= t0:
            return 0.0
        self._extend_to(t1)
        burst = sum(max(0.0, min(t1, s + self.burst_len_s) - max(t0, s))
                    for s in self._starts)
        return self.base_hz * (t1 - t0) + self.burst_hz * burst


_RATE_KINDS = {
    "constant": ConstantRate,
    "step": StepRate,
    "ramp": RampRate,
    "diurnal": DiurnalRate,
    "burst": BurstyRate,
}


def rate_program_from_spec(spec) -> RateProgram:
    """Build a ``RateProgram`` from a JSON-able spec.

    ``{"kind": "step", "base_hz": 2, "high_hz": 20, "t_step": 30}`` etc.;
    ``{"kind": "sum", "parts": [spec, ...]}`` and
    ``{"kind": "scale", "factor": k, "part": spec}`` compose.  An existing
    ``RateProgram`` passes through unchanged, so callers accept either."""
    if isinstance(spec, RateProgram):
        return spec
    if not isinstance(spec, dict) or "kind" not in spec:
        raise ValueError(f"rate spec must be a dict with 'kind': {spec!r}")
    kw = {k: v for k, v in spec.items() if k != "kind"}
    kind = spec["kind"]
    if kind == "sum":
        parts = [rate_program_from_spec(p) for p in kw.pop("parts")]
        if kw or not parts:
            raise ValueError(f"bad sum spec: {spec!r}")
        out = parts[0]
        for p in parts[1:]:
            out = out + p
        return out
    if kind == "scale":
        part, factor = kw.pop("part"), float(kw.pop("factor"))
        if kw:
            raise ValueError(f"bad scale spec (unknown keys {sorted(kw)}): {spec!r}")
        return rate_program_from_spec(part) * factor
    if kind not in _RATE_KINDS:
        raise ValueError(f"unknown rate kind {kind!r}; "
                         f"known: {sorted(_RATE_KINDS) + ['sum', 'scale']}")
    return _RATE_KINDS[kind](**kw)


@dataclass
class AIMD:
    """Additive-increase / multiplicative-decrease rate controller."""

    rate_hz: float = 20.0
    min_rate_hz: float = 0.5
    max_rate_hz: float = 5000.0
    increase_hz: float = 2.0
    decrease_factor: float = 0.7
    lo_watermark: int = 4
    hi_watermark: int = 32

    def update(self, lag: int) -> float:
        if lag >= self.hi_watermark:
            self.rate_hz = max(self.rate_hz * self.decrease_factor, self.min_rate_hz)
        elif lag <= self.lo_watermark:
            self.rate_hz = min(self.rate_hz + self.increase_hz, self.max_rate_hz)
        return self.rate_hz


class PartitionIngest:
    """Per-partition ingest bandwidth limit (Kinesis: ~1 MB/s per shard)."""

    def __init__(self, sim: Simulator, partitions: int, bw_per_partition: float = 1e6,
                 request_latency: float = 0.01) -> None:
        self.request_latency = request_latency
        self.resources = [SharedResource(sim, bw_per_partition, name=f"shard{i}")
                          for i in range(partitions)]
        self.sim = sim

    def submit(self, partition: int, size_bytes: int, on_done: Callable[[], None]) -> None:
        res = self.resources[partition % len(self.resources)]
        self.sim.schedule_fast(self.request_latency,
                               lambda: res.submit(float(size_bytes), on_done))


class SharedFsIngest:
    """Kafka-on-HPC ingest: appends ride the shared filesystem resource."""

    def __init__(self, sim: Simulator, fs: SharedResource, request_latency: float = 0.002) -> None:
        self.sim = sim
        self.fs = fs
        self.request_latency = request_latency

    def submit(self, partition: int, size_bytes: int, on_done: Callable[[], None]) -> None:
        self.sim.schedule_fast(self.request_latency,
                               lambda: self.fs.submit(float(size_bytes), on_done))


class _ImmediateIngest:
    def submit(self, partition: int, size_bytes: int, on_done: Callable[[], None]) -> None:
        on_done()


class SyntheticProducer:
    """Rate-controlled producer on the virtual clock.

    ``msg_factory(i)`` returns ``(key, value, size_bytes)`` for message i.

    Two rate modes: closed-loop AIMD backoff (default; converges to max
    sustained throughput, the paper's measurement operating point), or an
    open-loop ``rate_program`` over ``horizon_s`` virtual seconds (the
    adaptation experiments' externally imposed incoming rate — the system
    scales, the workload does not back off).
    """

    def __init__(
        self,
        sim: Simulator,
        broker: Broker,
        topic: str,
        *,
        msg_factory: Callable[[int], tuple[Any, Any, int]],
        n_messages: int,
        run_id: str,
        metrics: MetricRegistry,
        group: str = "engine",
        aimd: AIMD | None = None,
        ingest=None,
        rate_program: RateProgram | dict | None = None,
        horizon_s: float | None = None,
        idle_resolution_s: float = 0.25,
    ) -> None:
        self.sim = sim
        self.broker = broker
        self.topic = topic
        self.msg_factory = msg_factory
        self.n_messages = n_messages
        self.run_id = run_id
        self.metrics = metrics
        self.group = group
        self.aimd = aimd or AIMD()
        self.ingest = ingest or _ImmediateIngest()
        self.rate_program = (rate_program_from_spec(rate_program)
                             if rate_program is not None else None)
        self.horizon_s = horizon_s
        self.idle_resolution_s = idle_resolution_s
        self.sent = 0
        self.appended = 0
        self.done = False
        self._production_over = False
        self._rec_produce = metrics.recorder(run_id, "producer", "produce")
        self._rec_append = metrics.recorder(run_id, "broker", "append")

    def start(self) -> None:
        self.sim.schedule_fast(
            0.0, self._tick_program if self.rate_program is not None
            else self._tick)

    def _emit_one(self) -> None:
        """Produce message ``sent`` and submit it to the ingest path."""
        i = self.sent
        self.sent += 1
        key, value, size = self.msg_factory(i)
        msg_id = f"{self.run_id}/{i}"
        partition = self.broker.partition_for(self.topic, key) if key is not None \
            else i % self.broker.num_partitions(self.topic)
        self._rec_produce(self.sim.now, msg_id=msg_id, size=size,
                          partition=partition)

        def appended() -> None:
            self.broker.append(self.topic, value, ts=self.sim.now, key=key,
                               partition=partition, run_id=self.run_id,
                               msg_id=msg_id, size_bytes=size)
            self.appended += 1
            self._rec_append(self.sim.now, msg_id=msg_id, size=size,
                             partition=partition)
            if self._production_over and self.appended >= self.sent:
                self.done = True
            elif self.rate_program is None and self.appended >= self.n_messages:
                self.done = True

        self.ingest.submit(partition, size, appended)

    def _finish_production(self) -> None:
        self._production_over = True
        if self.appended >= self.sent:
            self.done = True

    # -- closed loop: AIMD backoff ------------------------------------------
    def _tick(self) -> None:
        if self.sent >= self.n_messages:
            return
        self._emit_one()
        rate = self.aimd.update(self.broker.lag(self.group, self.topic))
        self.sim.schedule_fast(1.0 / rate, self._tick)

    # -- open loop: externally imposed rate program -------------------------
    def _tick_program(self) -> None:
        now = self.sim.now
        if (self.horizon_s is not None and now >= self.horizon_s) \
                or self.sent >= self.n_messages:
            self._finish_production()
            return
        rate = self.rate_program.rate(now)
        if rate <= 1e-9:
            # rate trace is momentarily zero: probe again shortly instead
            # of dividing by it
            self.sim.schedule_fast(self.idle_resolution_s, self._tick_program)
            return
        self._emit_one()
        self.sim.schedule_fast(1.0 / rate, self._tick_program)
