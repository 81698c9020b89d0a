"""USL-driven autoscaling: offline planner AND live closed control loop.

The paper's §V future work — "we will integrate StreamInsight into the
resource management algorithm of Pilot-Streaming so as to support predictive
scaling, viz., the ability to adapt the resource allocations and
configurations to changes in the incoming data rate(s)" — implemented in two
layers:

**Offline planner** (``Autoscaler``): given a fitted USL model for a
scenario it answers

* ``partitions_for(target_rate)`` — the smallest N whose predicted
  throughput sustains the incoming rate (with headroom), clamped at the
  USL peak: beyond N* adding partitions *reduces* throughput, so the
  autoscaler never scales into the retrograde region.
* ``max_sustainable_rate()`` — the peak throughput; incoming rates above it
  require throttling the source (the paper's "determination of the amount
  of throttling of data sources to guarantee processing").
* ``plan(rate_series)`` — partition counts tracking a time-varying rate,
  with hysteresis to avoid flapping.

**Live closed loop** (``ControlLoop``): a periodic control tick that
*observes* broker lag and windowed arrival/completion rates (O(1) counter
deltas from the columnar ``MetricRegistry`` and the broker), *decides* a
target allocation through a pluggable policy — ``USLPredictivePolicy``
(the paper's predictive scaling: model-inverted partition counts with
hysteresis and peak clamping) or the ``ReactiveLagPolicy`` baseline (scale
on lag watermarks, knowledge-free) — and *acts* by scaling the elastic
pilot backend (``Backend.scale_to``), resharding the broker
(``Broker.repartition``) and repartitioning the engine with a
state-migration cost event.  Per-run it accumulates the EILC report card:
allocation/lag traces, SLO-violation ticks and the allocation cost
integral ∫N dt.

The loop is *clock-agnostic*: it drives itself through the small
``EngineControlSurface`` protocol (``now()`` / ``call_later()`` /
``repartition()`` / ``run_on_clock()``) that both streaming engines implement, so the same
controller code runs as a periodic DES event on the virtual clock
(``SimStreamingEngine``) and as a real-time ticker thread on the wall
clock (``ThreadedStreamingEngine``).

**Online re-fitting** (``OnlineUSLEstimator``): the predictive policy can
*learn while it runs*.  The estimator accumulates (granted allocation N,
observed windowed completion rate) pairs from the control loop's own
observations — only capacity-limited windows (backlog present) count, an
idle system's completion rate is its arrival rate, not its capacity — and
periodically re-fits (sigma, kappa, gamma) through the batched fitter with
recency-decayed observation weights, warm-started from the previous fit
(``fit_usl_batch(seed_params=...)``).  Prior anchor rows synthesized from
the characterization fit regularize the refit while live evidence is thin
and fade automatically as observations accumulate.  The result: the policy
inverts a model that tracks drift (e.g. a workload whose per-message cost
shifts mid-run) instead of a model frozen at characterization time.

Ports ``repro.core.autoscale``; on the same observations its decisions and
re-fits equal the reference's bit for bit.  ``ControlLoop`` takes no lock
(the reference's ``_tick_lock`` is designed away): its ticks and the
settling ``stop()`` all run on the engine's clock thread — the DES caller,
or the threaded engine's ticker, which ``stop()`` hands its work to through
``EngineControlSurface.run_on_clock`` and then waits for.
"""

from __future__ import annotations

import math
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Protocol, runtime_checkable

import numpy as np

from repro_torch.core.usl import USLFit, fit_usl_batch

__all__ = ["AutoscalePolicy", "Autoscaler", "ControlObservation",
           "USLPredictivePolicy", "ReactiveLagPolicy", "StaticPolicy",
           "ControlLoop", "OnlineUSLEstimator", "EngineControlSurface",
           "policy_from_spec"]


@dataclass
class AutoscalePolicy:
    headroom: float = 0.15         # fraction of spare capacity to keep
    max_partitions: int = 256
    scale_down_hysteresis: float = 0.25   # rate must drop this much to downscale
    min_partitions: int = 1


class Autoscaler:
    def __init__(self, fit: USLFit, policy: AutoscalePolicy | None = None,
                 current: int | None = None) -> None:
        self.fit = fit
        self.policy = policy or AutoscalePolicy()
        self._current = (self.policy.min_partitions if current is None
                         else max(self.policy.min_partitions, int(current)))

    @property
    def current(self) -> int:
        """The planner's current allocation (the hysteresis reference)."""
        return self._current

    @current.setter
    def current(self, n: int) -> None:
        self._current = max(self.policy.min_partitions, int(n))

    # -- pure queries ----------------------------------------------------------
    def usable_peak_n(self) -> int:
        peak = self.fit.peak_n
        cap = self.policy.max_partitions
        if math.isinf(peak):
            return cap
        return max(self.policy.min_partitions, min(cap, int(math.floor(peak))))

    def max_sustainable_rate(self) -> float:
        n = self.usable_peak_n()
        return float(self.fit.predict(n))

    def partitions_for(self, target_rate: float) -> int | None:
        """Smallest N sustaining ``target_rate`` (incl. headroom); None if the
        rate exceeds the system's peak → caller must throttle the source."""
        need = target_rate * (1.0 + self.policy.headroom)
        hi = self.usable_peak_n()
        ns = np.arange(self.policy.min_partitions, hi + 1, dtype=np.float64)
        pred = self.fit.predict(ns)
        ok = np.nonzero(pred >= need)[0]
        if ok.size == 0:
            return None
        return int(ns[ok[0]])

    def throttle_rate(self, incoming_rate: float) -> float:
        """Admissible source rate (paper: "amount of throttling of data
        sources to guarantee processing")."""
        return min(incoming_rate, self.max_sustainable_rate() / (1.0 + self.policy.headroom))

    # -- stateful planning -------------------------------------------------------
    def step(self, observed_rate: float) -> int:
        """Hysteresis-stabilized partition recommendation for the next window."""
        peak = self.usable_peak_n()
        if self._current > peak:
            # beyond the peak every extra partition *subtracts* capacity:
            # retreating to the peak strictly raises predicted throughput,
            # so no hysteresis (or backlog hold) applies.  This matters
            # when the model is re-fitted online — a learned kappa can
            # move the peak below an allocation made under the stale fit.
            self._current = peak
        want = self.partitions_for(observed_rate)
        if want is None:
            want = peak
        if want > self._current:
            self._current = want                     # scale up promptly
        elif want < self._current:
            # only scale down if the needed capacity dropped well below current
            cur_rate = float(self.fit.predict(self._current))
            if observed_rate < cur_rate * (1.0 - self.policy.scale_down_hysteresis):
                self._current = want
        return self._current

    def plan(self, rate_series) -> list[int]:
        return [self.step(float(r)) for r in rate_series]


# ---------------------------------------------------------------------------
# live closed loop (EILC): observe -> decide -> act, as a periodic control tick
# ---------------------------------------------------------------------------

@runtime_checkable
class EngineControlSurface(Protocol):
    """The engine-facing surface the control loop drives itself through.

    Both streaming engines implement it: ``SimStreamingEngine`` maps
    ``now``/``call_later`` onto its ``Simulator`` (the loop is a periodic
    DES event), ``ThreadedStreamingEngine`` onto the wall clock and a
    real-time ticker thread.  ``repartition`` makes the engine adopt the
    broker's current partition count, charging ``migration_s`` of paused
    dispatch as the keyed-state migration cost.  ``run_on_clock`` runs a
    function where ``call_later`` callbacks run, never beside one.
    """

    def now(self) -> float:
        """Current time on the engine's clock (virtual or wall seconds)."""
        ...  # pragma: no cover - protocol

    def call_later(self, delay_s: float, fn: Callable[[], None]) -> None:
        """Run ``fn`` ``delay_s`` seconds from now on the engine's clock."""
        ...  # pragma: no cover - protocol

    def repartition(self, migration_s: float = 0.0) -> None:
        """Adopt the broker's current partition count mid-run."""
        ...  # pragma: no cover - protocol

    def run_on_clock(self, fn: Callable[[], None]) -> None:
        """Run ``fn`` on the thread that runs ``call_later`` callbacks,
        after any in flight, and return once it has run."""
        ...  # pragma: no cover - protocol


@dataclass
class ControlObservation:
    """What a control tick sees: the backpressure signal plus windowed
    rates (counter deltas over the last control interval).

    ``lag`` is *end-to-end* outstanding work (produced − completed): it
    includes messages still queued in the ingest path, not only
    appended-but-uncommitted broker lag — per-shard ingest limits mean the
    broker itself can be the bottleneck, and a controller watching only
    consumer lag is blind to that backlog.

    ``effective_allocation`` is the capacity actually *granted* right now,
    as opposed to the target: an HPC worker grown mid-run sits in the batch
    queue for ``grant_delay_s`` before it runs anything.  The online
    estimator attributes observed rates to the granted N — attributing a
    window served by 4 live workers to a target of 8 would poison the fit.
    ``None`` means "same as allocation" (filled in by ``__post_init__``)."""

    t: float
    lag: int                   # produced-but-not-completed messages
    arrival_rate: float        # msgs/s offered (produced) over the last window
    completion_rate: float     # msgs/s completed over the last window
    allocation: int            # current target capacity
    effective_allocation: int | None = None   # granted capacity
    window_stable: bool = True  # granted capacity unchanged across the window

    def __post_init__(self) -> None:
        if self.effective_allocation is None:
            self.effective_allocation = self.allocation


class OnlineUSLEstimator:
    """Re-fit the USL from the control loop's own observations.

    Closes the loop one level higher than the frozen-model policy: instead
    of inverting a model frozen at characterization time, the predictive policy hands each
    control observation to this estimator, which

    * records (granted N, windowed completion rate) pairs — but only
      windows that actually measure capacity.  A window is *saturated*
      when the backlog clearly exceeds the in-flight ceiling
      (``lag >= max(busy_lag, saturation_factor * N)``): messages are
      queued behind every worker, so the completion rate IS the capacity
      at N — an equality sample.  An unsaturated window only proves
      capacity ≥ rate (the consumer kept up with the offered load); such
      lower bounds are recorded only when they *beat* the current model's
      prediction — evidence the model underestimates (e.g. per-message
      cost drifted down) — and are discarded otherwise, because treating
      "keeping up" as "at capacity" drags gamma down and ratchets the
      allocation up in a self-confirming spiral;
    * keeps a sliding ``window`` of the most recent samples and weights
      them by recency — weight ``0.5 ** (age / half_life_s)`` — so after a
      drift the stale pre-drift evidence fades on a known time constant;
    * every ``refit_interval_s`` re-fits (sigma, kappa, gamma) through
      ``fit_usl_batch``, warm-started from the previous fit
      (``seed_params``) so a refit pays only the LM polish, plus
      ``anchor_levels`` prior rows predicted by the *characterization* fit
      at weight ``prior_weight * min(1, min_obs / n_obs)`` each — the
      prior regularizes the fit while live evidence is thin, and its mass
      shrinks as observations accumulate so a genuinely drifted system is
      not forever dragged back toward the stale characterization.

    ``fit`` always holds the current best model; ``refit``/``maybe_refit``
    update it in place and return it.
    """

    def __init__(self, prior_fit: USLFit, *,
                 refit_interval_s: float = 10.0,
                 window: int = 128,
                 half_life_s: float = 45.0,
                 min_obs: int = 6,
                 busy_lag: int = 4,
                 saturation_factor: float = 2.0,
                 prior_weight: float = 0.5,
                 anchor_levels: tuple = (1, 2, 4, 8, 16),
                 max_iter: int = 60) -> None:
        if window < 2:
            raise ValueError("window must hold at least 2 observations")
        self.prior_fit = prior_fit
        self.fit = prior_fit
        self.refit_interval_s = float(refit_interval_s)
        self.half_life_s = float(half_life_s)
        self.min_obs = int(min_obs)
        self.busy_lag = int(busy_lag)
        self.saturation_factor = float(saturation_factor)
        self.prior_weight = float(prior_weight)
        self.anchor_levels = tuple(anchor_levels)
        self.max_iter = int(max_iter)
        self._ts: deque[float] = deque(maxlen=window)
        self._ns: deque[float] = deque(maxlen=window)
        self._rates: deque[float] = deque(maxlen=window)
        self._last_refit_t: float | None = None
        self.refits = 0
        self.rejected = 0                  # windows that measure no capacity
        self.last_refit_wall_s = 0.0

    def __len__(self) -> int:
        return len(self._ts)

    @property
    def observations(self) -> list[tuple[float, float, float]]:
        """Recorded (t, N, rate) samples, oldest first."""
        return list(zip(self._ts, self._ns, self._rates))

    def observe(self, t: float, n: float, rate: float, lag: int) -> bool:
        """Record one windowed observation; returns whether it was kept.

        Saturated windows (queue clearly deeper than the in-flight
        ceiling) are equality samples of capacity at N.  Unsaturated
        windows only bound capacity from below and are kept solely when
        they exceed the current model's prediction at N — see the class
        docstring for why admitting them unconditionally poisons the fit.
        """
        if n < 1 or rate <= 0.0:
            self.rejected += 1
            return False
        saturated = lag >= max(self.busy_lag, self.saturation_factor * n)
        if not saturated and rate <= float(self.fit.predict(n)):
            self.rejected += 1
            return False
        self._ts.append(float(t))
        self._ns.append(float(n))
        self._rates.append(float(rate))
        return True

    def observation_weights(self, now: float) -> np.ndarray:
        """Recency weights for the current window: ``0.5 ** (age/half_life)``
        — strictly increasing in observation time, so post-drift samples
        always outweigh pre-drift ones."""
        age = now - np.asarray(self._ts, dtype=np.float64)
        return 0.5 ** (age / max(self.half_life_s, 1e-9))

    def refit(self, now: float) -> USLFit:
        """Unconditionally re-fit from the current window (plus prior
        anchors), warm-started from the current fit."""
        t0 = time.perf_counter()
        w_obs = self.observation_weights(now)
        anchors_n = np.asarray(self.anchor_levels, dtype=np.float64)
        anchors_t = np.asarray(self.prior_fit.predict(anchors_n),
                               dtype=np.float64)
        n = np.concatenate([np.asarray(self._ns, dtype=np.float64), anchors_n])
        t = np.concatenate([np.asarray(self._rates, dtype=np.float64),
                            anchors_t])
        anchor_w = self.prior_weight * min(
            1.0, self.min_obs / max(len(self._ts), 1))
        w = np.concatenate([w_obs, np.full(anchors_n.size, anchor_w)])
        seed = [[self.fit.sigma, self.fit.kappa, self.fit.gamma]]
        self.fit = fit_usl_batch(n[None, :], t[None, :], weights=w[None, :],
                                 max_iter=self.max_iter, seed_params=seed)[0]
        self.refits += 1
        self._last_refit_t = now
        self.last_refit_wall_s = time.perf_counter() - t0
        return self.fit

    def maybe_refit(self, now: float) -> USLFit | None:
        """Re-fit if enough fresh evidence accumulated and the refit
        interval elapsed; returns the new fit, or None if nothing ran."""
        if len(self._ts) < self.min_obs:
            return None
        if self._last_refit_t is not None \
                and now - self._last_refit_t < self.refit_interval_s:
            return None
        return self.refit(now)


class USLPredictivePolicy:
    """Predictive scaling (paper §V): invert the fitted USL model.

    The target allocation is ``partitions_for`` the *demand estimate*,
    clamped at the USL peak (never into the retrograde region).  Demand is
    the observed arrival rate plus a backlog-drain term
    (``lag / catchup_horizon_s`` — capacity to clear the current lag within
    the horizon), floored by an exponentially decaying memory of recent
    peak demand (``stabilization_s``) — the standard scale-down
    stabilization window, which keeps burst-level capacity warm between
    bursts instead of re-paying the platform's scale-up price (cold starts,
    HPC queue/grant delay) every cycle.  Scale-up is prompt; scale-down
    additionally requires the backlog to be cleared (``downscale_lag``) and
    demand to sit well below current capacity (the planner's hysteresis):
    releasing workers while lag is outstanding stalls the drain behind
    fresh grant delays.

    With an ``estimator`` (``OnlineUSLEstimator``) the policy *learns while
    it runs*: every observation is fed to the estimator, and whenever it
    re-fits, the autoscaler's model is swapped for the updated one — the
    inversion then tracks drift instead of staying frozen at
    characterization time.

    ``max_step_up`` bounds how much the allocation may grow per tick
    (doubling-style slew limit: ``max(max_step_up, current)`` extra units).
    Bounded actuation is standard controller hygiene — a reshard from 2 to
    16 partitions in one tick is a traumatic migration — and it makes the
    scale-up trajectory pass *through* the intermediate N levels, which is
    precisely where an online estimator samples the capacity curve's shape
    (a single level cannot distinguish gamma from kappa).
    """

    name = "usl"

    def __init__(self, autoscaler: Autoscaler, catchup_horizon_s: float = 20.0,
                 downscale_lag: int = 16, stabilization_s: float = 60.0,
                 estimator: OnlineUSLEstimator | None = None,
                 max_step_up: int | None = None) -> None:
        self.autoscaler = autoscaler
        self.catchup_horizon_s = catchup_horizon_s
        self.downscale_lag = downscale_lag
        self.stabilization_s = stabilization_s
        self.estimator = estimator
        self.max_step_up = max_step_up
        self._demand_floor = 0.0
        self._last_t: float | None = None

    def decide(self, obs: ControlObservation) -> int:
        if self.estimator is not None:
            # only windows served by a stable granted capacity are clean
            # capacity measurements: a grant/retirement mid-window mixes
            # two capacity levels into one rate.  (The control loop marks
            # stability against the *post-action* grant, so a window that
            # ran entirely at the newly scaled capacity still counts — the
            # climb through intermediate N levels is exactly where the
            # retrograde curvature gets sampled.)
            if obs.window_stable:
                self.estimator.observe(obs.t, obs.effective_allocation,
                                       obs.completion_rate, obs.lag)
            refit = self.estimator.maybe_refit(obs.t)
            if refit is not None:
                self.autoscaler.fit = refit
        inst = obs.arrival_rate + obs.lag / self.catchup_horizon_s
        dt = 0.0 if self._last_t is None else max(obs.t - self._last_t, 0.0)
        self._last_t = obs.t
        if self.stabilization_s > 0.0:
            self._demand_floor *= math.exp(-dt / self.stabilization_s)
            demand = self._demand_floor = max(inst, self._demand_floor)
        else:
            demand = inst       # stabilization disabled: track instantly
        cur = obs.allocation
        # the live allocation is the planner's state; step() then applies
        # the prompt-up / hysteresis-down rule (one copy of that logic)
        self.autoscaler.current = cur
        want = self.autoscaler.step(demand)
        if self.max_step_up is not None and want > cur:
            # slew limit: grow by at most max(max_step_up, cur) per tick
            # (doubling-style), never jump the whole gap in one reshard
            want = min(want, cur + max(self.max_step_up, cur))
            self.autoscaler.current = want
        if want < cur and obs.lag > self.downscale_lag \
                and cur <= self.autoscaler.usable_peak_n():
            # demand says shrink, backlog says hold — but only below the
            # peak: past it, holding N keeps the system in the retrograde
            # region and the backlog drains *slower*
            return cur
        return want


class ReactiveLagPolicy:
    """Model-free baseline: scale on lag watermarks alone.

    Up by ``step_up`` when lag crosses ``hi_lag``, down by one when it
    falls under ``lo_lag`` — the standard threshold autoscaler every
    streaming platform ships.  It cannot anticipate: capacity only moves
    *after* lag has already built (or after over-provisioning is already
    being paid for), which is exactly the gap the USL-predictive policy
    closes in fig 8.
    """

    name = "reactive"

    def __init__(self, hi_lag: int = 32, lo_lag: int = 4, step_up: int = 1,
                 min_partitions: int = 1, max_partitions: int = 256) -> None:
        self.hi_lag = hi_lag
        self.lo_lag = lo_lag
        self.step_up = step_up
        self.min_partitions = min_partitions
        self.max_partitions = max_partitions

    def decide(self, obs: ControlObservation) -> int:
        if obs.lag >= self.hi_lag:
            return min(obs.allocation + self.step_up, self.max_partitions)
        if obs.lag <= self.lo_lag:
            return max(obs.allocation - 1, self.min_partitions)
        return obs.allocation


class StaticPolicy:
    """No adaptation: hold a fixed allocation (e.g. static-peak
    provisioning, the serverful strawman fig 8 compares against)."""

    name = "static"

    def __init__(self, partitions: int) -> None:
        self.partitions = int(partitions)

    def decide(self, obs: ControlObservation) -> int:
        return self.partitions


def policy_from_spec(spec: dict, *, initial: int):
    """Construct a scaling policy from a JSON-able spec dict.

    The spec is data, not code — the same dict a ``WhatIfDesign`` carries
    through pickling into pool workers and into cache keys.  ``kind``
    selects the controller; the remaining keys are its hyperparameters:

    * ``usl`` / ``usl_online``: ``sigma``/``kappa``/``gamma`` (the fitted
      model, required), ``headroom``, ``max_partitions``,
      ``scale_down_hysteresis``, ``catchup_horizon_s``, ``downscale_lag``,
      ``stabilization_s``, ``max_step_up``; online adds
      ``refit_interval_s``, ``refit_window``, ``refit_half_life_s``.
    * ``reactive``: ``hi_lag``, ``lo_lag``, ``step_up``, ``max_partitions``.
    * ``static``: ``partitions`` (defaults to ``initial``).

    ``initial`` seeds the planner's current allocation (the hysteresis
    reference) — it is runtime wiring, not a hyperparameter, which is why
    it is a keyword argument and not a spec field.
    """
    kind = spec.get("kind")
    if kind in ("usl", "usl_online"):
        try:
            fit = USLFit(sigma=float(spec["sigma"]), kappa=float(spec["kappa"]),
                         gamma=float(spec["gamma"]), r2=1.0, rmse=0.0, n_obs=0)
        except KeyError as exc:
            raise ValueError(
                f"{kind} policy spec needs sigma/kappa/gamma "
                "(fit a characterization sweep first)") from exc
        scaler = Autoscaler(fit, AutoscalePolicy(
            headroom=float(spec.get("headroom", 0.15)),
            max_partitions=int(spec.get("max_partitions", 256)),
            scale_down_hysteresis=float(spec.get("scale_down_hysteresis", 0.25)),
            min_partitions=1), current=initial)
        estimator = None
        if kind == "usl_online":
            estimator = OnlineUSLEstimator(
                fit,
                refit_interval_s=float(spec.get("refit_interval_s", 10.0)),
                window=int(spec.get("refit_window", 128)),
                half_life_s=float(spec.get("refit_half_life_s", 45.0)))
        max_step_up = spec.get("max_step_up")
        return USLPredictivePolicy(
            scaler,
            catchup_horizon_s=float(spec.get("catchup_horizon_s", 20.0)),
            downscale_lag=int(spec.get("downscale_lag", 16)),
            stabilization_s=float(spec.get("stabilization_s", 60.0)),
            estimator=estimator,
            max_step_up=None if max_step_up is None else int(max_step_up))
    if kind == "reactive":
        return ReactiveLagPolicy(
            hi_lag=int(spec.get("hi_lag", 32)),
            lo_lag=int(spec.get("lo_lag", 4)),
            step_up=int(spec.get("step_up", 1)),
            min_partitions=1,
            max_partitions=int(spec.get("max_partitions", 256)))
    if kind == "static":
        return StaticPolicy(int(spec.get("partitions", initial)))
    raise ValueError(f"unknown policy kind {kind!r} in spec {spec!r}")


class ControlLoop:
    """Closed-loop elastic scaling as a periodic control tick.

    Each tick: observe (end-to-end lag and windowed arrival/completion
    rates as O(1) ``MetricRegistry.kind_count`` deltas of the run's
    ``produce``/``complete`` event columns — see ``ControlObservation`` for
    why produced−completed, not broker consumer lag, is the backpressure
    signal), decide (``policy.decide``), act (``Backend.scale_to`` →
    ``Broker.repartition`` → ``engine.repartition`` with the
    state-migration cost ``migration_s_per_delta × |ΔN|``), and account
    (allocation/lag traces as registry series, SLO-violation ticks where
    lag exceeds ``slo_lag``, and the cost integral ∫ allocation dt — the
    container-seconds / core-seconds bill).

    The loop schedules itself through the engine's ``EngineControlSurface``
    (``now``/``call_later``/``repartition``), so the identical controller
    runs on the virtual clock (``SimStreamingEngine``) and on the wall
    clock (``ThreadedStreamingEngine``'s ticker thread).  If the policy
    carries an ``OnlineUSLEstimator``, every re-fit is traced as an
    ``autoscale/refit`` event and counted in ``refit_events``.

    Ticks, and the settling ``stop()``, run on one thread (the engine's
    clock: ``call_later`` and ``run_on_clock``), so the loop's accounting
    has a single writer and needs no lock.
    """

    def __init__(self, engine, broker, topic: str, pilot, policy, *,
                 metrics, run_id: str,
                 interval_s: float = 2.0, slo_lag: int = 32,
                 migration_s_per_delta: float = 0.0,
                 fault_signal: Callable[[], bool] | None = None) -> None:
        self.engine = engine          # EngineControlSurface
        self.broker = broker
        self.topic = topic
        self.pilot = pilot
        self.policy = policy
        self.metrics = metrics
        self.run_id = run_id
        self.interval_s = interval_s
        self.slo_lag = slo_lag
        self.migration_s_per_delta = migration_s_per_delta
        # latched "a fault fired / is in force since the last probe" read
        # (FaultInjector.window_dirty): such windows are excluded from the
        # online estimator the same way in-flight grants are — a crash or
        # stall mid-window makes the observed rate measure the fault, not
        # the capacity at N.  (Preemption is additionally covered by the
        # granted==target gate, because effective_allocation dips.)
        self.fault_signal = fault_signal
        self.allocation = pilot.backend.allocation(pilot)
        self.ticks = 0
        self.slo_violations = 0
        self.scale_events = 0
        self.refit_events = 0
        self.fault_windows = 0            # ticks whose window saw a fault
        self.tick_errors = 0              # surfaced ticker-callback failures
        # bounded diagnosis ring: the last 16 (sim_ts, repr(exc)) entries —
        # a flapping policy is diagnosable from the report card, not just
        # countable (tick_errors keeps the total)
        self.tick_error_log: deque = deque(maxlen=16)
        self._ticker_error_seen = False
        self.cost_integral = 0.0          # ∫ allocation dt
        self._stopped = False
        self._last_t = engine.now()
        self._last_produced = metrics.kind_count(run_id, "produce")
        self._last_completed = metrics.kind_count(run_id, "complete")
        self._eff_after_act = pilot.backend.effective_allocation(pilot)

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> None:
        self.engine.call_later(self.interval_s, self._tick)

    def stop(self) -> None:
        """Stop ticking and settle the final cost-integral interval.
        The settling runs on the engine's clock thread, after any in-flight
        tick, and this returns once it has: no tick mutates the loop's
        accounting afterwards."""
        self.engine.run_on_clock(self._settle)

    def _settle(self) -> None:
        if not self._stopped:
            self._account(self.engine.now())
            self._stopped = True

    # -- the loop ------------------------------------------------------------
    def _account(self, now: float) -> None:
        dt = now - self._last_t
        if dt > 0:
            self.cost_integral += self.allocation * dt
        self._last_t = now

    def observe(self) -> ControlObservation:
        now = self.engine.now()
        backend = self.pilot.backend
        produced = self.metrics.kind_count(self.run_id, "produce")
        completed = self.metrics.kind_count(self.run_id, "complete")
        dt = max(now - self._last_t, 1e-9)
        effective = backend.effective_allocation(self.pilot)
        faulty = bool(self.fault_signal()) if self.fault_signal is not None \
            else False
        if faulty:
            self.fault_windows += 1
        obs = ControlObservation(
            t=now,
            lag=max(0, produced - completed),
            arrival_rate=(produced - self._last_produced) / dt,
            completion_rate=(completed - self._last_completed) / dt,
            allocation=self.allocation,
            effective_allocation=effective,
            # stable = the grant in force since last tick's *action* never
            # moved AND nothing is in flight (granted == target): a window
            # that ran wholly at a freshly scaled capacity is a clean
            # capacity sample; a mid-window grant is not, and neither is a
            # wait on the batch queue — resharded partitions pinned to
            # still-queued workers stall, so the window's rate reflects a
            # crippled topology, not the capacity of the live worker count
            window_stable=(not faulty
                           and effective == self._eff_after_act
                           and effective == self.allocation),
        )
        self._last_produced = produced
        self._last_completed = completed
        return obs

    def _trace_refits(self, obs: ControlObservation) -> None:
        est = getattr(self.policy, "estimator", None)
        if est is None or est.refits == self.refit_events:
            return
        self.refit_events = est.refits
        fit = est.fit
        self.metrics.record(self.run_id, "autoscale", "refit", obs.t,
                            sigma=fit.sigma, kappa=fit.kappa, gamma=fit.gamma,
                            n_obs=len(est), wall_s=est.last_refit_wall_s)

    def _tick(self) -> None:
        try:
            self._tick_body()
        finally:
            # Re-arm outside the tick body, so a raising policy or backend
            # call does not end the loop; the error itself is still
            # surfaced (ticker_error → tick_errors on the next tick, and
            # run_adaptation raises on it after the run).
            if not self._stopped:
                self.engine.call_later(self.interval_s, self._tick)

    def _tick_body(self) -> None:
        if self._stopped:
            return
        drain = getattr(self.engine, "drain_ticker_errors", None)
        if drain is not None:
            errs = drain()
        else:
            # engines without a drainable history surface only the root
            # cause once (the pre-ring behaviour)
            err = getattr(self.engine, "ticker_error", None)
            errs = [] if err is None or self._ticker_error_seen else [err]
        for err in errs:
            # a ticker callback (this tick or any other call_later client)
            # failed since the last probe: count it, ring-buffer it and
            # trace it so a crashed-then-recovered controller is visible
            self._ticker_error_seen = True
            self.tick_errors += 1
            self.tick_error_log.append((self.engine.now(), repr(err)))
            self.metrics.record(self.run_id, "autoscale", "tick_error",
                                self.engine.now(), error=repr(err))
        obs = self.observe()
        self._account(obs.t)
        self.ticks += 1
        if obs.lag > self.slo_lag:
            self.slo_violations += 1
        self.metrics.observe(f"{self.run_id}/alloc", obs.t, float(obs.allocation))
        self.metrics.observe(f"{self.run_id}/lag", obs.t, float(obs.lag))
        target = int(self.policy.decide(obs))
        self._trace_refits(obs)
        if target != self.allocation:
            granted = self.pilot.backend.scale_to(self.pilot, target)
            delta = abs(granted - self.allocation)
            if granted != self.allocation:
                self.scale_events += 1
                self.metrics.record(self.run_id, "autoscale", "scale", obs.t,
                                    frm=self.allocation, to=granted,
                                    lag=obs.lag, rate=obs.arrival_rate)
                self.allocation = granted
                self.broker.repartition(self.topic, granted)
                self.engine.repartition(self.migration_s_per_delta * delta)
        self._eff_after_act = self.pilot.backend.effective_allocation(self.pilot)
