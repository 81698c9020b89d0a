"""Streaming Mini-App: producer -> broker -> processing, end to end (paper §IV).

Ports the stream-experiment half of ``repro.core.miniapp``.  A
``StreamExperiment`` is one cell of the paper's parameter space (machine M,
partitions N, message size MS, workload complexity WC, container memory);
``run_experiment`` runs it on the virtual clock of the simulated platforms
(``serverless://aws-sim``, ``hpc://wrangler-sim``, ``hpc://stampede2-sim``)
and returns the steady-state throughput T^px and the latencies L^px and
L^br.  On the same seed its result equals the reference's bit for bit.

K-Means cost model (paper §IV-B): a message carries ``points`` d = 9
float32 points (about 37 B a point, the paper's 296 KB per 8,000 points);
workload complexity is the centroid count.  ``IMPL_OVERHEAD`` calibrates
raw FLOPs to an effective sklearn MiniBatchKMeans rate.

Beyond the reference's signature, ``run_experiment`` takes

* ``fn``: the real per-message computation.  The simulated backends run it
  when a unit completes on the virtual clock, so a simulated cell can carry
  the real K-Means update on the card without moving the clock;
* ``faults``: a ``FaultPlan`` (or its spec) fired through a
  ``FaultInjector`` on the cell's clock; the result then carries the
  injector's ledger.

Adaptation mode (paper §V): ``AdaptationExperiment`` / ``run_adaptation``
run the same pipeline under an *open-loop* time-varying rate program with a
live ``ControlLoop`` (``core.autoscale``) elastically resizing the backend,
resharding the broker and repartitioning the engine mid-run — returning
allocation/lag traces, SLO violations and the ∫N dt cost integral.
``engine="sim"`` (default) runs on the virtual clock and equals the
reference's cell bit for bit; ``engine="threaded"`` runs the identical loop
on the wall clock (the threaded engine on the elastic ``local://``
backend).  ``drift_t_s``/``drift_factor`` shift the per-message compute
cost mid-run.

``AdaptationPlan`` is a cell as data and ``run_plan`` runs it to a compact
``AdaptationSummary``, through the fast replay (``sim.batched``) where the
cell qualifies and through ``run_adaptation`` elsewhere; ``machine=
"federated"`` runs its members behind ``federated://``.  Summaries equal the
reference's bit for bit, however they were computed.

Model-sharing consistency: ``full_fit_locked`` (the HPC default: the
partial_fit inside the shared-model critical section, the paper's measured
Dask sigma), ``update_locked`` (distances against a stale model outside
the lock) and ``lock_free`` (serverless: S3 last-writer-wins).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field, replace
from typing import Any, Callable

import numpy as np

from repro_torch.core.autoscale import ControlLoop, policy_from_spec
from repro_torch.core.metrics import MetricRegistry, new_run_id, percentile_summary
from repro_torch.pilot.api import (PilotComputeService, PilotDescription, State,
                                   TaskProfile)
from repro_torch.streaming.broker import Broker, Message
from repro_torch.streaming.engine import (SimStreamingEngine,
                                          ThreadedStreamingEngine, Workload)
from repro_torch.streaming.faults import FaultInjector, FaultPlan
from repro_torch.streaming.producer import (AIMD, PartitionIngest, RateProgram,
                                            SharedFsIngest, SyntheticProducer,
                                            rate_program_from_spec)

__all__ = ["StreamExperiment", "ExperimentResult", "KMeansStreamWorkload",
           "run_experiment", "steady_state_throughput", "default_consistency",
           "POINT_BYTES", "KMEANS_DIM", "IMPL_OVERHEAD", "SERIALIZE_FLOPS_PER_BYTE",
           "AdaptationExperiment", "AdaptationResult", "run_adaptation",
           "AdaptationPlan", "AdaptationSummary", "summarize_adaptation", "run_plan",
           "scaling_policy_spec", "adaptation_profile_factory"]


def default_consistency(machine: str) -> str:
    """Platform-default model-sharing consistency policy: S3 is
    last-writer-wins (lock-free), the shared filesystem serializes the
    full partial_fit (the paper's measured Dask behaviour)."""
    return "lock_free" if machine == "serverless" else "full_fit_locked"


KMEANS_DIM = 9          # 9 float32 dims + header ≈ 37 B/point (paper: 296 KB / 8,000 pts)
POINT_BYTES = 37
IMPL_OVERHEAD = 8.0     # sklearn/python effective-FLOPs calibration
SERIALIZE_FLOPS_PER_BYTE = 12.0   # pickle/unpickle cost of the model file


@dataclass
class KMeansStreamWorkload:
    """Maps (points, centroids, policy) to a mechanism-level TaskProfile."""

    points: int = 8000
    centroids: int = 1024
    dim: int = KMEANS_DIM
    policy: str = "full_fit_locked"   # | "update_locked" | "lock_free"
    n_partitions: int = 1

    @property
    def msg_bytes(self) -> int:
        return self.points * POINT_BYTES

    @property
    def model_bytes(self) -> float:
        return self.centroids * self.dim * 4.0

    def profile(self) -> TaskProfile:
        n, c, d = self.points, self.centroids, self.dim
        distance = 3.0 * n * c * d * IMPL_OVERHEAD
        update = (2.0 * n * c + 2.0 * n * d + 6.0 * c * d) * IMPL_OVERHEAD
        serialize = 2.0 * self.model_bytes * SERIALIZE_FLOPS_PER_BYTE
        decode = 2.0 * self.msg_bytes
        if self.policy == "full_fit_locked":
            parallel, serial = decode, distance + update + serialize
        elif self.policy == "update_locked":
            parallel, serial = decode + distance, update + serialize
        elif self.policy == "lock_free":
            parallel, serial = decode + distance + update + serialize, 0.0
        else:
            raise ValueError(f"unknown policy {self.policy!r}")
        return TaskProfile(
            flops=parallel,
            serial_flops=serial,
            read_bytes=self.model_bytes,
            write_bytes=self.model_bytes,
            msg_bytes=self.msg_bytes,
            coherence_peers=max(0, self.n_partitions - 1),
            memory_mb=max(64.0, (self.msg_bytes + 2 * self.model_bytes) / 1e6 * 3 + 40),
        )


@dataclass
class _PlatformCell:
    """The platform axis of an experiment cell: the machine, its resource
    URL and its consistency-policy default (subclasses declare ``policy``)."""

    machine: str = "serverless"         # serverless | wrangler | stampede2
                                        # | federated (members via the
                                        # experiment's federation spec)

    @property
    def resource_url(self) -> str:
        if self.machine == "serverless":
            return "serverless://aws-sim"
        if self.machine == "federated":
            return "federated://mix"
        return f"hpc://{self.machine}-sim"

    @property
    def effective_policy(self) -> str:
        if self.policy is not None:
            return self.policy
        return default_consistency(self.machine)


@dataclass
class StreamExperiment(_PlatformCell):
    """One cell of the paper's parameter space."""

    partitions: int = 4                 # N^px(p) == N^br(p) (paper constraint)
    points: int = 8000                  # message size knob (MS)
    centroids: int = 1024               # workload complexity knob (WC)
    memory_mb: int = 3008               # Lambda container memory
    n_messages: int = 200
    policy: str | None = None           # None → platform default
    seed: int = 0
    batch_max: int = 1                  # paper: one Lambda invocation per message
    backend_attrs: dict = field(default_factory=dict)


@dataclass
class ExperimentResult:
    experiment: StreamExperiment
    run_id: str
    throughput: float                  # msgs/s, steady-state window
    latency_px: dict                   # percentile summary of L^px
    latency_br: dict                   # percentile summary of L^br
    runtime_summary: dict              # per-task service times
    processed: int = 0
    failed: int = 0
    retried: int = 0
    wall_virtual_s: float = 0.0
    des_events: int = 0                # Simulator events consumed by this cell
    # beyond the reference (not in ``record``): the at-least-once ledger and,
    # for a faulted cell, the injector's counters
    abandoned: int = 0
    dup_delivered: int = 0
    faults: dict | None = None

    def record(self) -> dict:
        e = self.experiment
        return dict(machine=e.machine, partitions=e.partitions, points=e.points,
                    centroids=e.centroids, memory_mb=e.memory_mb,
                    policy=e.effective_policy, batch_max=e.batch_max,
                    throughput=self.throughput,
                    latency_px_p50=self.latency_px.get("p50", float("nan")),
                    latency_px_mean=self.latency_px.get("mean", float("nan")),
                    latency_px_std=self.latency_px.get("std", float("nan")),
                    latency_br_p50=self.latency_br.get("p50", float("nan")),
                    task_p50=self.runtime_summary.get("p50", float("nan")),
                    processed=self.processed, failed=self.failed)


def steady_state_throughput(metrics: MetricRegistry, run_id: str,
                            warmup_frac: float = 0.25) -> float:
    """Completions/sec over the post-warmup window (max sustained throughput)."""
    return metrics.steady_state_throughput(run_id, "complete",
                                           warmup_frac=warmup_frac)


def _injector_ledger(injector: FaultInjector) -> dict:
    return dict(injected=injector.injected, crashes=injector.crashes,
                preemptions=injector.preemptions, stalls=injector.stalls,
                dup_injected=injector.dup_injected, skipped=injector.skipped)


def run_experiment(exp: StreamExperiment, metrics: MetricRegistry | None = None, *,
                   fn: Callable[[list[Message]], Any] | None = None,
                   faults: FaultPlan | dict | None = None) -> ExperimentResult:
    """Run one cell on the virtual clock.  Each message's value is the
    reference's ``{"n_points", "seed"}`` payload; ``fn(msgs)``, if given,
    runs when a unit completes (see the module docstring); ``faults`` arms
    a ``FaultInjector`` once the producer and the engine have started."""
    metrics = metrics if metrics is not None else MetricRegistry()
    run_id = new_run_id(f"{exp.machine}-N{exp.partitions}")

    pcs = PilotComputeService(seed=exp.seed)
    pilot_desc = PilotDescription(
        resource=exp.resource_url,
        memory_mb=exp.memory_mb,
        partitions=exp.partitions,
        concurrency=exp.partitions,
        attrs=dict(exp.backend_attrs),
    )
    pilot = pcs.submit_pilot(pilot_desc)
    backend = pilot.backend
    sim = backend.sim

    broker = Broker()
    topic = "points"
    broker.create_topic(topic, exp.partitions)

    wl = KMeansStreamWorkload(points=exp.points, centroids=exp.centroids,
                              policy=exp.effective_policy,
                              n_partitions=exp.partitions)
    # the cell's cost profile is message-independent: computed once
    profile = wl.profile()
    workload = Workload(profile_for=lambda msgs: profile, fn=fn, name="kmeans")

    # broker ingest path: Kinesis shard limits vs Kafka-on-Lustre
    if exp.machine == "serverless":
        ingest = PartitionIngest(sim, exp.partitions, bw_per_partition=1e6)
    else:
        ingest = SharedFsIngest(sim, backend.shared_resource(pilot, "fs"))

    def msg_factory(i: int):
        return (None, {"n_points": exp.points, "seed": exp.seed * 100003 + i},
                wl.msg_bytes)

    producer = SyntheticProducer(
        sim, broker, topic, msg_factory=msg_factory, n_messages=exp.n_messages,
        run_id=run_id, metrics=metrics,
        aimd=AIMD(rate_hz=2.0 * exp.partitions, hi_watermark=4 * exp.partitions,
                  lo_watermark=exp.partitions),
        ingest=ingest,
    )
    engine = SimStreamingEngine(
        sim, broker, topic, pilot, workload, metrics, run_id,
        batch_max=exp.batch_max,
        is_input_complete=lambda: producer.done,
    )

    producer.start()
    engine.start()
    injector = None
    if faults is not None:
        plan = faults if isinstance(faults, FaultPlan) else \
            FaultPlan.from_spec(faults, default_seed=exp.seed)
        injector = FaultInjector(plan, engine, broker, topic, pilot,
                                 metrics=metrics, run_id=run_id)
        injector.start()
    engine.run_to_completion()

    lat_px = metrics.latencies(run_id, "append", "complete")
    lat_br = metrics.latencies(run_id, "produce", "append")
    runtimes = np.asarray([cu.runtime for cu in pilot.compute_units
                           if cu.state is State.DONE])
    result = ExperimentResult(
        experiment=exp,
        run_id=run_id,
        throughput=steady_state_throughput(metrics, run_id),
        latency_px=percentile_summary(lat_px),
        latency_br=percentile_summary(lat_br),
        runtime_summary=percentile_summary(runtimes),
        processed=engine.core.processed,
        failed=engine.core.failed_batches,
        retried=engine.core.retried,
        wall_virtual_s=sim.now,
        des_events=sim.events_processed,
        abandoned=engine.core.abandoned,
        dup_delivered=engine.core.dup_delivered,
        faults=_injector_ledger(injector) if injector is not None else None,
    )
    pcs.close()
    return result


# ---------------------------------------------------------------------------
# adaptation experiments (EILC): characterize -> model -> *adapt*
# ---------------------------------------------------------------------------

@dataclass
class AdaptationExperiment(_PlatformCell):
    """One closed-loop elastic-scaling cell: a rate trace in, allocation and
    lag traces + SLO violations + cost integral out.

    ``rate`` is a JSON-able rate-program spec (see
    ``streaming.producer.rate_program_from_spec``) — rate traces are a
    first-class design axis, like partitions or message size in
    ``StreamExperiment``.  ``scaling_policy`` picks the controller:
    ``"usl"`` (predictive, needs the fitted ``usl_sigma/kappa/gamma`` from
    a characterization sweep), ``"usl_online"`` (predictive + online
    re-fitting: an ``OnlineUSLEstimator`` re-fits the model from the
    loop's own observations every ``refit_interval_s``, over a sliding
    ``refit_window`` of capacity-limited samples recency-weighted with
    half-life ``refit_half_life_s``), ``"reactive"`` (lag-threshold
    baseline) or ``"static"`` (no loop; ``static_partitions``, default the
    ceiling — static-peak provisioning).  ``policy`` remains the
    model-sharing consistency knob, as in ``StreamExperiment``.

    ``engine`` selects the clock: ``"sim"`` (virtual, simulated platforms)
    or ``"threaded"`` (wall clock: the threaded engine on the elastic
    local backend, per-message service time ``threaded_service_s`` —
    default ``1/usl_gamma``).  ``drift_t_s``/``drift_factor`` multiply the
    per-message compute cost by ``drift_factor`` from virtual/wall time
    ``drift_t_s`` on: the mid-run workload shift that makes a frozen
    characterization fit mispredict and the online re-fit earn its keep.
    """

    scaling_policy: str = "usl"        # usl | usl_online | reactive | static
    rate: dict = field(default_factory=lambda: dict(
        kind="step", base_hz=2.0, high_hz=12.0, t_step=40.0))
    horizon_s: float = 120.0
    initial_partitions: int = 2
    max_partitions: int = 16
    static_partitions: int | None = None
    usl_sigma: float | None = None     # fitted USL model for the predictive
    usl_kappa: float | None = None     # policy (from StreamInsight.fit_models)
    usl_gamma: float | None = None
    control_interval_s: float = 2.0
    slo_lag: int = 32
    catchup_horizon_s: float = 20.0
    stabilization_s: float = 60.0      # scale-down stabilization window
    headroom: float = 0.15
    scale_down_hysteresis: float = 0.25   # Autoscaler downscale band
    max_step_up: int | None = None     # per-tick scale-up slew limit
    migration_s_per_delta: float = 0.05
    points: int = 8000                 # message size knob (MS)
    centroids: int = 1024              # workload complexity knob (WC)
    memory_mb: int = 3008
    policy: str | None = None          # model-sharing consistency
    batch_max: int = 1
    seed: int = 0
    backend_attrs: dict = field(default_factory=dict)
    faults: dict | None = None         # FaultPlan spec (streaming.faults) —
                                       # failure semantics as a scenario axis
    max_retries: int = 2               # per-batch retry budget before poison
    retry_backoff_s: float = 0.0       # exponential-backoff base (0 = immediate)
    engine: str = "sim"                # sim | threaded (wall clock)
    drift_t_s: float | None = None     # per-message cost shifts at this time
    drift_factor: float = 1.0          # ... by this multiplier
    refit_interval_s: float = 10.0     # usl_online: seconds between re-fits
    refit_window: int = 128            # usl_online: sliding sample window
    refit_half_life_s: float = 45.0    # usl_online: recency-weight half-life
    threaded_service_s: float | None = None   # wall s/msg (None → 1/gamma)
    federation: dict | None = None     # machine="federated": member specs +
                                       # breaker/placement knobs (see
                                       # pilot.backends.federated)

    def cost_estimate(self) -> float:
        """Work estimate for the serial-vs-pooled auto-switch (same units
        as ``StreamExperiment``'s ``n_messages × points × centroids``)."""
        msgs = rate_program_from_spec(self.rate).mean_messages(0.0, self.horizon_s)
        return msgs * self.points * self.centroids


@dataclass
class AdaptationResult:
    """EILC report card for one adaptation cell."""

    experiment: AdaptationExperiment
    run_id: str
    slo_violations: int                # control ticks with lag > slo_lag
    ticks: int
    cost_integral: float               # ∫ allocation dt (capacity-seconds)
    scale_events: int
    produced: int
    processed: int
    throughput: float                  # completions/s over the whole run
    latency_px: dict                   # percentile summary of L^px
    alloc_trace: list                  # [[t, allocation], ...]
    lag_trace: list                    # [[t, lag], ...]
    final_allocation: int = 1
    drained: bool = True
    drain_s: float = 0.0               # time past the horizon to empty lag
    wall_virtual_s: float = 0.0
    des_events: int = 0
    refits: int = 0                    # online USL re-fits performed
    abandoned: int = 0                 # batches poisoned past the retry budget
    dup_delivered: int = 0             # redelivered messages settled idempotently
    faults_injected: int = 0           # FaultInjector events fired
    preemptions: int = 0               # capacity-revocation events
    fault_windows: int = 0             # control windows dirtied by faults
    lost: int = 0                      # appended - (processed+abandoned+dups)
    tick_error_log: list = field(default_factory=list)
                                       # last ≤16 [t, repr(exc)] tick failures
    member_ledger: list = field(default_factory=list)
                                       # federated runs: per-member report
                                       # cards (placement, breaker, cost)

    def record(self) -> dict:
        e = self.experiment
        return dict(machine=e.machine, scaling_policy=e.scaling_policy,
                    engine=e.engine,
                    rate_kind=e.rate.get("kind", "?"), horizon_s=e.horizon_s,
                    slo_violations=self.slo_violations, ticks=self.ticks,
                    violation_frac=self.slo_violations / max(self.ticks, 1),
                    cost_integral=self.cost_integral,
                    scale_events=self.scale_events, refits=self.refits,
                    produced=self.produced, processed=self.processed,
                    throughput=self.throughput,
                    latency_px_p95=self.latency_px.get("p95", float("nan")),
                    final_allocation=self.final_allocation,
                    drained=self.drained, drain_s=self.drain_s,
                    abandoned=self.abandoned, dup_delivered=self.dup_delivered,
                    faults_injected=self.faults_injected,
                    preemptions=self.preemptions,
                    fault_windows=self.fault_windows, lost=self.lost)


@dataclass
class AdaptationPlan:
    """One closed-loop run as *data*: the experiment plus execution flags.

    A plan is picklable and JSON-able (it rides the ``run_cells`` process
    pool and keys the ``ResultCache``), and ``run_plan`` is a pure function
    of it — a run is a value, not a script.  ``fast=True`` lets the runner
    take the vectorized serverless replay (``sim.batched``) when the cell
    qualifies; the result is bit-identical either way, so ``fast`` is an
    execution hint, not a semantic axis."""

    experiment: AdaptationExperiment
    fast: bool = True

    def __post_init__(self) -> None:
        if isinstance(self.experiment, dict):   # cache/JSON round-trip
            self.experiment = AdaptationExperiment(**self.experiment)

    def cost_estimate(self) -> float:
        """Work estimate for the ``run_cells`` serial-vs-pool auto-switch
        (a plan costs what its cell costs)."""
        return self.experiment.cost_estimate()


@dataclass
class AdaptationSummary:
    """Compact, trace-free report card of one adaptation cell.

    Everything fig8 tables and what-if reductions consume — violations,
    cost integral, fault ledger, refits, latency percentiles — and nothing
    sized O(events): no alloc/lag traces, no tick-error ring, no DES event
    counts.  This is the payload a fleet of pool workers ships back and
    the ``ResultCache`` memoizes for what-if plans."""

    experiment: AdaptationPlan
    slo_violations: int
    ticks: int
    cost_integral: float
    scale_events: int
    produced: int
    processed: int
    throughput: float
    latency_px: dict
    final_allocation: int = 1
    drained: bool = True
    drain_s: float = 0.0
    refits: int = 0
    abandoned: int = 0
    dup_delivered: int = 0
    faults_injected: int = 0
    preemptions: int = 0
    fault_windows: int = 0
    lost: int = 0
    member_ledger: list = field(default_factory=list)
    fast_path: bool = False            # vectorized replay taken?
    fallback_reason: str | None = None  # why it was not, if ``fast`` asked

    def record(self) -> dict:
        """Flat row for tables; excludes the execution-telemetry fields
        (``fast_path``/``fallback_reason``) so fast and scalar runs of the
        same plan produce *identical* rows."""
        e = self.experiment.experiment
        return dict(machine=e.machine, scaling_policy=e.scaling_policy,
                    engine=e.engine,
                    rate_kind=e.rate.get("kind", "?"), horizon_s=e.horizon_s,
                    seed=e.seed,
                    slo_violations=self.slo_violations, ticks=self.ticks,
                    violation_frac=self.slo_violations / max(self.ticks, 1),
                    cost_integral=self.cost_integral,
                    scale_events=self.scale_events, refits=self.refits,
                    produced=self.produced, processed=self.processed,
                    throughput=self.throughput,
                    latency_px_p95=self.latency_px.get("p95", float("nan")),
                    final_allocation=self.final_allocation,
                    drained=self.drained, drain_s=self.drain_s,
                    abandoned=self.abandoned, dup_delivered=self.dup_delivered,
                    faults_injected=self.faults_injected,
                    preemptions=self.preemptions,
                    fault_windows=self.fault_windows, lost=self.lost)


def summarize_adaptation(res: AdaptationResult, *,
                         plan: AdaptationPlan | None = None,
                         fast_path: bool = False,
                         fallback_reason: str | None = None) -> AdaptationSummary:
    """Compress a full ``AdaptationResult`` into an ``AdaptationSummary``
    (drop the traces, keep the report card)."""
    return AdaptationSummary(
        experiment=plan if plan is not None
        else AdaptationPlan(experiment=res.experiment),
        slo_violations=res.slo_violations, ticks=res.ticks,
        cost_integral=res.cost_integral, scale_events=res.scale_events,
        produced=res.produced, processed=res.processed,
        throughput=res.throughput, latency_px=dict(res.latency_px),
        final_allocation=res.final_allocation, drained=res.drained,
        drain_s=res.drain_s, refits=res.refits, abandoned=res.abandoned,
        dup_delivered=res.dup_delivered, faults_injected=res.faults_injected,
        preemptions=res.preemptions, fault_windows=res.fault_windows,
        lost=res.lost, member_ledger=list(res.member_ledger),
        fast_path=fast_path, fallback_reason=fallback_reason)


def run_plan(plan: AdaptationPlan | AdaptationExperiment,
             metrics: MetricRegistry | None = None) -> AdaptationSummary:
    """Execute one what-if plan → summary.  Pure and picklable: same
    signature contract as ``run_adaptation`` (so it slots into the
    ``run_cells`` cell-type registry), but returns the compact summary.

    With ``plan.fast`` set the qualifying serverless cells run on the
    vectorized replay (``sim.batched``) — bit-identical to the scalar DES
    by construction and tested — and every non-qualifying cell falls back
    to ``run_adaptation`` with the reason recorded on the summary (and
    logged by the fast path)."""
    if isinstance(plan, AdaptationExperiment):
        plan = AdaptationPlan(experiment=plan)
    reason = None
    if plan.fast:
        from repro_torch.sim.batched import try_fast_adaptation
        summary, reason = try_fast_adaptation(plan)
        if summary is not None:
            return summary
    res = run_adaptation(plan.experiment, metrics)
    return summarize_adaptation(res, plan=plan, fast_path=False,
                                fallback_reason=reason)


def scaling_policy_spec(exp: AdaptationExperiment) -> dict:
    """The cell's controller as a JSON-able ``policy_from_spec`` spec.

    This is the declarative form a ``WhatIfDesign`` varies over (policy ×
    hyperparameter grids) and the form cache keys / pool workers see — the
    experiment's scattered controller knobs, gathered into one dict."""
    sp = exp.scaling_policy
    if sp in ("usl", "usl_online"):
        if None in (exp.usl_sigma, exp.usl_kappa, exp.usl_gamma):
            raise ValueError(
                "usl scaling policy needs usl_sigma/usl_kappa/usl_gamma "
                "(fit a characterization sweep first — StreamInsight.fit_models)")
        spec = dict(kind=sp, sigma=exp.usl_sigma, kappa=exp.usl_kappa,
                    gamma=exp.usl_gamma, headroom=exp.headroom,
                    max_partitions=exp.max_partitions,
                    scale_down_hysteresis=exp.scale_down_hysteresis,
                    catchup_horizon_s=exp.catchup_horizon_s,
                    downscale_lag=max(4, exp.slo_lag // 2),
                    stabilization_s=exp.stabilization_s,
                    max_step_up=exp.max_step_up)
        if sp == "usl_online":
            spec.update(refit_interval_s=exp.refit_interval_s,
                        refit_window=exp.refit_window,
                        refit_half_life_s=exp.refit_half_life_s)
        return spec
    if sp == "reactive":
        return dict(kind="reactive", hi_lag=exp.slo_lag,
                    lo_lag=max(1, exp.slo_lag // 8),
                    max_partitions=exp.max_partitions)
    if sp == "static":
        return dict(kind="static")
    raise ValueError(f"unknown scaling_policy {sp!r}")


def _make_scaling_policy(exp: AdaptationExperiment, initial: int):
    return policy_from_spec(scaling_policy_spec(exp), initial=initial)


def adaptation_profile_factory(exp: AdaptationExperiment, now_fn, alloc_fn):
    """Per-allocation cost-profile closure shared by ``run_adaptation`` and
    the what-if fast replay (``sim.batched``).

    Coherence peers track the LIVE allocation (``alloc_fn``), so scaling up
    genuinely buys (and pays for) more peers.  Keyed additionally on whether
    the drift has hit (``now_fn() >= drift_t_s``): from then on the
    per-message cost — compute AND model traffic — is multiplied by
    ``drift_factor``, as if the shared model grew mid-run.  On serverless
    (isolated containers) that shifts gamma; on HPC the scaled model bytes
    also ride the shared filesystem and the coherence fan-out, so sigma AND
    kappa drift — the true USL peak moves, and a frozen fit happily scales
    into what is now the retrograde region.

    One definition serves both execution paths so their float arithmetic
    cannot drift apart."""
    profiles: dict[tuple[int, bool], TaskProfile] = {}

    def profile_for(msgs) -> TaskProfile:
        n = alloc_fn()
        drifted = exp.drift_t_s is not None and now_fn() >= exp.drift_t_s
        prof = profiles.get((n, drifted))
        if prof is None:
            prof = KMeansStreamWorkload(
                points=exp.points, centroids=exp.centroids,
                policy=exp.effective_policy, n_partitions=n).profile()
            if drifted and exp.drift_factor != 1.0:
                f = exp.drift_factor
                prof = replace(prof,
                               flops=prof.flops * f,
                               serial_flops=prof.serial_flops * f,
                               read_bytes=prof.read_bytes * f,
                               write_bytes=prof.write_bytes * f)
            profiles[(n, drifted)] = prof
        return prof

    return profile_for


def _build_injector(exp: AdaptationExperiment, engine, broker, topic, pilot,
                    metrics: MetricRegistry, run_id: str):
    """Materialize the cell's fault axis (``exp.faults`` spec → seeded
    ``FaultInjector``), or ``None`` for a fault-free run."""
    if not exp.faults:
        return None
    plan = FaultPlan.from_spec(exp.faults, default_seed=exp.seed,
                               default_horizon_s=exp.horizon_s)
    return FaultInjector(plan, engine, broker, topic, pilot,
                         metrics=metrics, run_id=run_id)


def _fault_fields(engine, broker, topic, injector, loop) -> dict:
    """Failure-semantics columns of the report card.  ``lost`` is the
    at-least-once ledger residue: appends not settled as exactly-once
    processing, poison abandonment or idempotent duplicate absorption.
    Zero means nothing was lost; negative would mean double-counting."""
    core = engine.core
    settled = core.processed + core.abandoned + core.dup_delivered
    return dict(
        abandoned=core.abandoned,
        dup_delivered=core.dup_delivered,
        faults_injected=injector.injected if injector is not None else 0,
        preemptions=injector.preemptions if injector is not None else 0,
        fault_windows=loop.fault_windows,
        lost=broker.appended_total(topic) - settled,
    )


def run_adaptation(exp: AdaptationExperiment,
                   metrics: MetricRegistry | None = None) -> AdaptationResult:
    """Execute one closed-loop adaptation cell.

    ``exp.engine`` picks the clock: ``"sim"`` builds the same producer →
    broker → engine pipeline as ``run_experiment`` on the virtual clock,
    with the producer *open-loop* (the rate program is the externally
    imposed incoming data rate) and a ``ControlLoop`` periodically
    resizing the elastic backend, resharding the broker and repartitioning
    the engine — deterministic given ``exp.seed``, two runs of the same
    cell produce bit-identical traces.  ``"threaded"`` runs the identical
    control loop on the wall clock: threaded engine, elastic local
    backend, a real-time ticker thread (necessarily *not* bit-reproducible
    — it measures the real machine).
    """
    if exp.engine == "threaded":
        return _run_adaptation_threaded(exp, metrics)
    if exp.engine != "sim":
        raise ValueError(f"unknown engine {exp.engine!r}; "
                         "expected 'sim' or 'threaded'")
    metrics = metrics if metrics is not None else MetricRegistry()
    run_id = new_run_id(f"adapt-{exp.machine}-{exp.scaling_policy}")

    static_n = (exp.static_partitions if exp.static_partitions is not None
                else exp.max_partitions)
    initial = static_n if exp.scaling_policy == "static" else exp.initial_partitions
    initial = max(1, min(initial, exp.max_partitions))

    attrs = dict(exp.backend_attrs)
    if exp.machine == "federated":
        if not exp.federation:
            raise ValueError("machine='federated' needs a federation spec "
                             "(AdaptationExperiment.federation)")
        attrs["federation"] = exp.federation
    pcs = PilotComputeService(seed=exp.seed)
    pilot = pcs.submit_pilot(PilotDescription(
        resource=exp.resource_url, memory_mb=exp.memory_mb,
        partitions=initial, concurrency=initial,
        attrs=attrs))
    backend = pilot.backend
    sim = backend.sim

    broker = Broker()
    topic = "points"
    broker.create_topic(topic, initial)

    profile_for = adaptation_profile_factory(
        exp, lambda: sim.now, lambda: loop.allocation)
    workload = Workload(profile_for=profile_for, name="kmeans-adapt")

    if exp.machine in ("serverless", "federated"):
        # shard ceiling pre-provisioned: Kinesis resharding moves routing,
        # idle shards cost nothing in the ingest model.  A federation
        # fronts its members with the same partitioned ingest — member
        # choice is a routing decision behind the broker, not an ingest one
        ingest = PartitionIngest(sim, exp.max_partitions, bw_per_partition=1e6)
    else:
        ingest = SharedFsIngest(sim, backend.shared_resource(pilot, "fs"))

    wl_bytes = exp.points * POINT_BYTES

    def msg_factory(i: int):
        return (None, {"n_points": exp.points, "seed": exp.seed * 100003 + i},
                wl_bytes)

    program = rate_program_from_spec(exp.rate)
    cap = int(program.mean_messages(0.0, exp.horizon_s) * 2 + 1000)
    producer = SyntheticProducer(
        sim, broker, topic, msg_factory=msg_factory, n_messages=cap,
        run_id=run_id, metrics=metrics, rate_program=program,
        horizon_s=exp.horizon_s, ingest=ingest)
    engine = SimStreamingEngine(
        sim, broker, topic, pilot, workload, metrics, run_id,
        batch_max=exp.batch_max, max_retries=exp.max_retries,
        retry_backoff_s=exp.retry_backoff_s,
        is_input_complete=lambda: producer.done)
    injector = _build_injector(exp, engine, broker, topic, pilot,
                               metrics, run_id)
    loop = ControlLoop(
        engine, broker, topic, pilot,
        _make_scaling_policy(exp, initial),
        metrics=metrics, run_id=run_id, interval_s=exp.control_interval_s,
        slo_lag=exp.slo_lag,
        migration_s_per_delta=exp.migration_s_per_delta,
        fault_signal=injector.window_dirty if injector is not None else None)

    producer.start()
    engine.start()
    if injector is not None:
        injector.start()
    loop.start()
    max_virtual = exp.horizon_s * 6.0 + 600.0
    sim.run_until(t=sim.now + max_virtual, predicate=engine.is_finished)
    drained = engine.is_finished()
    loop.stop()

    lat_px = metrics.latencies(run_id, "append", "complete")
    wall = max(sim.now, 1e-9)
    result = AdaptationResult(
        experiment=exp,
        run_id=run_id,
        slo_violations=loop.slo_violations,
        ticks=loop.ticks,
        cost_integral=loop.cost_integral,
        scale_events=loop.scale_events,
        produced=producer.sent,
        processed=engine.core.processed,
        throughput=engine.core.processed / wall,
        latency_px=percentile_summary(lat_px),
        alloc_trace=metrics.series(f"{run_id}/alloc").tolist(),
        lag_trace=metrics.series(f"{run_id}/lag").tolist(),
        final_allocation=loop.allocation,
        drained=drained,
        drain_s=max(0.0, sim.now - exp.horizon_s),
        wall_virtual_s=sim.now,
        des_events=sim.events_processed,
        refits=loop.refit_events,
        tick_error_log=[[t, r] for t, r in loop.tick_error_log],
        member_ledger=(backend.member_ledger(pilot)
                       if hasattr(backend, "member_ledger") else []),
        **_fault_fields(engine, broker, topic, injector, loop),
    )
    pcs.close()
    return result


# ---------------------------------------------------------------------------
# wall-clock adaptation (threaded engine + elastic local backend)
# ---------------------------------------------------------------------------

class _WallClockProducer(threading.Thread):
    """Open-loop rate-program producer on the wall clock.

    The wall twin of ``SyntheticProducer``'s program mode: emits messages
    at r(t) relative to ``t0`` until ``horizon_s``, appending straight to
    the (clock-agnostic) broker — round-robin over the *active* partitions,
    so live resharding redirects new messages exactly as in the sim.
    Emission times are computed against the absolute schedule (sleep until
    ``t_next``), so append/processing jitter does not accumulate drift.
    """

    def __init__(self, broker: Broker, topic: str, program: RateProgram,
                 horizon_s: float, run_id: str, metrics: MetricRegistry,
                 t0: float, msg_bytes: int = 1000,
                 idle_resolution_s: float = 0.25) -> None:
        super().__init__(daemon=True, name="wall-producer")
        self.broker = broker
        self.topic = topic
        self.program = program
        self.horizon_s = horizon_s
        self.run_id = run_id
        self.metrics = metrics
        self.t0 = t0
        self.msg_bytes = msg_bytes
        self.idle_resolution_s = idle_resolution_s
        self.sent = 0
        self.done = False

    def run(self) -> None:
        rec_produce = self.metrics.recorder(self.run_id, "producer", "produce")
        rec_append = self.metrics.recorder(self.run_id, "broker", "append")
        i = 0
        t_next = 0.0                        # relative emission schedule
        while True:
            t_rel = time.perf_counter() - self.t0
            if t_rel >= self.horizon_s:
                break
            rate = self.program.rate(max(t_rel, t_next))
            if rate <= 1e-9:
                time.sleep(self.idle_resolution_s)
                continue
            if t_next >= self.horizon_s:
                break            # next emission falls past the horizon
            if t_next > t_rel:
                time.sleep(t_next - t_rel)
            msg_id = f"{self.run_id}/{i}"
            now_abs = time.perf_counter()
            rec_produce(now_abs, msg_id=msg_id)
            self.broker.append(self.topic, {"i": i}, ts=now_abs,
                               run_id=self.run_id, msg_id=msg_id,
                               size_bytes=self.msg_bytes)
            rec_append(now_abs, msg_id=msg_id)
            i += 1
            self.sent = i
            t_next = max(t_next, t_rel) + 1.0 / rate
        self.done = True


def _run_adaptation_threaded(exp: AdaptationExperiment,
                             metrics: MetricRegistry | None = None
                             ) -> AdaptationResult:
    """Execute one closed-loop adaptation cell on the wall clock.

    Same observe → decide → act loop, same policies, same report card as
    the sim path — but real time: the ``ThreadedStreamingEngine``'s ticker
    thread drives the ``ControlLoop``, the elastic ``local://`` backend
    grants capacity, and the workload *occupies a worker slot* for
    ``threaded_service_s`` wall seconds per message (default
    ``1/usl_gamma`` — the single-worker rate the fitted model implies),
    times ``drift_factor`` once ``drift_t_s`` passes.
    """
    metrics = metrics if metrics is not None else MetricRegistry()
    run_id = new_run_id(f"adapt-threaded-{exp.scaling_policy}")

    static_n = (exp.static_partitions if exp.static_partitions is not None
                else exp.max_partitions)
    initial = static_n if exp.scaling_policy == "static" else exp.initial_partitions
    initial = max(1, min(initial, exp.max_partitions))

    base_s = exp.threaded_service_s
    if base_s is None:
        base_s = 1.0 / exp.usl_gamma if exp.usl_gamma else 0.05

    pcs = PilotComputeService(seed=exp.seed)
    pilot = pcs.submit_pilot(PilotDescription(
        resource="local://", memory_mb=exp.memory_mb,
        partitions=exp.max_partitions, concurrency=exp.max_partitions,
        attrs=dict(exp.backend_attrs)))
    backend = pilot.backend
    backend.scale_to(pilot, initial)

    broker = Broker()
    topic = "points"
    broker.create_topic(topic, initial)

    t0 = time.perf_counter()

    def process(msgs) -> None:
        t_rel = time.perf_counter() - t0
        factor = (exp.drift_factor
                  if exp.drift_t_s is not None and t_rel >= exp.drift_t_s
                  else 1.0)
        time.sleep(base_s * factor * len(msgs))

    workload = Workload(fn=process, name="sleep-adapt")
    engine = ThreadedStreamingEngine(
        broker, topic, pilot, workload, metrics, run_id,
        batch_max=exp.batch_max, max_retries=exp.max_retries,
        retry_backoff_s=exp.retry_backoff_s, seed=exp.seed)
    injector = _build_injector(exp, engine, broker, topic, pilot,
                               metrics, run_id)
    loop = ControlLoop(
        engine, broker, topic, pilot,
        _make_scaling_policy(exp, initial),
        metrics=metrics, run_id=run_id, interval_s=exp.control_interval_s,
        slo_lag=exp.slo_lag,
        migration_s_per_delta=exp.migration_s_per_delta,
        fault_signal=injector.window_dirty if injector is not None else None)
    producer = _WallClockProducer(
        broker, topic, rate_program_from_spec(exp.rate), exp.horizon_s,
        run_id, metrics, t0, msg_bytes=exp.points * POINT_BYTES)

    engine.start()
    producer.start()
    if injector is not None:
        injector.start()
    loop.start()
    producer.join(timeout=exp.horizon_s + 30.0)
    drained = True
    try:
        engine.drain(producer.sent, timeout=exp.horizon_s * 2.0 + 60.0)
    except TimeoutError:
        drained = False
    end_rel = time.perf_counter() - t0
    loop.stop()
    engine.stop()
    if engine.ticker_error is not None:
        # a control tick raised on the ticker thread: the loop silently
        # stopped re-arming itself mid-run, so the traces/report card are
        # NOT a valid experiment — surface the failure instead
        pcs.close()
        raise RuntimeError(
            "control loop crashed mid-run on the ticker thread"
        ) from engine.ticker_error

    def _rel(trace: np.ndarray) -> list:
        out = trace.tolist()
        return [[t - t0, v] for t, v in out]

    lat_px = metrics.latencies(run_id, "append", "complete")
    result = AdaptationResult(
        experiment=exp,
        run_id=run_id,
        slo_violations=loop.slo_violations,
        ticks=loop.ticks,
        cost_integral=loop.cost_integral,
        scale_events=loop.scale_events,
        produced=producer.sent,
        processed=engine.core.processed,
        throughput=engine.core.processed / max(end_rel, 1e-9),
        latency_px=percentile_summary(lat_px),
        alloc_trace=_rel(metrics.series(f"{run_id}/alloc")),
        lag_trace=_rel(metrics.series(f"{run_id}/lag")),
        final_allocation=loop.allocation,
        drained=drained and producer.done,
        drain_s=max(0.0, end_rel - exp.horizon_s),
        wall_virtual_s=end_rel,
        des_events=0,
        refits=loop.refit_events,
        tick_error_log=[[t - t0, r] for t, r in loop.tick_error_log],
        **_fault_fields(engine, broker, topic, injector, loop),
    )
    pcs.close()
    return result
