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

Not ported yet (they come with ``core/autoscale.py``): the adaptation half —
``AdaptationExperiment``, ``run_adaptation``, its wall-clock producer,
``AdaptationPlan``/``run_plan`` and the adaptation summaries — and the
``federated`` machine (with ``pilot/backends/federated.py``).

Model-sharing consistency: ``full_fit_locked`` (the HPC default: the
partial_fit inside the shared-model critical section, the paper's measured
Dask sigma), ``update_locked`` (distances against a stale model outside
the lock) and ``lock_free`` (serverless: S3 last-writer-wins).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np

from repro_torch.core.metrics import MetricRegistry, new_run_id, percentile_summary
from repro_torch.pilot.api import (PilotComputeService, PilotDescription, State,
                                   TaskProfile)
from repro_torch.streaming.broker import Broker, Message
from repro_torch.streaming.engine import SimStreamingEngine, Workload
from repro_torch.streaming.faults import FaultInjector, FaultPlan
from repro_torch.streaming.producer import (AIMD, PartitionIngest, SharedFsIngest,
                                            SyntheticProducer)

__all__ = ["StreamExperiment", "ExperimentResult", "KMeansStreamWorkload",
           "run_experiment", "steady_state_throughput", "default_consistency",
           "POINT_BYTES", "KMEANS_DIM", "IMPL_OVERHEAD", "SERIALIZE_FLOPS_PER_BYTE"]


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

    @property
    def resource_url(self) -> str:
        if self.machine == "serverless":
            return "serverless://aws-sim"
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
