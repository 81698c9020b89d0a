"""HPC (Kafka + Dask on Wrangler / Stampede2) mechanism simulation backend.

Ports ``repro.pilot.backends.hpcsim`` (schemes ``hpc://wrangler-sim`` and
``hpc://stampede2-sim``).  On the virtual clock of ``sim.des`` it models the
mechanisms the paper names as the limits of HPC streaming (§IV-C):

* the shared filesystem (Lustre) as a processor-sharing resource (``fs``)
  that message pulls, model reads and writes all ride — the contention
  (sigma) of the USL fit;
* coherence: each task reads every peer's model delta inside the
  shared-model critical section (``model_lock``), so traffic grows with
  N - 1 per task — the kappa term;
* Dask's serial scheduler, a fixed dispatch cost per task;
* faster cores than a Lambda vCPU slice.

It also carries failure injection (``kill_worker``, ``inject_crash``,
``preempt``) and elastic workers that wait out a batch-queue grant.  A
compute unit's real ``func`` runs when the unit completes on the virtual
clock.
"""

from __future__ import annotations

import math
from collections import deque
from dataclasses import dataclass, field

import numpy as np

from repro_torch.pilot.api import Backend, ComputeUnit, Pilot, State, TaskProfile, register_backend
from repro_torch.sim.des import SharedResource, SimLock, Simulator

MACHINES = {
    "wrangler": dict(cores_per_node=48, mem_per_node_gb=128, flops_per_core=5.2e9,
                     fs_bw=950e6),
    "stampede2": dict(cores_per_node=68, mem_per_node_gb=96, flops_per_core=2.6e9,
                      fs_bw=1200e6),
}

DEFAULTS = dict(
    dispatch_s=0.0015,      # serial Dask scheduler cost per task
    coherence_delta_frac=1.0,   # peers' full model deltas are read back
    fs_meta_latency=0.008,  # Lustre metadata/open cost per peer file
    jitter_cv=0.08,         # shared-environment noise
    net_bw=1.1e9,           # node NIC, bytes/s (per flow, before FS sharing)
    grant_delay_s=10.0,     # scheduler queue wait before a grown worker runs
    # Empirical batch-queue wait distribution (log-normal).  When p50/p95
    # are set (p95 > p50 > 0) every grant — elastic growth, crash restart,
    # preemption re-queue — waits out a seeded log-normal sample shaped by
    # those quantiles; unset, the wait is degenerate at grant_delay_s (the
    # flat calibrated delay the fig8 tuning was built on).
    queue_wait_p50_s=None,
    queue_wait_p95_s=None,
)

_Z95 = 1.6448536269514722   # standard-normal 95th percentile


def coupling_terms(cfg: dict, profile: TaskProfile) -> tuple[float, float, float, float]:
    """The per-task coupling terms of the processor-sharing model, as a
    pure function of ``(cfg, profile)``.

    Returns ``(arrival_io_bytes, compute_mean_s, critical_mean_s,
    write_io_bytes)`` — exactly the four quantities the ``_TaskExec``
    phase chain feeds into the shared filesystem and the model lock:

    * ``arrival_io_bytes`` — message pull + model read on the shared FS,
    * ``compute_mean_s`` — the parallel distance phase (private cores),
    * ``critical_mean_s`` — the model-merge critical section: per-peer
      metadata opens plus the serial merge (the sigma/kappa source),
    * ``write_io_bytes`` — model write-back plus the (N-1)-growing
      coherence delta traffic, all riding the shared FS.

    The backend's task chain and the fast replay (``sim.batched``) both
    consume this function, so the coupled service-time chain the replay
    builds is bit-identical to the scalar DES by construction.
    """
    n_peers = profile.coherence_peers
    arrival_io = profile.msg_bytes + profile.read_bytes
    compute_mean = profile.flops / cfg["flops_per_core"]
    critical_mean = (n_peers * cfg["fs_meta_latency"]
                     + profile.serial_flops / cfg["flops_per_core"])
    write_io = profile.write_bytes + (n_peers * max(profile.write_bytes, 1.0)
                                      * cfg["coherence_delta_frac"])
    return arrival_io, compute_mean, critical_mean, write_io


def queue_wait_sample(cfg: dict, rng: np.random.Generator) -> float:
    """One batch-queue wait sample, seconds — pure given ``(cfg, rng)``.

    Default: degenerate at ``grant_delay_s`` — the flat calibrated wait.
    Setting ``queue_wait_p50_s``/``queue_wait_p95_s`` switches to the
    seeded log-normal those quantiles imply (mu = ln p50, sigma =
    ln(p95/p50)/z95) — the empirical heavy-tailed batch-queue shape.
    The backend and the fast replay draw from identically-seeded
    per-pilot streams (``default_rng([seed, uid])``), so grant schedules
    match bit-for-bit.
    """
    p50 = cfg.get("queue_wait_p50_s")
    if p50 is None:
        p50 = cfg["grant_delay_s"]
    p95 = cfg.get("queue_wait_p95_s")
    if p95 is None or p50 <= 0.0 or p95 <= p50:
        return float(p50)
    mu = math.log(p50)
    sigma = math.log(p95 / p50) / _Z95
    return float(rng.lognormal(mu, sigma))


@dataclass
class _Worker:
    wid: int
    busy: bool = False
    alive: bool = True
    pending: bool = False   # granted? elastic growth waits out the queue
    retired: bool = False   # released back to the scheduler by a scale-down
    queue: deque = field(default_factory=deque)


class HpcSimBackend(Backend):
    scheme = "hpc"

    def __init__(self, sim: Simulator | None = None, seed: int = 0, **_kw) -> None:
        self.sim = sim or Simulator(seed=seed)
        self._seed = seed
        self._pilots: dict[int, dict] = {}

    def start_pilot(self, pilot: Pilot) -> None:
        machine = pilot.desc.resource.split("://", 1)[1].replace("-sim", "") or "wrangler"
        if machine not in MACHINES:
            raise ValueError(f"unknown HPC machine '{machine}'; known: {sorted(MACHINES)}")
        cfg = dict(DEFAULTS)
        cfg.update(MACHINES[machine])
        cfg.update(pilot.desc.attrs)
        n_workers = pilot.desc.partitions
        self._pilots[pilot.uid] = {
            "cfg": cfg,
            "machine": machine,
            "workers": [_Worker(i) for i in range(max(1, n_workers))],
            "fs": SharedResource(self.sim, cfg["fs_bw"], name="lustre"),
            "model_lock": SimLock(self.sim, name="model"),
            "sched_queue": deque(),
            "sched_busy": False,
            "rr": 0,
            "target": max(1, n_workers),
            "mapping": None,     # cached non-retired worker list
            # dedicated queue-wait stream: decoupled from the service-time
            # jitter stream so enabling the empirical wait distribution
            # cannot perturb unrelated draws (per-pilot, seeded)
            "queue_rng": np.random.default_rng([self._seed, pilot.uid]),
        }
        pilot.state = State.RUNNING

    def _queue_wait(self, st: dict) -> float:
        """One batch-queue wait sample from the pilot's dedicated stream
        (see ``queue_wait_sample`` — the pure sampler shared with the
        fast replay)."""
        return queue_wait_sample(st["cfg"], st["queue_rng"])

    # -- elasticity ----------------------------------------------------------
    def _mapping(self, st: dict) -> list[_Worker]:
        """Non-retired workers, in wid order — the partition → worker map.
        Dead (killed) workers stay in the map so pinned dispatch to them
        keeps failing fast (the engine's unpin-and-retry path owns that)."""
        m = st["mapping"]
        if m is None:
            m = st["mapping"] = [w for w in st["workers"] if not w.retired]
        return m

    def scale_to(self, pilot: Pilot, n: int) -> int:
        """Elastic worker pool with HPC semantics: growth submits new
        workers to the batch scheduler and they only start accepting work
        after ``grant_delay_s`` (queue wait + node grant); work pinned to a
        not-yet-granted worker queues on it and waits the grant out.
        Shrink releases the most recently granted workers back to the
        scheduler: running tasks finish, queued ones are reassigned under
        the new mapping."""
        st = self._pilots[pilot.uid]
        n = max(1, int(n))
        st["target"] = n
        workers = st["workers"]
        active = [w for w in workers if not w.retired]
        if n > len(active):
            for _ in range(n - len(active)):
                w = _Worker(len(workers), pending=True)
                workers.append(w)

                def grant(w: _Worker = w) -> None:
                    w.pending = False
                    self._pump_worker(pilot, w)

                self.sim.schedule_fast(self._queue_wait(st), grant)
        elif n < len(active):
            victims = active[n:]
            for w in victims:
                w.retired = True
            st["mapping"] = None
            for w in victims:
                orphans = [cu for cu in w.queue if not cu.state.is_final]
                w.queue.clear()
                for cu in orphans:
                    self._assign(pilot, cu)
        st["mapping"] = None
        return n

    def allocation(self, pilot: Pilot) -> int:
        return self._pilots[pilot.uid]["target"]

    def effective_allocation(self, pilot: Pilot) -> int:
        """Workers granted by the batch scheduler: grown workers still in
        the queue (``pending``) don't count until ``grant_delay_s``
        elapses — the window where the target runs ahead of reality and a
        capacity observation must not be credited to the target N."""
        return sum(1 for w in self._pilots[pilot.uid]["workers"]
                   if not w.retired and not w.pending)

    def cancel_pilot(self, pilot: Pilot) -> None:
        st = self._pilots.get(pilot.uid)
        if st:
            st["sched_queue"].clear()
            for w in st["workers"]:
                w.queue.clear()
        for cu in pilot.compute_units:
            if not cu.state.is_final:
                cu._set_canceled(self.sim.now)

    _SHARED_RESOURCES = ("fs", "model_lock")

    def shared_resource(self, pilot: Pilot, name: str):
        """Public accessor for the pilot's shared infrastructure: ``"fs"``
        (the Lustre ``SharedResource``) or ``"model_lock"`` (the shared-model
        ``SimLock``)."""
        if name not in self._SHARED_RESOURCES:
            raise LookupError(
                f"hpc backend exposes {self._SHARED_RESOURCES}, not {name!r}")
        return self._pilots[pilot.uid][name]

    # -- failure injection ------------------------------------------------
    def kill_worker(self, pilot: Pilot, wid: int) -> list[ComputeUnit]:
        """Simulate a node failure: fail the running CU, drop queued ones."""
        st = self._pilots[pilot.uid]
        w = st["workers"][wid]
        w.alive = False
        orphans = []
        for cu in pilot.compute_units:
            if getattr(cu, "attrs", {}).get("worker") == wid and not cu.state.is_final:
                cu._set_failed(self.sim.now, ConnectionError(f"worker {wid} died"))
                orphans.append(cu)
        orphans.extend(w.queue)
        for cu in list(w.queue):
            if not cu.state.is_final:
                cu._set_failed(self.sim.now, ConnectionError(f"worker {wid} died (queued)"))
        w.queue.clear()
        return orphans

    def _evict(self, pilot: Pilot, st: dict, w: _Worker, why: str) -> None:
        """Evict one granted worker back into the batch queue: the running
        CU fails with ``ConnectionError`` (the engine's unpinned retry path
        re-dispatches), queued work is reassigned under the current
        mapping, and the worker re-grants after a fresh queue-wait
        sample."""
        w.pending = True
        for cu in pilot.compute_units:
            if not cu.state.is_final \
                    and cu.attrs.get("worker") == w.wid \
                    and cu.state == State.RUNNING:
                cu._set_failed(self.sim.now,
                               ConnectionError(f"worker {w.wid} {why}"))
        orphans = [cu for cu in w.queue if not cu.state.is_final]
        w.queue.clear()

        def regrant(w: _Worker = w) -> None:
            w.pending = False
            self._pump_worker(pilot, w)

        self.sim.schedule_fast(self._queue_wait(st), regrant)
        for cu in orphans:
            self._assign(pilot, cu)

    def inject_crash(self, pilot: Pilot, count: int = 1) -> int:
        """Node crash with restart-through-the-queue semantics (busy
        workers first): the running CU fails, queued work is reassigned,
        and the node re-enters the batch queue — re-granted only after a
        fresh queue-wait sample, unlike serverless's instant container
        restart."""
        st = self._pilots[pilot.uid]
        granted = [w for w in st["workers"]
                   if w.alive and not w.retired and not w.pending]
        busy = [w for w in granted if w.busy]
        idle = [w for w in granted if not w.busy]
        victims = (busy + idle)[:count]
        for w in victims:
            self._evict(pilot, st, w, "crashed")
        return len(victims)

    def preempt(self, pilot: Pilot, count: int = 1) -> int:
        """Spot-style eviction of granted workers back into the batch
        queue, most recently granted first: running work fails, queued
        work is reassigned, and the evicted workers wait out a fresh
        queue-wait sample — during which ``effective_allocation`` dips
        below target (the signal the control loop's granted==target
        gating keys on)."""
        st = self._pilots[pilot.uid]
        granted = [w for w in st["workers"]
                   if w.alive and not w.retired and not w.pending]
        victims = granted[-count:] if count > 0 else []
        for w in victims:
            self._evict(pilot, st, w, "preempted")
        return len(victims)

    # -- scheduling: serial dispatcher --------------------------------------
    def submit(self, pilot: Pilot, cu: ComputeUnit) -> None:
        cu.submit_ts = self.sim.now
        cu.state = State.PENDING
        st = self._pilots[pilot.uid]
        st["sched_queue"].append(cu)
        self._pump_scheduler(pilot)

    def _pump_scheduler(self, pilot: Pilot) -> None:
        st = self._pilots[pilot.uid]
        if st["sched_busy"] or not st["sched_queue"]:
            return
        st["sched_busy"] = True
        cu = st["sched_queue"].popleft()

        def dispatched() -> None:
            st["sched_busy"] = False
            if not cu.state.is_final:
                self._assign(pilot, cu)
            self._pump_scheduler(pilot)

        self.sim.schedule_fast(st["cfg"]["dispatch_s"], dispatched)

    def _assign(self, pilot: Pilot, cu: ComputeUnit) -> None:
        st = self._pilots[pilot.uid]
        mapping = self._mapping(st)
        if cu.desc.partition is not None:
            # pinned: modulo over the non-retired mapping (identical to the
            # raw worker list until the first elastic scale-down)
            w = mapping[cu.desc.partition % len(mapping)]
            if not w.alive:
                cu._set_failed(self.sim.now, ConnectionError(
                    f"worker {w.wid} for partition {cu.desc.partition} is dead"))
                return
        else:
            alive = [w for w in mapping if w.alive]
            if not alive:
                cu._set_failed(self.sim.now, ConnectionError("no alive workers"))
                return
            # not-yet-granted workers rank last: queueing real work on a
            # node still in the batch queue only helps if everyone else is
            # loaded deeper than the grant delay is long
            w = min(alive, key=lambda w: (w.pending,
                                          len(w.queue) + (1 if w.busy else 0),
                                          w.wid))
        w.queue.append(cu)
        self._pump_worker(pilot, w)

    # -- worker execution: compute + shared-FS I/O + coherence -----------------
    def _pump_worker(self, pilot: Pilot, w: _Worker) -> None:
        if w.busy or w.pending or not w.queue or not w.alive:
            return
        cu = w.queue.popleft()
        if cu.state.is_final:
            self._pump_worker(pilot, w)
            return
        st = self._pilots[pilot.uid]
        w.busy = True
        cu._set_running(self.sim.now)
        cu.attrs = {"worker": w.wid}
        # phase 1: pull message from the broker log (shared FS resident) and
        #          read the current model from the shared FS
        # phase 2: parallel compute — the distance phase (private cores)
        # phase 3: model read-modify-write CRITICAL SECTION on the shared
        #          model file: acquire the global lock, read every peer's
        #          delta (coherence — metadata + bytes, both on the shared
        #          FS), merge (serial_flops), write back, release.
        #          Constant lock-hold → sigma; (N-1)-growing hold → kappa.
        task = _TaskExec(self, pilot, w, cu, st)
        st["fs"].submit(task.arrival_io, task.phase_compute)

    def drive_until(self, predicate, timeout) -> None:
        self.sim.run_until(t=None if timeout is None else self.sim.now + timeout,
                           predicate=predicate)
        if not predicate():
            raise TimeoutError("hpc sim drive_until exhausted events/timeout")


class _TaskExec:
    """Per-task phase chain, one ``__slots__`` object with bound-method
    continuations instead of a fresh stack of closures per task (the
    mini-app pushes hundreds of tasks per cell through this path)."""

    __slots__ = ("backend", "pilot", "w", "cu", "st", "cfg",
                 "arrival_io", "compute_mean", "critical_mean", "write_io")

    def __init__(self, backend: HpcSimBackend, pilot: Pilot, w: _Worker,
                 cu: ComputeUnit, st: dict) -> None:
        self.backend = backend
        self.pilot = pilot
        self.w = w
        self.cu = cu
        self.st = st
        self.cfg = st["cfg"]
        p = cu.desc.profile or TaskProfile()
        (self.arrival_io, self.compute_mean,
         self.critical_mean, self.write_io) = coupling_terms(self.cfg, p)

    def phase_compute(self) -> None:
        sim = self.backend.sim
        sim.schedule_fast(sim.lognormal_jitter(self.compute_mean,
                                               self.cfg["jitter_cv"]),
                          self.phase_model_update)

    def phase_model_update(self) -> None:
        self.st["model_lock"].acquire(self.in_critical_section)

    def in_critical_section(self) -> None:
        sim = self.backend.sim
        sim.schedule_fast(sim.lognormal_jitter(self.critical_mean,
                                               self.cfg["jitter_cv"]),
                          self.do_io)

    def do_io(self) -> None:
        self.st["fs"].submit(self.write_io, self.unlock)

    def unlock(self) -> None:
        self.st["model_lock"].release()
        self.finish()

    def finish(self) -> None:
        backend, w, cu = self.backend, self.w, self.cu
        if not w.alive:
            return  # kill_worker already failed the CU
        w.busy = False
        if not cu.state.is_final:
            result = None
            if cu.desc.func is not None:
                try:
                    result = cu.desc.func(*cu.desc.args, **cu.desc.kwargs)
                except BaseException as exc:  # noqa: BLE001
                    cu._set_failed(backend.sim.now, exc)
                    backend._pump_worker(self.pilot, w)
                    return
            cu._set_done(backend.sim.now, result)
        backend._pump_worker(self.pilot, w)


register_backend("hpc", HpcSimBackend)
