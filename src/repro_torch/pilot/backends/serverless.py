"""Serverless (AWS Lambda + Kinesis) mechanism simulation backend.

Ports ``repro.pilot.backends.serverless`` (scheme ``serverless://aws-sim``).
On the virtual clock of ``sim.des`` it models the Lambda mechanics the
paper measures (§IV-B1): CPU share proportional to memory (memory capped at
3,008 MB), a container pool of ``min(partitions, 30)``, a cold start on a
container's first invocation, the 15-minute walltime, isolated containers
(no shared resource, so sigma and kappa stay near 0 in the USL fit) and
lognormal jitter with cv proportional to 1/memory.

Service time of a task with profile p on a container with memory m:

    t = cold_start?                     (once per container)
      + p.msg_bytes / net_bw            (broker -> container transfer)
      + p.flops / (cpu_share(m) * FLOPS_PER_VCPU)
      + (p.read_bytes + p.write_bytes) / s3_bw + 2 * s3_latency
      + coherence: p.coherence_peers * (s3_latency + peer_delta/s3_bw)

A compute unit's real ``func``, if it has one, runs when the unit completes
on the virtual clock (for its state effects): the port can carry a real
K-Means update on the card inside a simulated cell without moving the
clock.  All constants are overridable via ``PilotDescription.attrs``.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass

from repro_torch.pilot.api import Backend, ComputeUnit, Pilot, State, TaskProfile, register_backend
from repro_torch.sim.des import Simulator

# Calibration constants (overridable via attrs). FLOPS_PER_VCPU is an
# effective numpy-workload rate, not peak.
DEFAULTS = dict(
    flops_per_vcpu=2.4e9,
    mb_per_vcpu=1792.0,
    memory_cap_mb=3008.0,
    max_containers=30,
    cold_start_s=0.35,
    net_bw=100e6,          # broker->container, bytes/s (per container)
    s3_bw=85e6,            # S3 per-connection bandwidth, bytes/s
    s3_latency=0.018,      # per S3 request, s
    jitter_cv_ref=0.03,    # cv at memory_cap; cv = ref * cap/memory
    invoke_overhead_s=0.002,
    preempt_restore_s=30.0,  # spot capacity returns after this delay
)


def service_time_mean(cfg: dict, memory_mb: float, profile: TaskProfile,
                      cold: bool) -> tuple[float, float]:
    """Deterministic Lambda service-time model: ``(mean_s, jitter_cv)``.

    Pure function of the calibration constants, container memory, task
    profile and cold flag — the stochastic part (one lognormal draw around
    ``mean_s`` with ``jitter_cv``) stays with the caller's simulator.
    Shared between ``ServerlessSimBackend.service_time`` and the what-if
    fast replay (``sim.batched``), so both paths run the *same* float
    arithmetic in the same order: bit-agreement between them is by
    construction, not by parallel maintenance.
    """
    m = min(memory_mb, cfg["memory_cap_mb"])
    cpu_share = m / cfg["mb_per_vcpu"]
    t = cfg["invoke_overhead_s"]
    if cold:
        t += cfg["cold_start_s"]
    t += profile.msg_bytes / cfg["net_bw"]
    # serial_flops run lock-free here: S3 model sharing is last-writer-
    # wins (no consistent read-modify-write), the paper's "better
    # resource isolation" on Lambda.
    t += (profile.flops + profile.serial_flops) / (cpu_share * cfg["flops_per_vcpu"])
    io_bytes = profile.read_bytes + profile.write_bytes
    if io_bytes > 0:
        t += io_bytes / cfg["s3_bw"] + 2 * cfg["s3_latency"]
    if profile.coherence_peers > 0:
        # state is externalized: peers' deltas fetched from S3 —
        # isolated per-container bandwidth, so cost is linear in peers
        # with a small constant (no shared medium -> tiny kappa).
        delta = max(profile.write_bytes, 1.0) * 0.05
        t += profile.coherence_peers * (cfg["s3_latency"] * 0.1 + delta / cfg["s3_bw"])
    cv = cfg["jitter_cv_ref"] * (cfg["memory_cap_mb"] / m)
    return t, cv


@dataclass
class _Container:
    cid: int
    warm: bool = False
    busy: bool = False
    dead: bool = False                  # crashed/preempted: finish is void
    cu: ComputeUnit | None = None       # in-flight invocation, if busy


class ServerlessSimBackend(Backend):
    scheme = "serverless"

    def __init__(self, sim: Simulator | None = None, seed: int = 0, **_kw) -> None:
        self.sim = sim or Simulator(seed=seed)
        self._pilots: dict[int, dict] = {}

    # -- pilot lifecycle -----------------------------------------------------
    def start_pilot(self, pilot: Pilot) -> None:
        cfg = dict(DEFAULTS)
        cfg.update(pilot.desc.attrs)
        n_containers = min(
            pilot.desc.concurrency or pilot.desc.partitions,
            int(cfg["max_containers"]),
        )
        containers = [_Container(i) for i in range(max(1, n_containers))]
        self._pilots[pilot.uid] = {
            "cfg": cfg,
            "containers": containers,
            # idle pool, seeded in cid order; freed containers return to
            # the HEAD, so the most recently warmed container is reused
            # first — sequential demand pays one cold start instead of
            # round-robining the whole pool cold
            "free": deque(containers),
            "queue": deque(),
            "target": len(containers),
            "next_cid": len(containers),
        }
        pilot.state = State.RUNNING

    # -- elasticity ----------------------------------------------------------
    def scale_to(self, pilot: Pilot, n: int) -> int:
        """Elastic concurrency: grow the container pool with *fresh* (cold)
        containers, shrink by retiring idle ones immediately and busy ones
        as they finish.  New containers pay ``cold_start_s`` on their first
        invocation — the per-container scale-up price the control loop's
        cost/SLO traces must account for.  Clamped to [1, max_containers]."""
        st = self._pilots[pilot.uid]
        n = max(1, min(int(n), int(st["cfg"]["max_containers"])))
        st["target"] = n
        containers, free = st["containers"], st["free"]
        # shrink: retire from the TAIL of the free pool (the coldest end —
        # recently warmed containers at the head keep serving)
        while len(containers) > n and free:
            containers.remove(free.pop())
        # grow: fresh containers join cold; they warm on first use
        while len(containers) < n:
            c = _Container(st["next_cid"])
            st["next_cid"] += 1
            containers.append(c)
            free.append(c)
        self._dispatch(pilot)
        return n

    def allocation(self, pilot: Pilot) -> int:
        return self._pilots[pilot.uid]["target"]

    def effective_allocation(self, pilot: Pilot) -> int:
        """Containers that exist right now: growth is instant (fresh
        containers are usable immediately, merely cold), but a shrink's
        busy containers linger until their in-flight task finishes."""
        return len(self._pilots[pilot.uid]["containers"])

    def cancel_pilot(self, pilot: Pilot) -> None:
        st = self._pilots.get(pilot.uid)
        if st:
            st["queue"].clear()
        for cu in pilot.compute_units:
            if not cu.state.is_final:
                cu._set_canceled(self.sim.now)

    # -- fault surface ---------------------------------------------------------
    def _kill(self, st: dict, container: _Container, why: str) -> None:
        """Remove one container; its in-flight invocation (if any) fails
        with ``ConnectionError`` so the engine's unpinned retry path takes
        over.  The pending ``finish`` event is voided by the dead flag."""
        container.dead = True
        st["containers"].remove(container)
        if container in st["free"]:
            st["free"].remove(container)
        cu = container.cu
        container.cu = None
        if cu is not None and not cu.state.is_final:
            cu._set_failed(self.sim.now,
                           ConnectionError(f"container {container.cid} {why}"))

    def inject_crash(self, pilot: Pilot, count: int = 1) -> int:
        """Crash up to ``count`` containers (busy first — a crash that hits
        nothing is a non-event): the invocation fails and Lambda restarts
        the container immediately, so a fresh *cold* replacement joins the
        pool at once — the crash costs a retry plus a cold start, not
        capacity."""
        st = self._pilots[pilot.uid]
        victims = [c for c in st["containers"] if c.busy][:count]
        if len(victims) < count:
            victims += [c for c in st["containers"]
                        if not c.busy][:count - len(victims)]
        for c in victims:
            self._kill(st, c, "crashed")
            fresh = _Container(st["next_cid"])
            st["next_cid"] += 1
            st["containers"].append(fresh)
            st["free"].append(fresh)
        if victims:
            self._dispatch(pilot)
        return len(victims)

    def preempt(self, pilot: Pilot, count: int = 1) -> int:
        """Spot reclamation: revoke up to ``count`` live containers (newest
        idle first, then busy ones — in-flight work fails like a crash).
        Unlike a crash the capacity is *gone*: ``effective_allocation``
        dips until fresh cold containers restore the pool toward target
        after ``preempt_restore_s``."""
        st = self._pilots[pilot.uid]
        containers = st["containers"]
        idle = [c for c in reversed(containers) if not c.busy]
        busy = [c for c in reversed(containers) if c.busy]
        victims = (idle + busy)[:count]
        for c in victims:
            self._kill(st, c, "preempted")
        n = len(victims)
        if n:
            self.sim.schedule_fast(float(st["cfg"]["preempt_restore_s"]),
                                   lambda: self._restore_preempted(pilot, n))
        return n

    def _restore_preempted(self, pilot: Pilot, n: int) -> None:
        st = self._pilots.get(pilot.uid)
        if st is None:
            return
        restored = 0
        while restored < n and len(st["containers"]) < st["target"]:
            c = _Container(st["next_cid"])
            st["next_cid"] += 1
            st["containers"].append(c)
            st["free"].append(c)
            restored += 1
        if restored:
            self._dispatch(pilot)

    # -- execution -------------------------------------------------------------
    def submit(self, pilot: Pilot, cu: ComputeUnit) -> None:
        cu.submit_ts = self.sim.now
        cu.state = State.PENDING
        st = self._pilots[pilot.uid]
        st["queue"].append(cu)
        # dispatch synchronously: invocation latency is modeled inside
        # service_time (invoke_overhead_s), so the zero-delay hop event the
        # seed scheduled here bought nothing but heap traffic.  Completion
        # is always a future event, so callers attach done-callbacks before
        # any completion can fire.
        self._dispatch(pilot)

    def _dispatch(self, pilot: Pilot) -> None:
        st = self._pilots[pilot.uid]
        queue, free_pool = st["queue"], st["free"]
        while queue:
            if not free_pool:
                return
            cu = queue.popleft()
            if cu.state.is_final:
                continue
            self._start(pilot, cu, free_pool.popleft())

    def service_time(self, cfg: dict, memory_mb: float, profile: TaskProfile,
                     cold: bool) -> float:
        t, cv = service_time_mean(cfg, memory_mb, profile, cold)
        return self.sim.lognormal_jitter(t, cv)

    def _start(self, pilot: Pilot, cu: ComputeUnit, container: _Container) -> None:
        st = self._pilots[pilot.uid]
        cfg = st["cfg"]
        profile = cu.desc.profile or TaskProfile()
        if profile.memory_mb > min(pilot.desc.memory_mb, cfg["memory_cap_mb"]):
            st["free"].appendleft(container)   # never started: back in the pool
            cu._set_failed(self.sim.now, MemoryError(
                f"task working set {profile.memory_mb} MB exceeds container "
                f"{pilot.desc.memory_mb} MB"))
            return
        container.busy = True
        container.cu = cu
        cold = not container.warm
        container.warm = True
        cu._set_running(self.sim.now)
        cu.attrs = {"container": container.cid, "cold": cold}
        dt = self.service_time(cfg, pilot.desc.memory_mb, profile, cold)

        def finish() -> None:
            if container.dead:
                return     # crashed/preempted mid-flight: already failed
            container.busy = False
            container.cu = None
            if len(st["containers"]) > st["target"]:
                # a scale-down landed while this container was busy: retire
                # it now instead of returning it to the pool
                st["containers"].remove(container)
            else:
                st["free"].appendleft(container)
            if dt > pilot.desc.walltime_s:
                cu._set_failed(self.sim.now, TimeoutError(
                    f"walltime {pilot.desc.walltime_s}s exceeded (needed {dt:.1f}s)"))
            else:
                result = None
                if cu.desc.func is not None:
                    try:
                        result = cu.desc.func(*cu.desc.args, **cu.desc.kwargs)
                    except BaseException as exc:  # noqa: BLE001
                        cu._set_failed(self.sim.now, exc)
                        self._dispatch(pilot)
                        return
                cu._set_done(self.sim.now, result)
            self._dispatch(pilot)

        self.sim.schedule_fast(min(dt, pilot.desc.walltime_s), finish)

    def drive_until(self, predicate, timeout) -> None:
        self.sim.run_until(t=None if timeout is None else self.sim.now + timeout,
                           predicate=predicate)
        if not predicate():
            raise TimeoutError("serverless sim drive_until exhausted events/timeout")


register_backend("serverless", ServerlessSimBackend)
