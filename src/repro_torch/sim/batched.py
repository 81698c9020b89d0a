"""Batched fast replay of closed-loop adaptation cells.

The what-if engine (``core.whatif``) sweeps (scenario × policy × seed)
grids whose cells are dominated by DES heap traffic that is *structurally
predictable*: the producer's emission times are a pure function of the
rate program (no RNG), the ingest paths are processor-sharing queues with
no stochastic input, fault plans expand to a schedule that is fully known
before the run starts (``streaming.faults.expand_plan``), and the random
draws — per-invocation lognormal jitter, retry backoff, HPC batch-queue
waits — come from seeded streams whose consumption order is fixed by the
event order.  This module exploits that structure: it replays only the
*irreducible* events (appends, invocation finishes, fault firings,
control ticks) through a real ``Simulator`` driving the real
``ControlLoop`` / policy / ``OnlineUSLEstimator`` objects.

Bit-agreement with ``run_adaptation`` is a construction invariant, not an
aspiration: the control loop, policy stack, USL estimator, the service
time model (``serverless.service_time_mean``) and the HPC coupling terms
(``hpcsim.coupling_terms`` / ``hpcsim.queue_wait_sample``) are the *same
code objects* the scalar path runs; the replay reproduces the scalar
path's float arithmetic (VFT virtual-time updates, ``now + delay``
timestamp sums, the 256-block normal stream via ``Simulator.normals``,
the ``[seed, uid]``-seeded queue-wait stream) operation for operation,
and the tests assert equality field-by-field across seeds and policies.

Eligibility matrix (static, checked before anything runs):

=====================  =====================================================
cell shape             fast path
=====================  =====================================================
serverless, no faults  windowed replay: columnar ingest shards between
                       control ticks, event-true container pool
serverless + faults    windowed replay + fault splicing: crash/preempt/
                       stall/duplicate events armed from the pre-expanded
                       plan, restart gaps and redelivery spliced into the
                       completion chain (at-least-once ledger bit-identical)
wrangler / stampede2   event-true HPC replay: coupled service-time chain on
(± faults)             a real shared-FS ``SharedResource`` and model
                       ``SimLock``, per-window effective rates from
                       ``hpcsim.coupling_terms``, seeded log-normal queue
                       waits from ``hpcsim.queue_wait_sample``
=====================  =====================================================

Still declining (the scalar DES remains the reference for these):

* ``engine != "sim"`` — the wall clock cannot be replayed;
* ``machine == "federated"`` — member routing, health breakers and
  cost-aware placement form a state machine across backends that the
  replay does not model;
* ``batch_max != 1`` — the replay models one invocation per message (the
  paper's Lambda mapping);
* serverless cells whose working set exceeds the container (the
  memory-failure path is a retry loop, not a replayable fast path).

Runtime fallbacks (the replay *starts*, then discovers the cell leaves
the fast regime): a straggler speculation would fire, or a serverless
invocation would exceed the walltime limit.  Both raise
``_FallbackNeeded``; the caller reruns the cell on the scalar DES and the
reason is logged (INFO — the replay started and bailed; static declines
log at DEBUG, they are expected and per-grid numerous) and recorded on
the summary (``fallback_reason``).

Because summaries are bit-identical, the fast and scalar paths share
``cache_key`` entries in ``streaminsight``'s result cache — including the
newly-eligible fault and HPC shapes: a cached scalar summary satisfies a
fast request and vice versa.  That sharing is only sound while the
bit-identity contract holds; anything weaker must use a distinct key.

The lockstep steppers advance S seeds in one call on the card:
``lockstep_completion_times`` collapses static single-partition cells to
one scan, and ``grid_lockstep_completion_times`` lifts the same S-seed
scan to controller-driven multi-container cells by freezing the
reference seed's dispatch trajectory (partition/container assignment and
exogenous ready floors) and replaying every seed's jitter draws through
the frozen structure.  Each scan is one launch of a hand-written kernel
(``kernels/lockstep_scan``) on CUDA tensors and its plain PyTorch version
on CPU tensors.  Both run in float32, so their agreement contract is a
documented tolerance (``LOCKSTEP_RTOL``), not bit equality; they feed
informational rows, never the tournament results.

Ports ``repro.sim.batched``: the replay's summaries equal the reference's
bit for bit; the reference's ``jax.vmap(lax.scan)`` steppers are the
kernels above.
"""

from __future__ import annotations

import heapq
import json
import logging
import math
import statistics
from collections import deque
from dataclasses import replace

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.autoscale import ControlLoop, policy_from_spec
from repro_torch.core.metrics import percentile_summary
from repro_torch.core.miniapp import (AdaptationExperiment, AdaptationPlan,
                                AdaptationSummary, KMeansStreamWorkload,
                                POINT_BYTES, adaptation_profile_factory,
                                scaling_policy_spec)
from repro_torch.pilot.backends.hpcsim import (DEFAULTS as HPC_DEFAULTS, MACHINES,
                                         coupling_terms, queue_wait_sample)
from repro_torch.pilot.backends.serverless import DEFAULTS, service_time_mean
from repro_torch.sim.des import SharedResource, SimLock, Simulator
from repro_torch.streaming.faults import expand_plan
from repro_torch.kernels.lockstep_scan import ops as lockstep_ops
from repro_torch.streaming.producer import rate_program_from_spec

__all__ = ["try_fast_adaptation", "lockstep_completion_times",
           "lockstep_eligibility", "lockstep_inputs", "grid_lockstep_completion_times",
           "grid_lockstep_eligibility", "grid_lockstep_inputs", "LOCKSTEP_RTOL"]

log = logging.getLogger("repro_torch.sim.batched")

# wiring constants of run_adaptation's pipeline (the replay must agree
# with them exactly; they are assembly facts, not knobs)
_REQUEST_LATENCY = 0.01      # PartitionIngest default request_latency
_FS_REQUEST_LATENCY = 0.002  # SharedFsIngest default request_latency
_INGEST_BW = 1e6             # run_adaptation's bw_per_partition (Kinesis)
_IDLE_RESOLUTION_S = 0.25    # SyntheticProducer idle probe spacing
_WALLTIME_S = 900.0          # PilotDescription default walltime
_RETRY_CAP_S = 30.0          # _EngineCore default retry_backoff_cap_s

_INF = float("inf")


class _FallbackNeeded(RuntimeError):
    """The cell left the replayable regime mid-run — rerun it scalar."""


# ---------------------------------------------------------------------------
# emission schedule: pure function of (rate spec, horizon), shared per grid
# ---------------------------------------------------------------------------

_EMISSION_CACHE: dict[tuple, tuple[list[float], float, list[float]]] = {}
_EMISSION_CACHE_MAX = 32


def _emission_schedule(rate_spec: dict, horizon_s: float,
                       cap: int) -> tuple[list[float], float, list[float]]:
    """Replay ``SyntheticProducer._tick_program``'s event chain off-line.

    Returns ``(emit_times, finish_t, sched_times)``: the exact float
    timestamps of every emission, the production-over event time, and for
    each emission the timestamp of the *program event that scheduled it*
    (the previous emission or idle probe — needed to resolve heap-order
    ties when an emission lands exactly on a control-tick boundary).
    The chain is RNG-free, so one schedule serves every seed and policy of
    a what-if grid.
    """
    key = (json.dumps(rate_spec, sort_keys=True, default=str),
           horizon_s, cap)
    hit = _EMISSION_CACHE.get(key)
    if hit is not None:
        return hit
    program = rate_program_from_spec(rate_spec)
    emit: list[float] = []
    sched: list[float] = []
    t = 0.0
    prev = 0.0          # ts of the program event that scheduled event at t
    while True:
        if t >= horizon_s or len(emit) >= cap:
            finish_t = t
            finish_sched = prev
            break
        rate = program.rate(t)
        if rate <= 1e-9:
            prev = t
            t = t + _IDLE_RESOLUTION_S
            continue
        emit.append(t)
        sched.append(prev)
        prev = t
        t = t + 1.0 / rate
    out = (emit, finish_t, sched + [finish_sched])
    if len(_EMISSION_CACHE) >= _EMISSION_CACHE_MAX:
        _EMISSION_CACHE.pop(next(iter(_EMISSION_CACHE)))
    _EMISSION_CACHE[key] = out
    return out


def _program_beats_tick(event_t: float, sched_t: float,
                        interval_s: float) -> bool:
    """Heap order of a producer program event vs the control tick at the
    same timestamp ``event_t`` (an exact-float collision, e.g. a 2 Hz
    emission grid meeting 2 s ticks).

    Both are plain ``(ts, seq)`` heap entries, so the earlier *scheduling*
    wins: the program event was pushed at ``sched_t``, the tick at
    ``event_t - interval_s``.  When those collide too, the chains are
    recursively tied; at the root (t=0) the producer starts before the
    loop in ``run_adaptation``'s assembly order, so the producer wins."""
    tick_armed = event_t - interval_s
    while True:
        if sched_t < tick_armed:
            return True
        if sched_t > tick_armed:
            return False
        if sched_t <= 0.0:
            return True          # setup order: producer.start before loop.start
        # both pushed during events at the same earlier timestamp — compare
        # one step further back along each chain
        event_t, tick_armed = sched_t, tick_armed - interval_s
        sched_t = event_t - interval_s  # conservative: unknown exact program
        # spacing this far back only matters on pathological rate programs;
        # equal spacing keeps recursing toward the t=0 base case


# ---------------------------------------------------------------------------
# ingest shards: SharedResource's VFT algebra, windowed
# ---------------------------------------------------------------------------

class _Shard:
    """One Kinesis shard as ``SharedResource``'s virtual-finish-time state,
    advanced in windows instead of per-event heap traffic.  The float
    updates are copied from ``des.SharedResource`` verbatim so completion
    timestamps agree bitwise."""

    __slots__ = ("capacity", "vtime", "last_ts", "heap", "flows",
                 "next_fid", "next_t", "pending")

    def __init__(self, capacity: float) -> None:
        self.capacity = capacity
        self.vtime = 0.0
        self.last_ts = 0.0
        self.heap: list[tuple[float, int]] = []
        self.flows: dict[int, tuple[int, int]] = {}   # fid -> (msg, partition)
        self.next_fid = 0
        self.next_t: float | None = None
        self.pending: deque = deque()    # (submit_ts, msg_idx, partition)

    def submit(self, t: float, work: float, item: tuple[int, int]) -> None:
        n = len(self.flows)
        if n:
            dt = t - self.last_ts
            if dt > 0:
                self.vtime += dt * (self.capacity / n)
        self.last_ts = t
        fid = self.next_fid
        self.next_fid = fid + 1
        self.flows[fid] = item
        heapq.heappush(self.heap, (self.vtime + work, fid))
        delay = max(self.heap[0][0] - self.vtime, 0.0) \
            * (n + 1) / self.capacity
        self.next_t = t + delay

    def complete(self, t: float) -> tuple[int, int]:
        n = len(self.flows)
        dt = t - self.last_ts
        if dt > 0:
            self.vtime += dt * (self.capacity / n)
        self.last_ts = t
        _vtag, fid = heapq.heappop(self.heap)
        item = self.flows.pop(fid)
        if n > 1:
            delay = max(self.heap[0][0] - self.vtime, 0.0) \
                * (n - 1) / self.capacity
            self.next_t = t + delay
        else:
            self.next_t = None
        return item


# ---------------------------------------------------------------------------
# facades: the data plane as plain state, the control plane real
# ---------------------------------------------------------------------------

class _Container:
    __slots__ = ("warm", "busy", "dead", "rec", "uid")

    def __init__(self, uid: int = 0) -> None:
        self.warm = False
        self.busy = False
        self.dead = False
        self.rec: _Invocation | None = None
        self.uid = uid


class _Invocation:
    """One dispatched batch (batch_max == 1: one message).  ``partition``
    is the engine-side partition; ``pin`` the backend placement hint
    (None after a ConnectionError retry unpins); ``profile`` is bound at
    dispatch time, exactly where the scalar ``make_cu_desc`` binds it."""

    __slots__ = ("partition", "msg", "offset", "pin", "deadline", "profile",
                 "start_ts", "settled", "floor")

    def __init__(self, partition: int, msg: int, offset: int,
                 pin: int | None, deadline: float, profile) -> None:
        self.partition = partition
        self.msg = msg
        self.offset = offset
        self.pin = pin
        self.deadline = deadline
        self.profile = profile
        self.start_ts = 0.0
        self.settled = False
        self.floor = 0.0


class _Partition:
    """Broker partition log + consumer state, fused: the fast path has no
    separate broker object, so offsets index straight into ``log``."""

    __slots__ = ("log", "next_offset", "inflight", "retries",
                 "stalled_until")

    def __init__(self) -> None:
        self.log: list[tuple[int, float]] = []    # offset -> (msg, append_ts)
        self.next_offset = 0
        self.inflight = False
        self.retries = 0
        self.stalled_until = 0.0


class _FastBroker:
    """What the ControlLoop (and the fault injector's partition picker)
    sees of the broker: active/total shard counts."""

    __slots__ = ("active", "total")

    def __init__(self, initial: int) -> None:
        self.active = initial
        self.total = initial

    def repartition(self, topic: str, n: int) -> int:
        if n > self.total:
            self.total = n
        self.active = n
        return n

    def num_partitions(self, topic: str) -> int:
        return self.active


class _FastBackend:
    """``ServerlessSimBackend``'s container pool for one pilot, including
    the fault surface (``inject_crash`` / ``preempt`` / restore).  Queue
    and free-pool disciplines are replicated exactly (FIFO queue, MRU free
    deque, busy-first crash victims, reversed-idle-first preempt victims)
    because they fix the *order* in which invocations draw their jitter
    from the shared normal stream."""

    def __init__(self, run, cfg: dict, memory_mb: int,
                 walltime_s: float, n_containers: int) -> None:
        self._run = run
        self.cfg = cfg
        self.memory_mb = memory_mb
        self.walltime_s = walltime_s
        self._next_uid = 0
        self.containers = [self._fresh() for _ in range(max(1, n_containers))]
        self.free = deque(self.containers)
        self.queue: deque = deque()
        self.target = len(self.containers)
        # (profile id, cold) -> (mean, cv): profile objects are cached for
        # the run's lifetime by adaptation_profile_factory, so ids are stable
        self._svc_cache: dict[tuple[int, bool], tuple[float, float]] = {}

    def _fresh(self) -> _Container:
        c = _Container(self._next_uid)
        self._next_uid += 1
        return c

    # -- ControlLoop's Backend surface (pilot arg unused: one pilot) --------
    def allocation(self, pilot=None) -> int:
        return self.target

    def effective_allocation(self, pilot=None) -> int:
        return len(self.containers)

    def scale_to(self, pilot, n: int) -> int:
        n = max(1, min(int(n), int(self.cfg["max_containers"])))
        self.target = n
        containers, free = self.containers, self.free
        while len(containers) > n and free:
            containers.remove(free.pop())
        while len(containers) < n:
            c = self._fresh()
            containers.append(c)
            free.append(c)
        self.dispatch()
        return n

    # -- fault surface -------------------------------------------------------
    def _kill(self, c: _Container) -> None:
        """Container dies under its invocation: the synchronous failure
        runs the engine's retry path inline, exactly like the scalar
        ``cu._set_failed`` → done-callback chain."""
        c.dead = True
        self.containers.remove(c)
        if c in self.free:
            self.free.remove(c)
        rec = c.rec
        c.rec = None
        if rec is not None and not rec.settled:
            self._run.engine.on_final_failed(rec, connection_error=True)

    def inject_crash(self, count: int = 1) -> int:
        victims = [c for c in self.containers if c.busy][:count]
        if len(victims) < count:
            victims += [c for c in self.containers
                        if not c.busy][:count - len(victims)]
        for c in victims:
            self._kill(c)
            fresh = self._fresh()       # instant container restart
            self.containers.append(fresh)
            self.free.append(fresh)
        if victims:
            self.dispatch()
        return len(victims)

    def preempt(self, count: int = 1) -> int:
        idle = [c for c in reversed(self.containers) if not c.busy]
        busy = [c for c in reversed(self.containers) if c.busy]
        victims = (idle + busy)[:count]
        for c in victims:
            self._kill(c)
        n = len(victims)
        if n:
            self._run.sim.schedule_fast(
                float(self.cfg["preempt_restore_s"]),
                lambda: self._restore_preempted(n))
        return n

    def _restore_preempted(self, n: int) -> None:
        restored = 0
        while restored < n and len(self.containers) < self.target:
            c = self._fresh()
            self.containers.append(c)
            self.free.append(c)
            restored += 1
        if restored:
            self.dispatch()

    # -- execution ----------------------------------------------------------
    def submit(self, rec: _Invocation) -> None:
        self.queue.append(rec)
        self.dispatch()

    def dispatch(self) -> None:
        queue, free = self.queue, self.free
        while queue:
            if not free:
                return
            rec = queue.popleft()
            if rec.settled:
                continue
            self._start(rec, free.popleft())

    def _start(self, rec: _Invocation, c: _Container) -> None:
        run = self._run
        sim = run.sim
        profile = rec.profile
        cold = not c.warm
        c.warm = True
        c.busy = True
        c.rec = rec
        key = (id(profile), cold)
        svc = self._svc_cache.get(key)
        if svc is None:
            svc = self._svc_cache[key] = service_time_mean(
                self.cfg, self.memory_mb, profile, cold)
        t_mean, cv = svc
        dt = sim.lognormal_jitter(t_mean, cv)
        if dt > self.walltime_s:
            raise _FallbackNeeded(
                f"invocation needs {dt:.1f}s > walltime {self.walltime_s}s "
                "(walltime-kill/retry path)")
        rec.start_ts = sim.now
        if run.trace is not None:
            run.trace.append((rec.floor, rec.partition, c.uid, t_mean,
                              sim.now + dt))
        sim.schedule_fast(dt, lambda: self._finish(rec, c))

    def _finish(self, rec: _Invocation, c: _Container) -> None:
        if c.dead:
            return                     # killed mid-flight: already failed
        c.busy = False
        c.rec = None
        if len(self.containers) > self.target:
            self.containers.remove(c)      # scale-down landed mid-flight
        else:
            self.free.appendleft(c)
        self._run.engine.on_final_done(rec)
        self.dispatch()


class _FastEngine:
    """``SimStreamingEngine``'s partition consumer + the loop's
    EngineControlSurface, over partition logs filled by either the
    windowed serverless producer or the event-true HPC producer chain.

    Owns the full at-least-once ledger the scalar ``_EngineCore`` keeps:
    committed offsets, idempotent ``seen`` dedupe, retry/backoff with the
    same ``sim.rng`` draws, abandonment, and the completion record stream
    the latency column is computed from."""

    def __init__(self, run, initial: int) -> None:
        self._run = run
        self.parts = [_Partition() for _ in range(initial)]
        self.inflight_n = 0
        self.appended_seen = 0
        self.paused_until = 0.0
        self.completed_runtimes: list[float] = []
        self._straggler_cache = (0, _INF)
        # ledger
        self.processed = 0
        self.abandoned = 0
        self.dup_delivered = 0
        self.duplicates = 0          # batch-level already-committed copies
        self.retried = 0
        self.failed_batches = 0
        self.appended_total = 0
        self.seen: set[int] = set()
        self.append_ts: dict[int, float] = {}     # msg -> producer append ts
        self.completions: list[tuple[int, float]] = []   # (msg, ts) in order

    # -- EngineControlSurface ------------------------------------------------
    def now(self) -> float:
        return self._run.sim.now

    def call_later(self, delay_s: float, fn) -> None:
        # the only call_later client is the ControlLoop's tick chain; wrap
        # it so each tick is followed by the producer/ingest window advance
        # (emissions in [T, T+interval) see the post-tick partition count,
        # exactly as their heap events would).  The HPC run's after_tick is
        # a no-op: its producer is an event chain, not a window.
        run = self._run

        def tick() -> None:
            pre_active = run.broker.active
            fn()
            run.after_tick(pre_active)

        run.sim.schedule_fast(delay_s, tick)

    def run_on_clock(self, fn) -> None:
        fn()      # the DES runs its callbacks on the caller's thread

    def repartition(self, migration_s: float = 0.0) -> None:
        total = self._run.broker.total
        parts = self.parts
        while len(parts) < total:
            parts.append(_Partition())
        if migration_s > 0.0:
            sim = self._run.sim
            resume_at = sim.now + migration_s
            if resume_at > self.paused_until:
                self.paused_until = resume_at
                sim.schedule_fast(migration_s, self._resume)

    def _resume(self) -> None:
        if self._run.sim.now < self.paused_until:
            return     # superseded by a longer, later migration pause
        for p in range(len(self.parts)):
            self.drain(p)

    def stall_partition(self, partition: int, duration_s: float) -> None:
        if partition >= len(self.parts):
            self.repartition()
        ps = self.parts[partition]
        until = self._run.sim.now + duration_s
        if until > ps.stalled_until:
            ps.stalled_until = until
            self._run.sim.schedule_fast(duration_s,
                                        lambda: self.drain(partition))

    # -- consumer ------------------------------------------------------------
    def straggler_timeout(self) -> float:
        runtimes = self.completed_runtimes
        n = len(runtimes)
        if n < 3:
            return _INF
        cached_n, cached = self._straggler_cache
        if n != cached_n and (n < 32 or n % 32 == 0 or cached_n < 3):
            cached = max(4.0 * statistics.median(runtimes), 1e-3)
            self._straggler_cache = (n, cached)
        return cached

    def on_append(self, msg: int, partition: int, ts: float) -> None:
        self.appended_total += 1
        if msg not in self.append_ts:
            self.append_ts[msg] = ts      # producer append; dup re-appends
        self.appended_seen += 1           # never write "append" rows
        if partition >= len(self.parts):
            self.repartition()
        self.parts[partition].log.append((msg, ts))
        self.drain(partition)

    def drain(self, partition: int) -> None:
        run = self._run
        now = run.sim.now
        if now < self.paused_until:
            return     # migrating: the resume sweep re-drains everything
        if partition >= len(self.parts):
            self.repartition()
        ps = self.parts[partition]
        if now < ps.stalled_until:
            return     # stalled shard: the expiry event re-drains
        if ps.inflight:
            return
        if ps.next_offset >= len(ps.log):
            return     # empty fetch
        msg, append_ts = ps.log[ps.next_offset]
        ps.inflight = True
        self.inflight_n += 1
        ps.retries = 0
        floor = max(append_ts, self.paused_until, ps.stalled_until)
        self.dispatch(partition, msg, ps.next_offset, pinned=True,
                      floor=floor)

    def dispatch(self, partition: int, msg: int, offset: int,
                 pinned: bool, floor: float = 0.0) -> None:
        run = self._run
        sim = run.sim
        timeout = self.straggler_timeout()
        deadline = sim.now + timeout if timeout != _INF else _INF
        rec = _Invocation(partition, msg, offset,
                          partition if pinned else None, deadline,
                          run.profile_for(None))
        rec.floor = floor
        run.backend.submit(rec)
        # the straggler watchdog is armed AFTER submit, exactly where the
        # scalar _dispatch arms it — at an exact-timestamp tie with the
        # invocation's finish, heap seq order decides speculation just as
        # it does on the scalar path (cancellation is a settled-check: the
        # scalar cancel only tombstones the event)
        if timeout != _INF:
            sim.schedule_fast(timeout, lambda: self._straggler_check(rec))

    def _straggler_check(self, rec: _Invocation) -> None:
        if rec.settled:
            return            # scalar: event cancelled at cu finality
        ps = self.parts[rec.partition]
        if rec.offset + 1 <= ps.next_offset:
            return            # a duplicate copy already committed the batch
        # at most ONE unpinned backup copy per attempt (speculate=False):
        # the copy arms no watchdog of its own
        run = self._run
        dup = _Invocation(rec.partition, rec.msg, rec.offset, None, _INF,
                          run.profile_for(None))
        dup.floor = rec.floor
        run.backend.submit(dup)

    def retry_delay(self, attempt: int) -> float:
        run = self._run
        base = run.exp.retry_backoff_s
        if base <= 0.0:
            return 0.0
        delay = base * (2.0 ** (attempt - 1))
        delay *= 0.5 + run.sim.rng.random()
        return min(delay, _RETRY_CAP_S)

    def on_final_done(self, rec: _Invocation) -> None:
        run = self._run
        now = run.sim.now
        rec.settled = True
        ps = self.parts[rec.partition]
        if rec.offset + 1 <= ps.next_offset:
            self.duplicates += 1          # a duplicate copy already committed
            return
        ps.next_offset = rec.offset + 1
        if rec.msg in self.seen:
            self.dup_delivered += 1       # redelivery absorbed idempotently
        else:
            self.seen.add(rec.msg)
            self.processed += 1
            self.completions.append((rec.msg, now))
        self.completed_runtimes.append(now - rec.start_ts)
        ps.inflight = False
        self.inflight_n -= 1
        self.drain(rec.partition)

    def on_final_failed(self, rec: _Invocation,
                        connection_error: bool) -> None:
        run = self._run
        now = run.sim.now
        rec.settled = True
        ps = self.parts[rec.partition]
        if rec.offset + 1 <= ps.next_offset:
            return                        # a duplicate copy already committed
        if ps.retries < run.exp.max_retries:
            ps.retries += 1
            self.retried += 1
            # ConnectionError (container/worker death) unpins: any
            # replacement may serve the batch
            pinned = not connection_error
            delay = self.retry_delay(ps.retries)
            if delay > 0.0:
                run.sim.schedule_fast(
                    delay, lambda: self.dispatch(rec.partition, rec.msg,
                                                 rec.offset, pinned))
            else:
                self.dispatch(rec.partition, rec.msg, rec.offset, pinned)
        else:
            self.failed_batches += 1
            self.abandoned += 1           # batch_max == 1: one message
            ps.next_offset = rec.offset + 1
            ps.inflight = False
            self.inflight_n -= 1
            self.drain(rec.partition)

    def is_finished(self) -> bool:
        run = self._run
        if not run.producer_done:
            return False
        if self.inflight_n or (self.processed + self.abandoned
                               + self.dup_delivered) < self.appended_seen:
            return False
        return all(ps.next_offset >= len(ps.log) and not ps.inflight
                   for ps in self.parts)


class _FastInjector:
    """``FaultInjector`` against the fast facades: the same counters, the
    same round-robin partition picker, the same fire-time action order.
    Events are armed directly on the simulator at setup (before the first
    producer/append events are scheduled), so equal-timestamp collisions
    resolve exactly as the scalar assembly order resolves them
    (injector.start() precedes loop.start(); appends are runtime
    events)."""

    def __init__(self, run, events: list) -> None:
        self._run = run
        self.events = events
        self.injected = 0
        self.crashes = 0
        self.preemptions = 0
        self.stalls = 0
        self.dup_injected = 0
        self.skipped = 0
        self._rr = 0
        self._fired_since_probe = 0
        self._stall_until = 0.0

    def start(self) -> int:
        sim = self._run.sim
        for ev in self.events:
            sim.schedule_fast(ev.t, lambda ev=ev: self._fire(ev))
        return len(self.events)

    def window_dirty(self) -> bool:
        dirty = self._fired_since_probe > 0 \
            or self._run.sim.now < self._stall_until
        self._fired_since_probe = 0
        return dirty

    def _pick_partition(self, ev) -> int:
        n = max(1, self._run.broker.num_partitions("points"))
        if ev.target is not None:
            return ev.target % n
        self._rr += 1
        return (self._rr - 1) % n

    def _fire(self, ev) -> None:
        run = self._run
        self.injected += 1
        self._fired_since_probe += 1
        acted = 0
        if ev.kind == "crash":
            acted = run.backend.inject_crash(ev.count)
            self.crashes += acted
        elif ev.kind == "preempt":
            acted = run.backend.preempt(ev.count)
            self.preemptions += acted
        elif ev.kind == "stall":
            p = self._pick_partition(ev)
            run.engine.stall_partition(p, ev.duration_s)
            until = run.sim.now + ev.duration_s
            self._stall_until = max(self._stall_until, until)
            self.stalls += 1
            acted = 1
        elif ev.kind == "duplicate":
            acted = self._inject_duplicate(ev)
        # backend_outage / grant_starvation: the sim backends expose no
        # hook, exactly like the scalar getattr(...) miss — skipped
        if not acted:
            self.skipped += 1

    def _inject_duplicate(self, ev) -> int:
        run = self._run
        p = self._pick_partition(ev)
        if p >= len(run.engine.parts):
            run.engine.repartition()
        plog = run.engine.parts[p].log
        if not plog:
            return 0
        msg, _ts = plog[-1]     # newest offset, original stable msg_id
        run.engine.on_append(msg, p, run.sim.now)
        self.dup_injected += 1
        return 1


class _FastMetrics:
    """The MetricRegistry surface the ControlLoop consumes, O(1) per call:
    ``produce`` counts walk the shared emission schedule (windowed
    serverless run) or read the producer chain's counter (HPC run),
    ``complete`` counts read the processed counter, trace emission is
    dropped (the summary carries no event columns)."""

    def __init__(self, run) -> None:
        self._run = run
        self._produce_i = 0

    def kind_count(self, run_id: str, kind: str) -> int:
        run = self._run
        if kind == "produce":
            if not run.windowed:
                return run.produce_count
            emit = run.emit_times
            first = run.boundary_first
            now = run.sim.now
            i = self._produce_i
            n = len(emit)
            # an emission exactly at a tick timestamp counts iff its heap
            # event popped before the tick's (precomputed boundary order)
            while i < n and (emit[i] < now or (emit[i] == now and first[i])):
                i += 1
            self._produce_i = i
            return i
        if kind == "complete":
            return run.engine.processed
        return 0

    def observe(self, name: str, ts: float, value: float) -> None:
        pass

    def record(self, *args, **kwargs) -> None:
        pass


class _FastPilot:
    __slots__ = ("backend",)

    def __init__(self, backend) -> None:
        self.backend = backend


def _initial_partitions(exp: AdaptationExperiment) -> int:
    static_n = (exp.static_partitions if exp.static_partitions is not None
                else exp.max_partitions)
    initial = static_n if exp.scaling_policy == "static" \
        else exp.initial_partitions
    return max(1, min(initial, exp.max_partitions))


def _build_summary(run, drained: bool) -> AdaptationSummary:
    """The report card, from the engine's ledger — field-for-field what
    ``summarize_adaptation`` computes from the scalar run.  ``lost`` is
    the settled-ledger residue (appends not settled as processing,
    abandonment or duplicate absorption): an undrained run counts its
    in-flight backlog as lost, exactly as the scalar path does."""
    loop = run.loop
    eng = run.engine
    sim = run.sim
    inj = run.injector
    # the scalar latency column: complete records in completion order,
    # paired against the producer's append record for that msg_id
    append_ts = eng.append_ts
    lat = [ts - append_ts[m] for m, ts in eng.completions]
    settled = eng.processed + eng.abandoned + eng.dup_delivered
    wall = max(sim.now, 1e-9)
    return AdaptationSummary(
        experiment=run.plan,
        slo_violations=loop.slo_violations,
        ticks=loop.ticks,
        cost_integral=loop.cost_integral,
        scale_events=loop.scale_events,
        produced=run.produced_count(),
        processed=eng.processed,
        throughput=eng.processed / wall,
        latency_px=percentile_summary(np.asarray(lat, dtype=np.float64)),
        final_allocation=loop.allocation,
        drained=drained,
        drain_s=max(0.0, sim.now - run.exp.horizon_s),
        refits=loop.refit_events,
        abandoned=eng.abandoned,
        dup_delivered=eng.dup_delivered,
        faults_injected=inj.injected if inj is not None else 0,
        preemptions=inj.preemptions if inj is not None else 0,
        fault_windows=loop.fault_windows,
        lost=eng.appended_total - settled,
        member_ledger=[],
        fast_path=True, fallback_reason=None)


# ---------------------------------------------------------------------------
# the serverless replay
# ---------------------------------------------------------------------------

class _FastRun:
    """One eligible serverless cell, replayed: real Simulator +
    ControlLoop/policy, columnar producer/ingest, event-true
    backend/engine facades, fault events spliced from the pre-expanded
    plan."""

    windowed = True

    def __init__(self, plan: AdaptationPlan, trace: list | None = None) -> None:
        exp = plan.experiment
        self.plan = plan
        self.exp = exp
        self.sim = Simulator(seed=exp.seed)
        self.trace = trace

        initial = _initial_partitions(exp)

        cfg = dict(DEFAULTS)
        cfg.update(exp.backend_attrs)
        n_containers = min(initial, int(cfg["max_containers"]))

        program = rate_program_from_spec(exp.rate)
        cap = int(program.mean_messages(0.0, exp.horizon_s) * 2 + 1000)
        self.emit_times, self.finish_t, sched_times = _emission_schedule(
            exp.rate, exp.horizon_s, cap)
        self.sent_total = len(self.emit_times)
        self.wl_work = float(exp.points * POINT_BYTES)

        # exact-float collisions between producer program events and control
        # ticks (a 2 Hz grid meeting 2 s ticks does this every boundary):
        # resolve each once, up front
        interval = exp.control_interval_s
        tick_set = _tick_times(interval, max(self.finish_t,
                                             self.emit_times[-1]
                                             if self.emit_times else 0.0))
        self.boundary_first = [
            t in tick_set
            and _program_beats_tick(t, sched_times[i], interval)
            for i, t in enumerate(self.emit_times)]
        self.finish_at_tick_after = (
            self.finish_t in tick_set
            and not _program_beats_tick(self.finish_t, sched_times[-1],
                                        interval))

        self.broker = _FastBroker(initial)
        self.backend = _FastBackend(self, cfg, exp.memory_mb,
                                    _WALLTIME_S, n_containers)
        self.engine = _FastEngine(self, initial)
        self.metrics = _FastMetrics(self)
        self.profile_for = adaptation_profile_factory(
            exp, lambda: self.sim.now, lambda: self.loop.allocation)
        self.shards = [_Shard(_INGEST_BW) for _ in range(exp.max_partitions)]

        self.producer_appended = 0
        self.production_over = False
        self.producer_done = False
        self._next_emit = 0

        if exp.faults:
            _plan, events = expand_plan(exp.faults, default_seed=exp.seed,
                                        default_horizon_s=exp.horizon_s)
            self.injector = _FastInjector(self, events)
        else:
            self.injector = None

        self.loop = ControlLoop(
            self.engine, self.broker, "points", _FastPilot(self.backend),
            policy_from_spec(scaling_policy_spec(exp), initial=initial),
            metrics=self.metrics, run_id="fast",
            interval_s=exp.control_interval_s, slo_lag=exp.slo_lag,
            migration_s_per_delta=exp.migration_s_per_delta,
            fault_signal=(self.injector.window_dirty
                          if self.injector is not None else None))

    def produced_count(self) -> int:
        return self.sent_total

    # -- producer/ingest window machinery -----------------------------------
    def _assign_window(self, window_end: float, pre_active: int) -> None:
        """Assign emissions in [sim.now, window_end) to partitions and step
        each shard's VFT state up to the window's append horizon."""
        emit = self.emit_times
        first = self.boundary_first
        shards = self.shards
        n_shards = len(shards)
        active = self.broker.active
        now = self.sim.now
        i = self._next_emit
        n = len(emit)
        while i < n and emit[i] < window_end:
            t = emit[i]
            # an emission that popped before this tick saw the pre-tick
            # partition count
            p = i % (pre_active if (t == now and first[i]) else active)
            shards[p % n_shards].pending.append(
                (t + _REQUEST_LATENCY, i, p))
            i += 1
        self._next_emit = i
        bound = window_end + _REQUEST_LATENCY
        for sh in shards:
            self._drain_shard(sh, bound)

    def _drain_shard(self, sh: _Shard, bound: float) -> None:
        """Run one shard's submit/complete events with timestamps < bound
        (no later submit can predate ``bound``, so every completion this
        finalizes is final)."""
        pending = sh.pending
        while True:
            t_sub = pending[0][0] if pending else _INF
            t_comp = sh.next_t if sh.next_t is not None else _INF
            if t_comp <= t_sub:
                if t_comp >= bound:
                    return
                msg, part = sh.complete(t_comp)
                self._schedule_append(t_comp, msg, part)
            else:
                if t_sub >= bound:
                    return
                _ts, msg, part = pending.popleft()
                sh.submit(t_sub, self.wl_work, (msg, part))

    def _schedule_append(self, t: float, msg: int, partition: int) -> None:
        def append() -> None:
            self.engine.on_append(msg, partition, t)
            self.producer_appended += 1
            if self.production_over \
                    and self.producer_appended >= self.sent_total:
                self.producer_done = True

        self.sim.schedule_at(t, append)

    def _finish_production(self) -> None:
        self.production_over = True
        if self.producer_appended >= self.sent_total:
            self.producer_done = True

    def after_tick(self, pre_active: int) -> None:
        now = self.sim.now
        if self.finish_at_tick_after and not self.production_over \
                and self.finish_t == now:
            self._finish_production()
        self._assign_window(now + self.exp.control_interval_s, pre_active)

    # -- run -----------------------------------------------------------------
    def run(self) -> AdaptationSummary:
        exp = self.exp
        sim = self.sim
        # fault events are armed first: their setup-order heap seqs beat
        # every same-timestamp runtime event, exactly as the scalar
        # injector.start() (before loop.start(), appends runtime) does
        if self.injector is not None:
            self.injector.start()
        # production-over event (unless it resolves after a colliding tick,
        # which after_tick handles at that exact timestamp)
        if not self.finish_at_tick_after:
            self.sim.schedule_at(self.finish_t, self._finish_production)
        # the pre-first-tick window: assigned at setup, like the producer's
        # t=0 start event
        self._assign_window(exp.control_interval_s, self.broker.active)
        self.loop.start()
        max_virtual = exp.horizon_s * 6.0 + 600.0
        sim.run_until(t=sim.now + max_virtual,
                      predicate=self.engine.is_finished)
        drained = self.engine.is_finished()
        self.loop.stop()
        return _build_summary(self, drained)


# ---------------------------------------------------------------------------
# the HPC replay: event-true coupled chain
# ---------------------------------------------------------------------------

class _HpcWorker:
    __slots__ = ("wid", "busy", "alive", "pending", "retired", "queue",
                 "current")

    def __init__(self, wid: int, pending: bool = False) -> None:
        self.wid = wid
        self.busy = False
        self.alive = True
        self.pending = pending
        self.retired = False
        self.queue: deque = deque()
        self.current: "_HpcTask | None" = None


class _HpcBackend:
    """``HpcSimBackend`` for one pilot: serial scheduler, worker pool with
    batch-queue grant waits, eviction/regrant fault surface.  The shared
    filesystem and the model lock are *real* DES primitives on the replay
    simulator — the coupling chain (arrival I/O → jittered compute →
    locked critical section → write-back + coherence I/O) serializes
    across partitions exactly as the scalar backend's ``_TaskExec`` does,
    with the phase terms imported from ``hpcsim.coupling_terms``."""

    def __init__(self, run, cfg: dict, n_workers: int, seed: int) -> None:
        self._run = run
        self.cfg = cfg
        self.workers = [_HpcWorker(i) for i in range(max(1, n_workers))]
        self.fs = SharedResource(run.sim, cfg["fs_bw"], name="lustre")
        self.model_lock = SimLock(run.sim, name="model")
        self.sched_queue: deque = deque()
        self.sched_busy = False
        self.target = max(1, n_workers)
        self._mapping_cache: list[_HpcWorker] | None = None
        # the scalar backend's per-pilot queue-wait stream: run_adaptation's
        # first (only) pilot has uid 0
        self.queue_rng = np.random.default_rng([seed, 0])

    def _queue_wait(self) -> float:
        return queue_wait_sample(self.cfg, self.queue_rng)

    def _mapping(self) -> list[_HpcWorker]:
        m = self._mapping_cache
        if m is None:
            m = self._mapping_cache = [w for w in self.workers
                                       if not w.retired]
        return m

    # -- ControlLoop's Backend surface --------------------------------------
    def allocation(self, pilot=None) -> int:
        return self.target

    def effective_allocation(self, pilot=None) -> int:
        return sum(1 for w in self.workers
                   if not w.retired and not w.pending)

    def scale_to(self, pilot, n: int) -> int:
        n = max(1, int(n))
        self.target = n
        workers = self.workers
        active = [w for w in workers if not w.retired]
        if n > len(active):
            for _ in range(n - len(active)):
                w = _HpcWorker(len(workers), pending=True)
                workers.append(w)

                def grant(w: _HpcWorker = w) -> None:
                    w.pending = False
                    self._pump_worker(w)

                self._run.sim.schedule_fast(self._queue_wait(), grant)
        elif n < len(active):
            victims = active[n:]
            for w in victims:
                w.retired = True
            self._mapping_cache = None
            for w in victims:
                orphans = [r for r in w.queue if not r.settled]
                w.queue.clear()
                for r in orphans:
                    self._assign(r)
        self._mapping_cache = None
        return n

    # -- fault surface -------------------------------------------------------
    def _evict(self, w: _HpcWorker) -> None:
        w.pending = True
        task = w.current
        if task is not None and not task.rec.settled:
            self._run.engine.on_final_failed(task.rec, connection_error=True)
        orphans = [r for r in w.queue if not r.settled]
        w.queue.clear()

        def regrant(w: _HpcWorker = w) -> None:
            w.pending = False
            self._pump_worker(w)

        self._run.sim.schedule_fast(self._queue_wait(), regrant)
        for r in orphans:
            self._assign(r)

    def inject_crash(self, count: int = 1) -> int:
        granted = [w for w in self.workers
                   if w.alive and not w.retired and not w.pending]
        busy = [w for w in granted if w.busy]
        idle = [w for w in granted if not w.busy]
        victims = (busy + idle)[:count]
        for w in victims:
            self._evict(w)
        return len(victims)

    def preempt(self, count: int = 1) -> int:
        granted = [w for w in self.workers
                   if w.alive and not w.retired and not w.pending]
        victims = granted[-count:] if count > 0 else []
        for w in victims:
            self._evict(w)
        return len(victims)

    # -- serial scheduler ----------------------------------------------------
    def submit(self, rec: _Invocation) -> None:
        self.sched_queue.append(rec)
        self._pump_scheduler()

    def _pump_scheduler(self) -> None:
        if self.sched_busy or not self.sched_queue:
            return
        self.sched_busy = True
        rec = self.sched_queue.popleft()

        def dispatched() -> None:
            self.sched_busy = False
            if not rec.settled:
                self._assign(rec)
            self._pump_scheduler()

        self._run.sim.schedule_fast(self.cfg["dispatch_s"], dispatched)

    def _assign(self, rec: _Invocation) -> None:
        mapping = self._mapping()
        if rec.pin is not None:
            w = mapping[rec.pin % len(mapping)]
            if not w.alive:
                self._run.engine.on_final_failed(rec, connection_error=True)
                return
        else:
            alive = [w for w in mapping if w.alive]
            if not alive:
                self._run.engine.on_final_failed(rec, connection_error=True)
                return
            w = min(alive, key=lambda w: (w.pending,
                                          len(w.queue) + (1 if w.busy else 0),
                                          w.wid))
        w.queue.append(rec)
        self._pump_worker(w)

    # -- worker execution ----------------------------------------------------
    def _pump_worker(self, w: _HpcWorker) -> None:
        if w.busy or w.pending or not w.queue or not w.alive:
            return
        rec = w.queue.popleft()
        if rec.settled:
            self._pump_worker(w)
            return
        w.busy = True
        rec.start_ts = self._run.sim.now
        task = _HpcTask(self, w, rec)
        w.current = task
        self.fs.submit(task.arrival_io, task.phase_compute)


class _HpcTask:
    """``hpcsim._TaskExec``'s phase chain against the fast facades, on the
    *real* shared-FS resource and model lock.  An evicted worker's chain
    keeps running to completion (the scalar "phantom" semantics: the
    already-failed CU's phases still consume jitter draws, FS bandwidth
    and lock hold time) — only the final settle is skipped."""

    __slots__ = ("backend", "w", "rec", "arrival_io", "compute_mean",
                 "critical_mean", "write_io")

    def __init__(self, backend: _HpcBackend, w: _HpcWorker,
                 rec: _Invocation) -> None:
        self.backend = backend
        self.w = w
        self.rec = rec
        (self.arrival_io, self.compute_mean, self.critical_mean,
         self.write_io) = coupling_terms(backend.cfg, rec.profile)

    def phase_compute(self) -> None:
        sim = self.backend._run.sim
        sim.schedule_fast(sim.lognormal_jitter(self.compute_mean,
                                               self.backend.cfg["jitter_cv"]),
                          self.phase_model_update)

    def phase_model_update(self) -> None:
        self.backend.model_lock.acquire(self.in_critical_section)

    def in_critical_section(self) -> None:
        sim = self.backend._run.sim
        sim.schedule_fast(sim.lognormal_jitter(self.critical_mean,
                                               self.backend.cfg["jitter_cv"]),
                          self.do_io)

    def do_io(self) -> None:
        self.backend.fs.submit(self.write_io, self.unlock)

    def unlock(self) -> None:
        self.backend.model_lock.release()
        self.finish()

    def finish(self) -> None:
        backend, w, rec = self.backend, self.w, self.rec
        w.busy = False
        w.current = None
        if not rec.settled:
            backend._run.engine.on_final_done(rec)
        backend._pump_worker(w)


class _HpcFastRun:
    """One eligible wrangler/stampede2 cell, replayed event-true: the
    producer is a linked chain of program events feeding the shared
    filesystem (``SharedFsIngest`` couples appends with task I/O, so HPC
    appends cannot be windowed), the backend is the coupled-chain facade
    above, the control plane is real."""

    windowed = False

    def __init__(self, plan: AdaptationPlan) -> None:
        exp = plan.experiment
        self.plan = plan
        self.exp = exp
        self.sim = Simulator(seed=exp.seed)
        self.trace = None

        initial = _initial_partitions(exp)

        cfg = dict(HPC_DEFAULTS)
        cfg.update(MACHINES[exp.machine])
        cfg.update(exp.backend_attrs)

        self.program = rate_program_from_spec(exp.rate)
        self.cap = int(self.program.mean_messages(0.0, exp.horizon_s) * 2
                       + 1000)
        self.wl_bytes = exp.points * POINT_BYTES

        self.broker = _FastBroker(initial)
        self.backend = _HpcBackend(self, cfg, initial, exp.seed)
        self.engine = _FastEngine(self, initial)
        self.metrics = _FastMetrics(self)
        self.profile_for = adaptation_profile_factory(
            exp, lambda: self.sim.now, lambda: self.loop.allocation)

        self.sent = 0
        self.produce_count = 0
        self.producer_appended = 0
        self.production_over = False
        self.producer_done = False

        if exp.faults:
            _plan, events = expand_plan(exp.faults, default_seed=exp.seed,
                                        default_horizon_s=exp.horizon_s)
            self.injector = _FastInjector(self, events)
        else:
            self.injector = None

        self.loop = ControlLoop(
            self.engine, self.broker, "points", _FastPilot(self.backend),
            policy_from_spec(scaling_policy_spec(exp), initial=initial),
            metrics=self.metrics, run_id="fast",
            interval_s=exp.control_interval_s, slo_lag=exp.slo_lag,
            migration_s_per_delta=exp.migration_s_per_delta,
            fault_signal=(self.injector.window_dirty
                          if self.injector is not None else None))

    def produced_count(self) -> int:
        return self.sent

    def after_tick(self, pre_active: int) -> None:
        pass     # the producer is an event chain, nothing to advance

    # -- producer chain: SyntheticProducer._tick_program, event-true ---------
    def _producer_tick(self) -> None:
        now = self.sim.now
        if now >= self.exp.horizon_s or self.sent >= self.cap:
            self._finish_production()
            return
        rate = self.program.rate(now)
        if rate <= 1e-9:
            self.sim.schedule_fast(_IDLE_RESOLUTION_S, self._producer_tick)
            return
        self._emit_one()
        self.sim.schedule_fast(1.0 / rate, self._producer_tick)

    def _emit_one(self) -> None:
        i = self.sent
        self.sent += 1
        partition = i % self.broker.active     # key=None routing, emit-time
        self.produce_count += 1                # the "produce" metric record
        size = float(self.wl_bytes)
        # SharedFsIngest: request latency, then the append bytes ride the
        # same Lustre resource the task I/O uses
        self.sim.schedule_fast(
            _FS_REQUEST_LATENCY,
            lambda: self.backend.fs.submit(size,
                                           lambda: self._append(i, partition)))

    def _append(self, msg: int, partition: int) -> None:
        self.engine.on_append(msg, partition, self.sim.now)
        self.producer_appended += 1
        if self.production_over and self.producer_appended >= self.sent:
            self.producer_done = True

    def _finish_production(self) -> None:
        self.production_over = True
        if self.producer_appended >= self.sent:
            self.producer_done = True

    # -- run -----------------------------------------------------------------
    def run(self) -> AdaptationSummary:
        exp = self.exp
        sim = self.sim
        # scalar assembly order: producer.start() (t=0 program tick), the
        # engine's initial empty drains (no-ops: nothing appended before
        # t > 0 — skipped), injector.start(), loop.start()
        sim.schedule_fast(0.0, self._producer_tick)
        if self.injector is not None:
            self.injector.start()
        self.loop.start()
        max_virtual = exp.horizon_s * 6.0 + 600.0
        sim.run_until(t=sim.now + max_virtual,
                      predicate=self.engine.is_finished)
        drained = self.engine.is_finished()
        self.loop.stop()
        return _build_summary(self, drained)


def _tick_times(interval_s: float, t_max: float) -> frozenset[float]:
    """The exact float timestamps of the tick chain i, 2i, 3i, ... ≤ t_max
    (each produced by repeated ``now + interval`` float sums — NOT k * i,
    which can differ in the last ulp)."""
    if interval_s <= 0.0:
        return frozenset()
    ticks = []
    acc = 0.0
    while True:
        acc += interval_s
        if acc > t_max:
            return frozenset(ticks)
        ticks.append(acc)


def _ineligible(exp: AdaptationExperiment) -> str | None:
    if exp.engine != "sim":
        return f"engine={exp.engine!r} (wall clock is not replayable)"
    if exp.machine == "federated":
        return "federated machine (member routing/breaker state machine)"
    if exp.machine != "serverless" and exp.machine not in MACHINES:
        return f"machine={exp.machine!r} (no fast facade)"
    if exp.batch_max != 1:
        return f"batch_max={exp.batch_max} (replay models 1 msg/invocation)"
    if exp.machine == "serverless":
        cfg = dict(DEFAULTS)
        cfg.update(exp.backend_attrs)
        profile = KMeansStreamWorkload(
            points=exp.points, centroids=exp.centroids,
            policy=exp.effective_policy, n_partitions=1).profile()
        if profile.memory_mb > min(exp.memory_mb, cfg["memory_cap_mb"]):
            return ("working set exceeds container memory "
                    "(failure/retry path)")
    return None


def try_fast_adaptation(
        plan: AdaptationPlan) -> tuple[AdaptationSummary | None, str | None]:
    """Replay ``plan`` on the batched fast path if it qualifies.

    Returns ``(summary, None)`` on success or ``(None, reason)`` when the
    cell is ineligible or leaves the fast regime mid-run; the reason is
    logged and the caller reruns the cell on the scalar DES.  Static
    declines log at DEBUG (expected, one per ineligible cell of a grid);
    mid-run ``_FallbackNeeded`` bails log at INFO (the replay started and
    discovered the cell left the fast regime — worth seeing)."""
    exp = plan.experiment
    reason = _ineligible(exp)
    if reason is None:
        try:
            if exp.machine == "serverless":
                return _FastRun(plan).run(), None
            return _HpcFastRun(plan).run(), None
        except _FallbackNeeded as fb:
            reason = str(fb)
            log.info("fast replay fallback (%s/%s seed %d): %s",
                     exp.machine, exp.scaling_policy, exp.seed, reason)
            return None, reason
    log.debug("fast replay ineligible (%s/%s seed %d): %s",
              exp.machine, exp.scaling_policy, exp.seed, reason)
    return None, reason


# ---------------------------------------------------------------------------
# lockstep: S seeds of a static single-partition cell in one scan
# ---------------------------------------------------------------------------

# float32 agreement bound for the lockstep scans vs the float64 scalar DES.
# The scan is a few thousand multiply/exp/max ops; observed worst-case
# relative error is ~1e-6, the gate leaves an order of magnitude of head
# room.  The lockstep paths are informational (perf rows, tolerance
# tests) — tournament results always come from the bit-exact replay above.
LOCKSTEP_RTOL = 1e-4


def lockstep_eligibility(exp: AdaptationExperiment) -> str | None:
    """The lockstep scan collapses the whole cell to one recurrence
    ``finish[i] = max(append[i], finish[i-1]) + dt[i]`` — valid only when
    nothing can reorder or replicate invocations."""
    base = _ineligible(exp)
    if base is not None:
        return base
    if exp.machine != "serverless":
        return f"machine={exp.machine!r} (lockstep models the container pool)"
    if exp.faults:
        return "fault plan present (per-seed schedules diverge structurally)"
    if exp.scaling_policy != "static":
        return (f"scaling_policy={exp.scaling_policy!r} (lockstep needs a "
                "static allocation: no scale/migration events)")
    static_n = (exp.static_partitions if exp.static_partitions is not None
                else exp.max_partitions)
    if static_n != 1:
        return (f"static_partitions={static_n} (lockstep models one "
                "partition, one container)")
    if exp.drift_t_s is not None:
        return "cost drift present (service time becomes time-dependent)"
    return None


def lockstep_completion_times(exp: AdaptationExperiment, seeds: list[int],
                              with_appends: bool = False, *,
                              device="cuda") -> np.ndarray:
    """Per-message completion timestamps for S seeds of one qualifying
    cell, advanced in lockstep: one ``lockstep_ops.lockstep_scan`` over the
    seed axis on ``device`` (the kernel on the card, its plain version on
    the CPU), in float32.

    The jitter draws come from ``Simulator.normals`` — the same 256-block
    stream the scalar DES consumes — so seed s's column sees exactly the
    draws scalar seed s would; only the float width differs.

    ``with_appends=True`` additionally returns the (seed-independent)
    broker-append timestamps — ``finishes - appends`` is the pipeline
    latency the scalar DES reports in ``latency_px``, the quantity the
    ``LOCKSTEP_RTOL`` agreement contract is stated against.
    """
    x = lockstep_inputs(exp, seeds)
    dev = resolve_device(device)

    def f32(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(dev)

    finishes = lockstep_ops.lockstep_scan(f32(x["appends"]), f32(x["means"]), f32(x["z"]),
                                          x["a"], x["b"]).cpu().numpy()
    return (finishes, x["appends"]) if with_appends else finishes


def lockstep_inputs(exp: AdaptationExperiment, seeds: list[int]) -> dict:
    """The operands of ``lockstep_completion_times``'s scan: ``appends`` (n,)
    broker-append times and ``means`` (n,) service-time means, float64 and
    the same for every seed; ``z`` (S, n) float64, seed s's normal draws;
    ``a`` and ``b``, the lognormal jitter's parameters.  Raises ValueError
    if the cell does not qualify."""
    reason = lockstep_eligibility(exp)
    if reason is not None:
        raise ValueError(f"cell does not qualify for lockstep: {reason}")

    program = rate_program_from_spec(exp.rate)
    cap = int(program.mean_messages(0.0, exp.horizon_s) * 2 + 1000)
    emit_times, _finish_t, _sched = _emission_schedule(
        exp.rate, exp.horizon_s, cap)
    n_msgs = len(emit_times)

    # append times: one shard, no RNG — identical across seeds
    shard = _Shard(_INGEST_BW)
    work = float(exp.points * POINT_BYTES)
    appends = np.empty(n_msgs, dtype=np.float64)
    for i, t in enumerate(emit_times):
        shard.pending.append((t + _REQUEST_LATENCY, i, 0))
    # one unbounded drain: every submit is already queued in time order
    out: list[tuple[float, int]] = []
    pending = shard.pending
    while pending or shard.next_t is not None:
        t_sub = pending[0][0] if pending else _INF
        t_comp = shard.next_t if shard.next_t is not None else _INF
        if t_comp <= t_sub:
            msg, _p = shard.complete(t_comp)
            out.append((t_comp, msg))
        else:
            _ts, msg, _p = pending.popleft()
            shard.submit(t_sub, work, (msg, 0))
    for t, msg in out:
        appends[msg] = t

    # per-message service-time means: first invocation cold, rest warm
    profile = KMeansStreamWorkload(
        points=exp.points, centroids=exp.centroids,
        policy=exp.effective_policy, n_partitions=1).profile()
    cfg = dict(DEFAULTS)
    cfg.update(exp.backend_attrs)
    mean_cold, cv = service_time_mean(cfg, exp.memory_mb, profile, True)
    mean_warm, _cv = service_time_mean(cfg, exp.memory_mb, profile, False)
    means = np.full(n_msgs, mean_warm)
    if n_msgs:
        means[0] = mean_cold

    # the scalar stream's draws, per seed (bit-identical block consumption)
    z = np.stack([Simulator(seed=s).normals(n_msgs) for s in seeds])
    sigma2 = math.log1p(cv * cv)
    return dict(appends=appends, means=means, z=z, a=-0.5 * sigma2, b=math.sqrt(sigma2))


# ---------------------------------------------------------------------------
# cross-cell grid lockstep: S seeds of a controller-driven cell in one scan
# ---------------------------------------------------------------------------

def grid_lockstep_eligibility(exp: AdaptationExperiment) -> str | None:
    """The grid scan freezes the reference seed's dispatch trajectory and
    replays every seed's jitter through it — sound only when the
    trajectory's *structure* (assignment, retries) is not itself
    draw-dependent."""
    base = _ineligible(exp)
    if base is not None:
        return base
    if exp.machine != "serverless":
        return (f"machine={exp.machine!r} (grid lockstep models the "
                "serverless container pool)")
    if exp.faults:
        return "fault plan present (per-seed schedules diverge structurally)"
    return None


def grid_lockstep_completion_times(
        exp: AdaptationExperiment, seeds: list[int],
        with_reference: bool = False, *, device="cuda") -> np.ndarray:
    """Per-invocation completion timestamps for S seeds of one
    controller-driven cell in a single scan on ``device`` — the cross-cell
    lift of ``lockstep_completion_times``.

    One *reference* replay (``seeds[0]``, the bit-exact ``_FastRun``)
    records the dispatch trajectory in start order: for each invocation
    its exogenous ready floor (append time, migration pauses, stalls),
    its partition, its container, and its service-time mean.  The frozen
    trajectory turns every seed's completion chain into the double
    recurrence

        ``finish[k] = max(floor[k], part_last[p_k], cont_last[c_k]) + dt[k]``

    which one ``lockstep_ops.grid_lockstep_scan`` over the S-seed jitter
    matrix evaluates in a single launch — an 8-seed tournament grid replays
    as one call rather than 8 sequential replays.  Seed s's draws come from
    ``Simulator(seed=s).normals`` in the reference's start order, so the
    reference column agrees with its own replay to ``LOCKSTEP_RTOL``;
    the other columns are frozen-trajectory approximations (the scalar
    path would reorder starts per seed).  Informational only — tournament
    summaries always come from the bit-exact replay.

    ``with_reference=True`` additionally returns the reference replay's
    exact (float64) completion timestamps in the same start order.
    """
    x = grid_lockstep_inputs(exp, seeds)
    dev = resolve_device(device)
    if x["dt"].shape[1] == 0:
        finishes = x["dt"]
    else:
        finishes = lockstep_ops.grid_lockstep_scan(
            *(torch.from_numpy(x[k]).to(dev) for k in ("floors", "parts", "conts", "dt")),
            x["n_parts"], x["n_conts"]).cpu().numpy()
    return (finishes, x["reference"]) if with_reference else finishes


def grid_lockstep_inputs(exp: AdaptationExperiment, seeds: list[int]) -> dict:
    """The operands of ``grid_lockstep_completion_times``'s scan, from one
    reference replay of ``seeds[0]``: the frozen trajectory ``floors`` (n,)
    float32, ``parts`` and ``conts`` (n,) int32 with their counts
    ``n_parts`` and ``n_conts``, each seed's jitter ``dt`` (S, n) float32,
    and the replay's exact finishes ``reference`` (n,) float64.  Raises
    ValueError if the cell does not qualify or ``seeds`` is empty."""
    reason = grid_lockstep_eligibility(exp)
    if reason is not None:
        raise ValueError(f"cell does not qualify for grid lockstep: {reason}")
    if not seeds:
        raise ValueError("grid lockstep needs at least one seed")

    trace: list[tuple[float, int, int, float, float]] = []
    ref = replace(exp, seed=int(seeds[0]))
    _FastRun(AdaptationPlan(experiment=ref), trace=trace).run()
    n = len(trace)
    if n == 0:
        return dict(floors=np.zeros(0, np.float32), parts=np.zeros(0, np.int32),
                    conts=np.zeros(0, np.int32), dt=np.zeros((len(seeds), 0), np.float32),
                    n_parts=0, n_conts=0, reference=np.zeros(0))

    floors = np.array([f for f, _p, _c, _m, _fin in trace], dtype=np.float64)
    parts = np.array([p for _f, p, _c, _m, _fin in trace], dtype=np.int32)
    conts = np.array([c for _f, _p, c, _m, _fin in trace], dtype=np.int32)
    means = np.array([m for _f, _p, _c, m, _fin in trace], dtype=np.float64)
    ref_fin = np.array([fin for _f, _p, _c, _m, fin in trace],
                       dtype=np.float64)
    n_parts = int(parts.max()) + 1
    n_conts = int(conts.max()) + 1

    # cv is memory-shaped only (service_time_mean), constant per cell
    cfg = dict(DEFAULTS)
    cfg.update(exp.backend_attrs)
    profile = KMeansStreamWorkload(
        points=exp.points, centroids=exp.centroids,
        policy=exp.effective_policy, n_partitions=1).profile()
    _mean, cv = service_time_mean(cfg, exp.memory_mb, profile, False)
    sigma2 = math.log1p(cv * cv)
    a, b = -0.5 * sigma2, math.sqrt(sigma2)

    z = np.stack([Simulator(seed=s).normals(n) for s in seeds])
    # the per-invocation jitter factors, float32 (as the lockstep contract
    # states), computed on the host as the reference computes them
    dt = means.astype(np.float32)[None, :] \
        * np.exp(np.float32(a) + np.float32(b) * z.astype(np.float32))
    return dict(floors=floors.astype(np.float32), parts=parts, conts=conts, dt=dt,
                n_parts=n_parts, n_conts=n_conts, reference=ref_fin)
