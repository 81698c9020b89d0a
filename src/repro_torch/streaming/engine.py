"""Streaming processing engine: binds compute-units to broker partitions.

Ports ``repro.streaming.engine``.  Each partition is consumed in order; up
to ``batch_max`` pending messages are micro-batched into one compute-unit,
submitted to the pilot, and the CU's completion commits the partition
offset.  Dispatch is push-based: the engines subscribe to the broker's
append hook and dispatch the moment a message lands in an idle partition.

Two engines share ``_EngineCore``'s accounting:

* ``SimStreamingEngine`` — the virtual clock of ``sim.des``, the paper's
  simulated Lambda and Wrangler cells.  It draws its retry jitter from
  ``sim.rng``, interleaved with the backends' draws on one stream, so a cell
  agrees with the reference's bit for bit on the same seed.
* ``ThreadedStreamingEngine`` — the wall clock, one consumer thread per
  partition, real compute (the ``torch://`` pilot on the card).

Fault tolerance, on both: bounded retry with exponential backoff and jitter
(``retry_backoff_s``; after a ``ConnectionError`` the retry drops its
partition pinning); straggler speculation (a copy is dispatched once a CU
exceeds 4x the median runtime, the first finisher commits); at-least-once
delivery with idempotent accounting (a redelivered message, same stable
``msg_id`` at a new offset, commits but settles as ``dup_delivered``);
``stall_partition`` freezes a partition's dispatch (fault injection).

Both expose the control surface ``now()`` / ``call_later()`` /
``repartition()`` / ``run_on_clock()``: the DES clock, or
``time.perf_counter`` plus a real-time ticker thread.  The threaded engine takes no lock of its own (the
reference's ticker condition and admin lock are designed away):

* the ticker owns its heap; ``call_later`` hands it entries through a
  ``queue.SimpleQueue`` and it sleeps in ``get(timeout=next_due - now)``;
* partition state, wakeup events and consumer threads sit in dicts keyed by
  partition and are added only by ``dict.setdefault``, which is atomic, so
  concurrent ``repartition`` calls (the append hook of a producer thread
  racing the control loop) adopt each partition exactly once and start one
  consumer for it;
* the migration pause and the stalls are set by the control loop and the
  fault injector, which both run on the ticker thread: one writer.
"""

from __future__ import annotations

import heapq
import itertools
import queue
import statistics
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np

from repro_torch.core.metrics import MetricRegistry
from repro_torch.pilot.api import ComputeUnitDescription, Pilot, State, TaskProfile
from repro_torch.sim.des import Simulator
from repro_torch.streaming.broker import Broker, Message

__all__ = ["Workload", "SimStreamingEngine", "ThreadedStreamingEngine"]


@dataclass
class Workload:
    """What to run per micro-batch of messages.

    ``profile_for(msgs)`` -> TaskProfile consumed by the simulated backends.
    ``fn(msgs)`` optional real computation (run by the ``torch://`` pilot,
    and by the simulated backends when the unit completes on the virtual
    clock, for its state effects).
    """

    profile_for: Callable[[list[Message]], TaskProfile] | None = None
    fn: Callable[[list[Message]], Any] | None = None
    name: str = "workload"


@dataclass(slots=True)
class _PartitionState:
    next_offset: int = 0
    inflight: bool = False
    retries: int = 0
    stalled_until: float = 0.0     # fault-injected dispatch freeze

    def is_done(self, key: tuple) -> bool:
        """True if the (offset_lo, offset_hi) batch already committed.

        Batches are fetched contiguously from ``next_offset`` and commits
        only ever advance it, so a batch is settled iff the offset has
        moved past its end.  This guard must hold for *any* historical
        batch — a late straggler duplicate completing after several newer
        batches must never roll ``next_offset`` back."""
        return key[1] <= self.next_offset


class _EngineCore:
    """Shared bookkeeping between the sim and threaded engines."""

    def __init__(self, broker: Broker, topic: str, pilot: Pilot, workload: Workload,
                 metrics: MetricRegistry, run_id: str, group: str = "engine",
                 batch_max: int = 8, max_retries: int = 2,
                 retry_backoff_s: float = 0.0,
                 retry_backoff_cap_s: float = 30.0, rng=None,
                 seed: int = 0) -> None:
        self.broker = broker
        self.topic = topic
        self.pilot = pilot
        self.workload = workload
        self.metrics = metrics
        self.run_id = run_id
        self.group = group
        self.batch_max = batch_max
        self.max_retries = max_retries
        self.retry_backoff_s = retry_backoff_s
        self.retry_backoff_cap_s = retry_backoff_cap_s
        # seeded Generator for backoff jitter; with no explicit rng the
        # stream derives from the experiment seed (never unseeded, never
        # jitter-free) so faulted reruns stay bit-identical by default
        self._retry_rng = rng if rng is not None \
            else np.random.default_rng([0x5EED, seed])
        # keyed by partition and grown only by ``adopt`` (``dict.setdefault``
        # is atomic, so the threaded engine's consumers need no lock for it)
        self.parts: dict[int, _PartitionState] = {}
        self.adopt(broker.num_partitions(topic))
        self.completed_runtimes: list[float] = []
        self._rec_complete = metrics.recorder(run_id, "engine", "complete")
        self._rec_dispatch = metrics.recorder(run_id, "engine", "dispatch")
        # aggregate counters are written by every consumer thread of the
        # threaded engine; drain() relies on their exact sum, so updates
        # must not be lost to interleaved read-modify-writes
        self.counter_lock = threading.Lock()  # simlint: allow[lock-site] — shared accounting counters; leaf, never held across a broker or pilot call; the manifest's known_locks cover only the reference package
        self.processed = 0
        self.failed_batches = 0
        self.abandoned = 0          # actual messages skipped by poison batches
        self.duplicates = 0          # batch-level duplicate completions
        self.dup_delivered = 0       # redelivered messages (same stable id)
        self.retried = 0
        self.seen_ids: set = set()   # stable msg_ids settled as processed
        self._straggler_cache = (0, float("inf"))  # (runtimes seen, timeout)
        # Empty fetches: none schedule events (push engines just go quiet).
        # Grows with completions that catch up to the producer, so it is a
        # caught-up-consumer signal, not an idle-poll count.
        self.idle_fetches = 0

    @property
    def n_partitions(self) -> int:
        """Partitions the engine has adopted (sealed ones included)."""
        return len(self.parts)

    def adopt(self, total: int) -> None:
        """Give partitions ``0..total-1`` consumer state, keeping what exists."""
        for p in range(total):
            self.parts.setdefault(p, _PartitionState())

    def make_cu_desc(self, msgs: list[Message], partition: int | None) -> ComputeUnitDescription:
        profile = self.workload.profile_for(msgs) if self.workload.profile_for else TaskProfile()
        fn = (lambda: self.workload.fn(msgs)) if self.workload.fn else None
        return ComputeUnitDescription(func=fn, profile=profile,
                                      name=f"{self.workload.name}[p{partition}]",
                                      run_id=self.run_id, partition=partition)

    def on_batch_done(self, partition: int, msgs: list[Message], now: float) -> bool:
        """Commit + metrics; returns False if another copy already won.

        Idempotent accounting: a *redelivered* message (same stable
        ``msg_id``, new offset) commits its offset like any other but
        settles as ``dup_delivered``, not ``processed`` — so ``processed``
        stays an exactly-once count despite at-least-once delivery, and a
        ``complete`` metric event is recorded only for the first copy
        (keeping latency pairing 1:1)."""
        ps = self.parts[partition]
        key = (msgs[0].offset, msgs[-1].offset + 1)
        if ps.is_done(key):
            with self.counter_lock:
                self.duplicates += 1
            return False
        ps.next_offset = msgs[-1].offset + 1
        self.broker.commit(self.group, self.topic, partition, ps.next_offset)
        seen = self.seen_ids
        fresh = []
        dups = 0
        with self.counter_lock:
            for m in msgs:
                mid = m.msg_id
                if mid is not None and mid in seen:
                    dups += 1
                else:
                    if mid is not None:
                        seen.add(mid)
                    fresh.append(m)
            self.processed += len(fresh)
            self.dup_delivered += dups
        rec = self._rec_complete
        for m in fresh:
            rec(now, msg_id=m.msg_id, partition=partition)
        return True

    def retry_delay(self, attempt: int) -> float:
        """Exponential backoff + jitter for retry ``attempt`` (1-based):
        ``backoff · 2^(attempt-1) · U[0.5, 1.5)`` capped at
        ``retry_backoff_cap_s``; 0 when backoff is disabled (the default,
        which keeps the pre-fault-era immediate-retry behaviour)."""
        base = self.retry_backoff_s
        if base <= 0.0:
            return 0.0
        delay = base * (2.0 ** (attempt - 1))
        with self.counter_lock:        # one rng, many consumer threads
            delay *= 0.5 + self._retry_rng.random()
        return min(delay, self.retry_backoff_cap_s)

    @property
    def straggler_timeout(self) -> float:
        """4× the median observed runtime (with a floor).

        The median over all completed runtimes is O(n log n); recomputing
        it on *every* dispatch made dispatch cost grow with run length.
        The estimate only needs to track the runtime distribution, so it
        refreshes exactly while the sample is small (< 32) and then once
        every 32 completions."""
        n = len(self.completed_runtimes)
        if n < 3:
            return float("inf")
        cached_n, cached = self._straggler_cache
        if n != cached_n and (n < 32 or n % 32 == 0 or cached_n < 3):
            cached = max(4.0 * statistics.median(self.completed_runtimes), 1e-3)
            self._straggler_cache = (n, cached)
        return cached


class SimStreamingEngine:
    """Virtual-clock engine (push-dispatched, used by all benchmarks).

    ``start`` subscribes to the broker's append hook and scans each
    partition once for pre-existing backlog; after that the engine is woken
    only by appends and by its own batch completions — no poll events.
    """

    def __init__(self, sim: Simulator, broker: Broker, topic: str, pilot: Pilot,
                 workload: Workload, metrics: MetricRegistry, run_id: str,
                 *, group: str = "engine", batch_max: int = 8,
                 max_retries: int = 2,
                 retry_backoff_s: float = 0.0,
                 straggler_mitigation: bool = True,
                 is_input_complete: Callable[[], bool] | None = None) -> None:
        self.sim = sim
        self.core = _EngineCore(broker, topic, pilot, workload, metrics, run_id,
                                group=group, batch_max=batch_max,
                                max_retries=max_retries,
                                retry_backoff_s=retry_backoff_s, rng=sim.rng)
        self.straggler_mitigation = straggler_mitigation
        self.is_input_complete = is_input_complete or (lambda: False)
        self._appended_seen = 0
        self._inflight_n = 0
        self._paused_until = 0.0       # state-migration dispatch pause

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> None:
        core = self.core

        def on_append(msg) -> None:
            self._appended_seen += 1
            self._drain(msg.partition)

        core.broker.subscribe(core.topic, on_append)
        # pre-subscribe backlog counts toward the settled-message fast path
        # (no appends can interleave here: the subscribe and this scan run
        # synchronously before the simulator advances)
        self._appended_seen = sum(core.broker.end_offset(core.topic, p)
                                  for p in range(core.n_partitions))
        for p in range(core.n_partitions):
            self.sim.schedule(0.0, lambda p=p: self._drain(p))

    def is_finished(self) -> bool:
        """O(1) fast path: every partition advances ``next_offset`` by
        exactly the messages it commits (``processed``) or poison-skips
        (``abandoned``), so the topic is drained iff those counters reach
        the number of appends observed.  ``run_until`` evaluates this
        predicate before *every* event, so the authoritative per-partition
        check runs only once the fast path says we are done (one bulk
        ``end_offsets`` read, a single lock acquisition)."""
        core = self.core
        if not self.is_input_complete():
            return False
        if self._inflight_n or core.processed + core.abandoned \
                + core.dup_delivered < self._appended_seen:
            return False
        ends = core.broker.end_offsets(core.topic)
        if len(core.parts) < len(ends):
            return False     # broker repartition not yet adopted
        return all(ps.next_offset >= end and not ps.inflight
                   for ps, end in zip(core.parts.values(), ends))

    def run_to_completion(self, max_virtual_s: float = 1e7) -> None:
        self.sim.run_until(t=self.sim.now + max_virtual_s, predicate=self.is_finished)
        if not self.is_finished():
            raise TimeoutError("engine did not drain the topic in time")

    # -- control surface (EngineControlSurface) -------------------------------
    def now(self) -> float:
        return self.sim.now

    def call_later(self, delay_s: float, fn: Callable[[], None]) -> None:
        self.sim.schedule_fast(delay_s, fn)

    def run_on_clock(self, fn: Callable[[], None]) -> None:
        """Run ``fn`` now: the DES runs its callbacks on the caller's thread."""
        fn()

    # -- live repartitioning (EILC: the control loop resizes N mid-run) -------
    def repartition(self, migration_s: float = 0.0) -> None:
        """Adopt the broker's current partition count mid-run.

        Newly created partitions get consumer state and start draining as
        appends land; sealed partitions keep draining their backlog until
        empty.  ``migration_s`` charges the state-migration cost of moving
        keyed state between partitions as a real DES event: dispatch is
        paused for that long (in-flight batches finish; new dispatches
        wait), then every partition is re-drained.
        """
        core = self.core
        total = core.broker.total_partitions(core.topic)
        core.adopt(total)
        if migration_s > 0.0:
            core.metrics.record(core.run_id, "engine", "migrate", self.sim.now,
                                duration=migration_s, partitions=total)
            resume_at = self.sim.now + migration_s
            if resume_at > self._paused_until:
                self._paused_until = resume_at
                self.sim.schedule_fast(migration_s, self._resume)

    def _resume(self) -> None:
        if self.sim.now < self._paused_until:
            return     # superseded by a longer, later migration pause
        for p in range(len(self.core.parts)):
            self._drain(p)

    # -- fault surface ---------------------------------------------------------
    def stall_partition(self, partition: int, duration_s: float) -> None:
        """Freeze dispatch on ``partition`` for ``duration_s`` virtual
        seconds (fault injection: a stuck shard).  In-flight batches
        finish; new fetches wait out the stall, then a scheduled re-drain
        resumes consumption."""
        core = self.core
        if partition not in core.parts:
            self.repartition()
        ps = core.parts[partition]
        until = self.sim.now + duration_s
        if until > ps.stalled_until:
            ps.stalled_until = until
            self.sim.schedule_fast(duration_s, lambda: self._drain(partition))

    # -- push-dispatched partition consumer -----------------------------------
    def _drain(self, partition: int) -> None:
        """Dispatch the next pending batch of ``partition``, if idle.

        Invoked synchronously from the broker's append hook and from batch
        completions — both already run inside a simulator event, so no extra
        event is scheduled on the hot path.
        """
        core = self.core
        if self.sim.now < self._paused_until:
            return     # migrating: the resume sweep re-drains every partition
        if partition not in core.parts:
            # append raced ahead of the control loop's repartition call
            self.repartition()
        ps = core.parts[partition]
        if self.sim.now < ps.stalled_until:
            return     # stalled: the stall-expiry event re-drains
        if ps.inflight:
            return
        msgs = core.broker.fetch(core.topic, partition, ps.next_offset, core.batch_max)
        if not msgs:
            core.idle_fetches += 1
            return
        ps.inflight = True
        self._inflight_n += 1
        ps.retries = 0
        self._dispatch(partition, msgs, pinned=True)

    def _dispatch(self, partition: int, msgs: list[Message], pinned: bool,
                  speculate: bool = True) -> None:
        core = self.core
        desc = core.make_cu_desc(msgs, partition if pinned else None)
        core._rec_dispatch(self.sim.now, partition=partition, batch=len(msgs))
        cu = core.pilot.submit_compute_unit(desc)
        straggler_ev = None
        if self.straggler_mitigation and speculate:
            timeout = core.straggler_timeout
            if timeout != float("inf"):
                straggler_ev = self.sim.schedule(
                    timeout, lambda: self._straggler_check(partition, msgs, cu))
        cu.add_done_callback(lambda cu: self._on_final(partition, msgs, cu, straggler_ev))

    def _straggler_check(self, partition: int, msgs: list[Message], cu) -> None:
        core = self.core
        ps = core.parts[partition]
        key = (msgs[0].offset, msgs[-1].offset + 1)
        if cu.state.is_final or ps.is_done(key):
            return
        core.metrics.record(core.run_id, "engine", "straggler_dup", self.sim.now,
                            partition=partition)
        # at most ONE backup copy per attempt (speculate=False), matching
        # the threaded engine's _await_first: a speculative copy that arms
        # its own straggler check breeds copy-of-copy chains whenever the
        # platform is convoyed (e.g. the HPC model-lock under a burst) —
        # every copy adds load to the shared bottleneck that made the
        # primary slow, a positive feedback loop that melts the run
        self._dispatch(partition, msgs, pinned=False, speculate=False)

    def _on_final(self, partition: int, msgs: list[Message], cu,
                  straggler_ev=None) -> None:
        core = self.core
        ps = core.parts[partition]
        if straggler_ev is not None:
            self.sim.cancel(straggler_ev)
        if cu.state == State.DONE:
            if core.on_batch_done(partition, msgs, self.sim.now):
                core.completed_runtimes.append(cu.runtime)
                ps.inflight = False
                self._inflight_n -= 1
                self._drain(partition)
            return
        # FAILED / CANCELED
        key = (msgs[0].offset, msgs[-1].offset + 1)
        if ps.is_done(key):
            return  # a duplicate already completed this batch
        if ps.retries < core.max_retries:
            ps.retries += 1
            core.retried += 1
            pinned = not isinstance(cu.exception, ConnectionError)
            delay = core.retry_delay(ps.retries)
            core.metrics.record(core.run_id, "engine", "retry", self.sim.now,
                                partition=partition, attempt=ps.retries,
                                backoff=delay)
            if delay > 0.0:
                # the batch stays in-flight through the backoff window, so
                # is_finished cannot falsely report a drained topic
                self.sim.schedule_fast(
                    delay, lambda: self._dispatch(partition, msgs, pinned=pinned))
            else:
                self._dispatch(partition, msgs, pinned=pinned)
        else:
            core.failed_batches += 1
            core.abandoned += len(msgs)
            core.metrics.record(core.run_id, "engine", "abandon", self.sim.now,
                                partition=partition, messages=len(msgs))
            ps.next_offset = msgs[-1].offset + 1   # skip poison batch, keep draining
            core.broker.commit(core.group, core.topic, partition, ps.next_offset)
            ps.inflight = False
            self._inflight_n -= 1
            self._drain(partition)



class _WallTicker(threading.Thread):
    """Real-time callback scheduler behind the threaded engine's
    ``call_later``, the wall-clock analogue of ``Simulator.schedule_fast``.

    One daemon thread owns a (due, seq, fn) heap; other threads hand it
    entries through a ``queue.SimpleQueue`` and it sleeps in
    ``get(timeout=next_due - now)``, so no lock or condition guards the
    heap.  A callback exception is kept (``last_error``, the first;
    ``errors``, the last 16) and the ticker keeps running."""

    def __init__(self) -> None:
        super().__init__(daemon=True, name="engine-ticker")
        self._inbox: queue.SimpleQueue = queue.SimpleQueue()
        self._seq = itertools.count()
        self.last_error: BaseException | None = None
        self.errors: deque = deque(maxlen=16)   # append/popleft are atomic

    def call_later(self, delay_s: float, fn: Callable[[], None]) -> None:
        self._inbox.put((time.perf_counter() + max(delay_s, 0.0),
                         next(self._seq), fn))

    def stop(self) -> None:
        self._inbox.put(None)

    def run_now(self, fn: Callable[[], None]) -> None:
        """Run ``fn`` on the ticker thread, after the callbacks that are
        due, and wait for it (re-raising what it raised); inline on the
        ticker thread itself, or when the ticker is not running, since then
        no callback can run beside it."""
        if threading.current_thread() is self or not self.is_alive():
            fn()
            return
        done = threading.Event()
        raised: list[BaseException] = []

        def call() -> None:
            try:
                fn()
            except BaseException as exc:  # noqa: BLE001 — re-raised by the caller
                raised.append(exc)
            finally:
                done.set()

        self._inbox.put((time.perf_counter(), next(self._seq), call))
        while not done.wait(0.05):
            if not self.is_alive():   # stopped before it took the call
                fn()
                return
        if raised:
            raise raised[0]

    def run(self) -> None:
        heap: list[tuple[float, int, Callable[[], None]]] = []
        while True:
            try:                     # take every submission that is waiting
                while True:
                    item = self._inbox.get_nowait()
                    if item is None:
                        return
                    heapq.heappush(heap, item)
            except queue.Empty:
                pass
            wait = heap[0][0] - time.perf_counter() if heap else None
            if wait is not None and wait <= 0:
                _due, _seq, fn = heapq.heappop(heap)
                try:
                    fn()
                except Exception as exc:  # noqa: BLE001 — keep ticking
                    if self.last_error is None:   # keep the root cause
                        self.last_error = exc
                    self.errors.append(exc)
                continue
            try:
                item = self._inbox.get(timeout=wait)
            except queue.Empty:
                continue
            if item is None:
                return
            heapq.heappush(heap, item)


class ThreadedStreamingEngine:
    """Wall-clock engine: one consumer thread per partition, real compute.

    Consumers block on a per-partition wakeup event that the broker's append
    hook sets (``poll_interval`` is the bounded fallback wait).  ``now()``
    is ``perf_counter``, ``call_later`` schedules on a ticker thread that
    ``start`` starts (callbacks handed over before then wait for it), and ``repartition`` adopts the broker's partition count
    mid-run: it grows consumer state, wakeup events and (once started)
    consumer threads, and pauses dispatch for the migration cost.
    """

    def __init__(self, broker: Broker, topic: str, pilot: Pilot, workload: Workload,
                 metrics: MetricRegistry, run_id: str, *, group: str = "engine",
                 batch_max: int = 8, poll_interval: float = 0.01,
                 max_retries: int = 2, retry_backoff_s: float = 0.0,
                 straggler_mitigation: bool = True, seed: int = 0) -> None:
        self.core = _EngineCore(broker, topic, pilot, workload, metrics, run_id,
                                group=group, batch_max=batch_max,
                                max_retries=max_retries,
                                retry_backoff_s=retry_backoff_s,
                                rng=np.random.default_rng(seed))
        self.poll_interval = poll_interval
        self.straggler_mitigation = straggler_mitigation
        self._stop = threading.Event()
        self._consumers: dict[int, threading.Thread] = {}
        self._wakeups = {p: threading.Event() for p in self.core.parts}
        self._ticker = _WallTicker()
        self._paused_until = 0.0       # state-migration dispatch pause
        self._started = False

    def start(self) -> None:
        def on_append(msg) -> None:
            if msg.partition not in self._wakeups:
                # append raced ahead of the control loop's repartition call
                self.repartition()
            self._wakeups[msg.partition].set()

        self.core.broker.subscribe(self.core.topic, on_append)
        self._started = True
        self._ticker.start()
        self._spawn_consumers(self.core.n_partitions)

    def _spawn_consumers(self, total: int) -> None:
        """Start a consumer thread for each of the first ``total``
        partitions that lacks one (their state and wakeup exist); the caller
        that wins the ``setdefault`` for a partition starts its consumer."""
        for p in range(total):
            if p in self._consumers:
                continue
            t = threading.Thread(target=self._consume, args=(p,), daemon=True,
                                 name=f"consumer-p{p}")
            if self._consumers.setdefault(p, t) is t:
                t.start()

    # -- control surface ---------------------------------------------------------
    def now(self) -> float:
        return time.perf_counter()

    def call_later(self, delay_s: float, fn: Callable[[], None]) -> None:
        self._ticker.call_later(delay_s, fn)

    def run_on_clock(self, fn: Callable[[], None]) -> None:
        """Run ``fn`` on the ticker thread, between ``call_later``
        callbacks, and return once it has run."""
        self._ticker.run_now(fn)

    @property
    def ticker_error(self) -> BaseException | None:
        """The first exception a ``call_later`` callback raised, if any: a
        failing callback does not stop the ticker, so callers check this
        after a run, or a crashed controller looks like a quiet success."""
        return self._ticker.last_error

    def drain_ticker_errors(self) -> list:
        """Pop and return every callback error since the last drain (the
        ticker keeps at most 16)."""
        out = []
        while True:
            try:
                out.append(self._ticker.errors.popleft())
            except IndexError:
                return out

    def repartition(self, migration_s: float = 0.0) -> None:
        """Adopt the broker's current partition count mid-run.

        New partitions get consumer state, a wakeup event and (once the
        engine is started) a consumer thread; sealed partitions keep
        draining their backlog.  ``migration_s`` charges the keyed-state
        migration as a real-time dispatch pause: in-flight batches finish,
        new dispatches wait it out.
        """
        core = self.core
        total = core.broker.total_partitions(core.topic)
        core.adopt(total)
        for p in range(total):
            self._wakeups.setdefault(p, threading.Event())
        if migration_s > 0.0:
            core.metrics.record(core.run_id, "engine", "migrate", self.now(),
                                duration=migration_s, partitions=total)
            self._paused_until = max(self._paused_until, self.now() + migration_s)
        if self._started:
            self._spawn_consumers(total)

    # -- fault surface -------------------------------------------------------------
    def stall_partition(self, partition: int, duration_s: float) -> None:
        """Freeze dispatch on ``partition`` for ``duration_s`` wall seconds
        (a stuck shard): the in-flight batch finishes; the consumer waits
        out the stall before its next fetch."""
        if partition not in self.core.parts:
            self.repartition()
        ps = self.core.parts[partition]
        until = self.now() + duration_s
        if until > ps.stalled_until:
            ps.stalled_until = until     # one float store; the consumer polls it

    def _await_first(self, cu, partition: int, msgs):
        """Block until the primary CU or its speculative copy is final;
        returns ``(winner, loser)`` (the loser may still run, or be None).
        The copy is dispatched unpinned once the primary exceeds
        ``straggler_timeout``: the first finisher wins, as in the virtual
        clock engine's ``_straggler_check``."""
        core = self.core
        spec = None
        t0 = time.perf_counter()
        while not self._stop.is_set():
            if cu.state.is_final:
                return cu, spec
            if spec is not None and spec.state.is_final:
                return spec, cu
            if spec is None and self.straggler_mitigation:
                timeout = core.straggler_timeout
                if timeout != float("inf") and time.perf_counter() - t0 > timeout:
                    core.metrics.record(core.run_id, "engine", "straggler_dup",
                                        time.perf_counter(), partition=partition)
                    spec = core.pilot.submit_compute_unit(core.make_cu_desc(msgs, None))
            cu.done_event.wait(self.poll_interval)
        return cu, spec     # stopping: the caller checks _stop

    def _consume(self, partition: int) -> None:
        core = self.core
        ps = core.parts[partition]
        wakeup = self._wakeups[partition]
        while not self._stop.is_set():
            pause = max(self._paused_until, ps.stalled_until) - time.perf_counter()
            if pause > 0:
                # migrating or stalled: interruptible sleep, then re-check
                self._stop.wait(min(pause, self.poll_interval))
                continue
            wakeup.clear()
            msgs = core.broker.fetch(core.topic, partition, ps.next_offset, core.batch_max)
            if not msgs:
                with core.counter_lock:
                    core.idle_fetches += 1
                # an append between the fetch and this wait sets the event,
                # so the wait returns at once — no lost wakeups
                wakeup.wait(self.poll_interval)
                continue
            attempts = 0
            while True:
                cu = core.pilot.submit_compute_unit(core.make_cu_desc(msgs, partition))
                winner, loser = self._await_first(cu, partition, msgs)
                if self._stop.is_set() and not winner.state.is_final:
                    return
                if winner.state == State.DONE:
                    if core.on_batch_done(partition, msgs, time.perf_counter()):
                        core.completed_runtimes.append(winner.runtime)
                    if loser is not None:
                        # the losing copy settles on the idempotent duplicate
                        # path when it lands; the batch is bound by value, as
                        # this loop rebinds ``msgs`` on its next fetch
                        loser.add_done_callback(
                            lambda lo, _msgs=msgs: core.on_batch_done(
                                partition, _msgs, time.perf_counter())
                            if lo.state == State.DONE else None)
                    break
                # FAILED / CANCELED
                if ps.is_done((msgs[0].offset, msgs[-1].offset + 1)):
                    break   # a speculative copy already committed it
                attempts += 1
                with core.counter_lock:
                    core.retried += 1
                if attempts > core.max_retries:
                    ps.next_offset = msgs[-1].offset + 1
                    core.broker.commit(core.group, core.topic, partition, ps.next_offset)
                    # counted after the commit so drain() cannot observe the
                    # count before the offset has advanced
                    with core.counter_lock:
                        core.failed_batches += 1
                        core.abandoned += len(msgs)
                    break
                delay = core.retry_delay(attempts)
                if delay > 0.0:
                    self._stop.wait(delay)     # interruptible backoff
                    if self._stop.is_set():
                        return

    def stop(self, timeout: float = 5.0) -> None:
        """Stop the consumers and the ticker; ``timeout`` is one deadline
        for all joins (consumers still busy past it are daemon threads)."""
        self._stop.set()
        for ev in list(self._wakeups.values()):
            ev.set()
        self._ticker.stop()
        deadline = time.perf_counter() + timeout
        for t in list(self._consumers.values()):
            if t.ident is not None:      # claimed and started
                t.join(timeout=max(0.0, deadline - time.perf_counter()))

    def drain(self, n_expected: int, timeout: float = 60.0) -> None:
        """Block until ``n_expected`` unique messages are accounted for
        (processed or abandoned) and the consumer group's lag is zero, so
        redelivered copies are committed too."""
        core = self.core
        deadline = time.perf_counter() + timeout
        while time.perf_counter() < deadline:
            if core.processed + core.abandoned >= n_expected \
                    and core.broker.lag(core.group, core.topic) == 0:
                return
            time.sleep(self.poll_interval)
        raise TimeoutError(
            f"drained {core.processed}+{core.abandoned} abandoned"
            f"/{n_expected} messages "
            f"(lag={core.broker.lag(core.group, core.topic)})")
