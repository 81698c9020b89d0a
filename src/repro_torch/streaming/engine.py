"""Streaming processing engine: binds compute-units to broker partitions.

Ports the threaded (wall-clock) engine of ``repro.streaming.engine``.  Each
partition is consumed in order by its own thread; up to ``batch_max``
pending messages are micro-batched into one compute-unit, submitted to the
pilot, and the CU's completion commits the partition offset.

* **push wakeups** — the engine subscribes to the broker's append hook,
  which sets the partition's wakeup event; a 10 ms poll is only the
  bounded fallback wait;
* **at-least-once + idempotent accounting** — offsets advance only on
  completion; a redelivered message (same stable ``msg_id``, new offset)
  commits but settles as ``dup_delivered``, so ``processed`` counts each
  message once;
* **bounded retry** — a failed CU is re-submitted at once, up to
  ``max_retries`` times; then its batch is abandoned and the partition
  moves on.

The virtual-clock ``SimStreamingEngine``, the real-time ticker
(``call_later``), live ``repartition``, ``stall_partition``, straggler
speculation and retry backoff come with later slices.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any, Callable

from repro_torch.core.metrics import MetricRegistry
from repro_torch.pilot.api import ComputeUnitDescription, Pilot, State
from repro_torch.streaming.broker import Broker, Message

__all__ = ["Workload", "ThreadedStreamingEngine"]

_POLL_S = 0.01      # bounded fallback wait behind the push wakeups


@dataclass
class Workload:
    """What to run per micro-batch of messages: ``fn(msgs)``."""

    fn: Callable[[list[Message]], Any] | None = None
    name: str = "workload"


@dataclass(slots=True)
class _PartitionState:
    next_offset: int = 0

    def is_done(self, key: tuple) -> bool:
        """True if the (offset_lo, offset_hi) batch already committed:
        commits only ever advance ``next_offset``."""
        return key[1] <= self.next_offset


class _EngineCore:
    """Partition state and accounting shared by the consumer threads."""

    def __init__(self, broker: Broker, topic: str, pilot: Pilot, workload: Workload,
                 metrics: MetricRegistry, run_id: str, group: str = "engine",
                 batch_max: int = 8, max_retries: int = 2) -> None:
        self.broker = broker
        self.topic = topic
        self.pilot = pilot
        self.workload = workload
        self.metrics = metrics
        self.run_id = run_id
        self.group = group
        self.batch_max = batch_max
        self.max_retries = max_retries
        self.n_partitions = broker.num_partitions(topic)
        self.parts = [_PartitionState() for _ in range(self.n_partitions)]
        self._rec_complete = metrics.recorder(run_id, "engine", "complete")
        # every consumer thread writes the aggregate counters; drain() relies
        # on their exact sum, so read-modify-writes must not interleave
        self.counter_lock = threading.Lock()  # simlint: allow[lock-site] — shared accounting counters; leaf, never held across a broker or pilot call; the manifest's known_locks cover only the reference package
        self.processed = 0
        self.failed_batches = 0
        self.abandoned = 0           # messages skipped by poison batches
        self.duplicates = 0          # batch-level duplicate completions
        self.dup_delivered = 0       # redelivered messages (same stable id)
        self.retried = 0
        self.seen_ids: set = set()   # stable msg_ids settled as processed
        self.idle_fetches = 0

    def make_cu_desc(self, msgs: list[Message], partition: int | None) -> ComputeUnitDescription:
        fn = (lambda: self.workload.fn(msgs)) if self.workload.fn else None
        return ComputeUnitDescription(func=fn,
                                      name=f"{self.workload.name}[p{partition}]",
                                      run_id=self.run_id, partition=partition)

    def on_batch_done(self, partition: int, msgs: list[Message], now: float) -> bool:
        """Commit + metrics; returns False if the batch already committed."""
        ps = self.parts[partition]
        key = (msgs[0].offset, msgs[-1].offset + 1)
        if ps.is_done(key):
            with self.counter_lock:
                self.duplicates += 1
            return False
        ps.next_offset = msgs[-1].offset + 1
        self.broker.commit(self.group, self.topic, partition, ps.next_offset)
        fresh = []
        dups = 0
        with self.counter_lock:
            for m in msgs:
                mid = m.msg_id
                if mid is not None and mid in self.seen_ids:
                    dups += 1
                else:
                    if mid is not None:
                        self.seen_ids.add(mid)
                    fresh.append(m)
            self.processed += len(fresh)
            self.dup_delivered += dups
        for m in fresh:
            self._rec_complete(now, msg_id=m.msg_id, partition=partition)
        return True


class ThreadedStreamingEngine:
    """Wall-clock engine: one consumer thread per partition, real compute."""

    def __init__(self, broker: Broker, topic: str, pilot: Pilot, workload: Workload,
                 metrics: MetricRegistry, run_id: str, *, group: str = "engine",
                 batch_max: int = 8, max_retries: int = 2) -> None:
        self.core = _EngineCore(broker, topic, pilot, workload, metrics, run_id,
                                group=group, batch_max=batch_max,
                                max_retries=max_retries)
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._wakeups = [threading.Event() for _ in range(self.core.n_partitions)]

    def start(self) -> None:
        self.core.broker.subscribe(self.core.topic,
                                   lambda msg: self._wakeups[msg.partition].set())
        for p in range(self.core.n_partitions):
            t = threading.Thread(target=self._consume, args=(p,), daemon=True,
                                 name=f"consumer-p{p}")
            t.start()
            self._threads.append(t)

    def _await(self, cu) -> None:
        """Block until ``cu`` is final or the engine stops."""
        while not cu.state.is_final and not self._stop.is_set():
            cu.done_event.wait(_POLL_S)

    def _consume(self, partition: int) -> None:
        core = self.core
        ps = core.parts[partition]
        wakeup = self._wakeups[partition]
        while not self._stop.is_set():
            wakeup.clear()
            msgs = core.broker.fetch(core.topic, partition, ps.next_offset, core.batch_max)
            if not msgs:
                with core.counter_lock:
                    core.idle_fetches += 1
                # an append between the fetch and this wait sets the event,
                # so the wait returns at once — no lost wakeups
                wakeup.wait(_POLL_S)
                continue
            attempts = 0
            while True:
                cu = core.pilot.submit_compute_unit(core.make_cu_desc(msgs, partition))
                self._await(cu)
                if not cu.state.is_final:
                    return     # stopping
                if cu.state == State.DONE:
                    core.on_batch_done(partition, msgs, time.perf_counter())
                    break
                # FAILED
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

    def stop(self, timeout: float = 5.0) -> None:
        """Stop the consumers; ``timeout`` is one deadline for all joins."""
        self._stop.set()
        for ev in self._wakeups:
            ev.set()
        deadline = time.perf_counter() + timeout
        for t in self._threads:
            t.join(timeout=max(0.0, deadline - time.perf_counter()))

    def drain(self, n_expected: int, timeout: float = 60.0) -> None:
        """Block until ``n_expected`` unique messages are accounted for
        (processed or abandoned) and the consumer group's lag is zero."""
        core = self.core
        deadline = time.perf_counter() + timeout
        while time.perf_counter() < deadline:
            if core.processed + core.abandoned >= n_expected \
                    and core.broker.lag(core.group, core.topic) == 0:
                return
            time.sleep(_POLL_S)
        raise TimeoutError(
            f"drained {core.processed}+{core.abandoned} abandoned"
            f"/{n_expected} messages "
            f"(lag={core.broker.lag(core.group, core.topic)})")
