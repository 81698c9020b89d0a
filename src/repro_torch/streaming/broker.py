"""Partitioned message broker — the Kafka/Kinesis abstraction.

Ports ``repro.streaming.broker``.  A topic is a set of partitions; a
partition is an append-only offset-addressed log; consumer groups track
per-partition committed offsets, and ``lag`` (appended but uncommitted
messages) is the backpressure signal.  ``repartition`` reshards a topic live
(Kinesis shard split/merge): growing adds partitions, shrinking seals the
tail ones, whose backlogs consumers still drain.

Consumers register append subscribers (``subscribe``): callbacks run
synchronously after every append, outside the broker lock — the push path
the streaming engine uses to wake a partition's consumer.

Keyed routing uses a stable hash (``zlib.crc32``), not builtin ``hash``,
whose string hashing is salted per process.
"""

from __future__ import annotations

import threading
import zlib
from typing import Any, Callable, NamedTuple

__all__ = ["Message", "Broker", "stable_hash"]


def stable_hash(key: Any) -> int:
    """Process-independent hash for keyed partition routing (crc32)."""
    if isinstance(key, bytes):
        data = key
    elif isinstance(key, str):
        data = key.encode("utf-8")
    else:
        data = repr(key).encode("utf-8")
    return zlib.crc32(data)


class Message(NamedTuple):
    """Immutable broker record."""

    topic: str
    partition: int
    offset: int
    ts: float                  # broker append timestamp
    key: Any
    value: Any
    run_id: str | None = None
    msg_id: str | None = None
    size_bytes: int = 0


class Broker:
    def __init__(self) -> None:
        self._logs: dict[str, list[list[Message]]] = {}
        self._commits: dict[tuple[str, str, int], int] = {}  # (group, topic, part) -> next offset
        self._rr: dict[str, int] = {}
        self._subs: dict[str, list[Callable[[Message], None]]] = {}
        self._lock = threading.RLock()  # simlint: allow[lock-site] — broker state (topics/commits/counters); leaf, subscribers run outside it; kept for the reference gate; the port's manifest registers it
        # maintained incrementally so lag() is O(1)
        self._appended_total: dict[str, int] = {}
        self._committed_total: dict[tuple[str, str], int] = {}
        self._active: dict[str, int] = {}   # open (routable) partition count

    # -- topic admin -------------------------------------------------------
    def create_topic(self, name: str, partitions: int) -> None:
        with self._lock:
            if name in self._logs:
                raise ValueError(f"topic '{name}' exists")
            if partitions < 1:
                raise ValueError("partitions must be >= 1")
            self._logs[name] = [[] for _ in range(partitions)]
            self._rr[name] = 0
            self._appended_total[name] = 0
            self._active[name] = partitions

    def num_partitions(self, topic: str) -> int:
        """Partitions new messages route to (Kinesis: open shards)."""
        return self._active[topic]

    def total_partitions(self, topic: str) -> int:
        """All partitions ever created, sealed ones included: consumers keep
        draining sealed partitions' backlogs."""
        return len(self._logs[topic])

    def repartition(self, topic: str, partitions: int) -> int:
        """Live resharding: growing appends fresh partitions; shrinking
        seals the tail ones (their logs stay addressable, offsets never
        move) so new messages route only to the first ``partitions``.
        Returns the new active count.  No data is dropped."""
        with self._lock:
            if partitions < 1:
                raise ValueError("partitions must be >= 1")
            logs = self._logs[topic]
            while len(logs) < partitions:
                logs.append([])
            self._active[topic] = partitions
            return partitions

    def topics(self) -> list[str]:
        return sorted(self._logs)

    # -- produce ------------------------------------------------------------
    def partition_for(self, topic: str, key: Any) -> int:
        with self._lock:
            n = self._active[topic]
            if key is None:
                p = self._rr[topic] % n
                self._rr[topic] += 1
                return p
            return stable_hash(key) % n

    def subscribe(self, topic: str, fn: Callable[[Message], None]) -> None:
        """Register ``fn(msg)`` to be called after every append to ``topic``
        (synchronously, in the appender's thread, outside the lock; it must
        not block)."""
        with self._lock:
            if topic not in self._logs:
                raise KeyError(f"unknown topic '{topic}'")
            self._subs.setdefault(topic, []).append(fn)

    def append(self, topic: str, value: Any, *, ts: float, key: Any = None,
               partition: int | None = None, run_id: str | None = None,
               msg_id: str | None = None, size_bytes: int = 0) -> Message:
        """Append one message and return it.  A message without an explicit
        ``msg_id`` gets the stable id ``topic/partition/offset``; redeliveries
        pass the original id, which the engine's accounting dedupes on."""
        with self._lock:
            if partition is None:
                partition = self.partition_for(topic, key)
            log = self._logs[topic][partition]
            if msg_id is None:
                msg_id = f"{topic}/{partition}/{len(log)}"
            msg = Message(topic, partition, len(log), ts, key, value,
                          run_id, msg_id, size_bytes)
            log.append(msg)
            self._appended_total[topic] += 1
            subs = list(self._subs.get(topic, ()))
        for fn in subs:
            fn(msg)
        return msg

    # -- consume --------------------------------------------------------------
    def fetch(self, topic: str, partition: int, offset: int,
              max_records: int = 64) -> list[Message]:
        with self._lock:
            return self._logs[topic][partition][offset:offset + max_records]

    def end_offset(self, topic: str, partition: int) -> int:
        with self._lock:
            return len(self._logs[topic][partition])

    def end_offsets(self, topic: str) -> list[int]:
        """End offsets of every partition (sealed ones included) under one
        lock acquisition."""
        with self._lock:
            return [len(log) for log in self._logs[topic]]

    def commit(self, group: str, topic: str, partition: int, offset: int) -> None:
        """Commit ``offset`` = next offset to read (Kafka semantics)."""
        with self._lock:
            key = (group, topic, partition)
            old = self._commits.get(key, 0)
            if offset > old:
                self._commits[key] = offset
                gt = (group, topic)
                self._committed_total[gt] = self._committed_total.get(gt, 0) \
                    + (offset - old)

    def committed(self, group: str, topic: str, partition: int) -> int:
        with self._lock:
            return self._commits.get((group, topic, partition), 0)

    # -- backpressure signal ------------------------------------------------
    def lag(self, group: str, topic: str) -> int:
        """Total appended-but-uncommitted messages across partitions (O(1))."""
        with self._lock:
            return (self._appended_total[topic]
                    - self._committed_total.get((group, topic), 0))

    def appended_total(self, topic: str) -> int:
        with self._lock:
            return self._appended_total[topic]

    def total_messages(self, topic: str) -> int:
        with self._lock:
            return sum(len(log) for log in self._logs[topic])
