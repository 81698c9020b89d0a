"""Discrete-event simulation core (virtual clock).

Ports ``repro.sim.des`` line for line: the port's simulated platforms
(``pilot/backends/serverless.py``, ``pilot/backends/hpcsim.py``) reproduce
the paper's AWS Lambda and XSEDE HPC runs as mechanism-level simulations on
this clock, and every cell must agree with the reference's bit for bit on
the same seed.  That holds only if the draws from ``self.rng`` are the same
draws in the same order, so the batched normal stream (``_next_normal``,
``lognormal_jitter``, ``jitter_coeffs``, ``normals``: 256 draws a block)
is copied exactly.

Entities schedule callbacks at virtual timestamps; ``run_until`` advances
the clock.  Heap entries are plain ``(ts, seq, record)`` tuples, so ordering
resolves through C-level tuple comparison; ``events_processed`` counts the
executed (non-canceled) events.  ``SharedResource`` is processor sharing in
the virtual-finish-time formulation (O(log n) per arrival or departure).
No wall clock is read anywhere in this module.
"""

from __future__ import annotations

import heapq
import itertools
import math
from typing import Callable

import numpy as np

__all__ = ["Simulator", "SimProcessError"]


class SimProcessError(RuntimeError):
    """Raised inside a simulated task to signal failure (walltime kill, ...)."""


class _Scheduled:
    """Cancelable handle for one scheduled callback (heap payload only —
    ordering lives in the ``(ts, seq)`` tuple prefix of the heap entry)."""

    __slots__ = ("ts", "fn", "canceled")

    def __init__(self, ts: float, fn: Callable[[], None]) -> None:
        self.ts = ts
        self.fn = fn
        self.canceled = False


class Simulator:
    """Minimal, deterministic discrete-event simulator."""

    def __init__(self, seed: int = 0) -> None:
        self._queue: list[tuple[float, int, _Scheduled]] = []
        self._seq = itertools.count()
        self.now: float = 0.0
        self.rng = np.random.default_rng(seed)
        self.events_processed: int = 0
        self._jitter_params: dict[float, tuple[float, float]] = {}
        self._z_block: np.ndarray | None = None
        self._z_i: int = 0

    def schedule(self, delay: float, fn: Callable[[], None]) -> _Scheduled:
        """Schedule ``fn`` to run ``delay`` seconds from now.  Returns a
        cancelable handle."""
        if delay < 0:
            raise ValueError(f"negative delay {delay}")
        ts = self.now + delay
        ev = _Scheduled(ts, fn)
        heapq.heappush(self._queue, (ts, next(self._seq), ev))
        return ev

    def schedule_fast(self, delay: float, fn: Callable[[], None]) -> None:
        """Schedule ``fn`` with no cancellation handle.

        Most simulation events (producer ticks, service-phase transitions,
        lock handoffs) are never canceled; skipping the ``_Scheduled``
        record halves the allocations per event on those paths.  Ordering
        is identical to ``schedule`` — same ``(ts, seq)`` key space."""
        if delay < 0:
            raise ValueError(f"negative delay {delay}")
        heapq.heappush(self._queue, (self.now + delay, next(self._seq), fn))

    def schedule_at(self, ts: float, fn: Callable[[], None]) -> None:
        """Schedule ``fn`` at the *absolute* virtual timestamp ``ts``.

        Batched-stepping hook: a stepper that precomputes event times as
        exact floats (e.g. the what-if fast replay's ingest completions)
        must not round-trip them through ``now + (ts - now)`` — that float
        detour changes the timestamp in the last ulp and breaks
        bit-agreement with the scalar path.  Same ``(ts, seq)`` key space
        as ``schedule``/``schedule_fast``."""
        if ts < self.now:
            raise ValueError(f"timestamp {ts} is in the past (now={self.now})")
        heapq.heappush(self._queue, (ts, next(self._seq), fn))

    def cancel(self, ev: _Scheduled) -> None:
        ev.canceled = True

    def step(self) -> bool:
        """Run the next event. Returns False when the queue is empty."""
        queue = self._queue
        while queue:
            ts, _seq, obj = heapq.heappop(queue)
            if type(obj) is _Scheduled:
                if obj.canceled:
                    continue
                obj = obj.fn
            self.now = ts
            self.events_processed += 1
            obj()
            return True
        return False

    def run_until(self, t: float | None = None, predicate: Callable[[], bool] | None = None,
                  max_events: int = 50_000_000) -> None:
        """Advance until time ``t``, ``predicate()`` is true, or queue empty."""
        queue = self._queue
        heappop = heapq.heappop
        # events_processed is accumulated locally and flushed on exit (incl.
        # nested run_until calls, which flush their own count): an instance
        # attribute store per event is measurable at this loop's scale
        count = 0
        try:
            for _ in range(max_events):
                if predicate is not None and predicate():
                    return
                if not queue:
                    return
                if t is not None and queue[0][0] > t:
                    self.now = t
                    return
                # inline step(): skip canceled entries without re-checking
                # the predicate (cancellation cannot make it true)
                while True:
                    ts, _seq, obj = heappop(queue)
                    if type(obj) is _Scheduled:
                        if obj.canceled:
                            if not queue:
                                return
                            if t is not None and queue[0][0] > t:
                                self.now = t
                                return
                            continue
                        obj = obj.fn
                    break
                self.now = ts
                count += 1
                obj()
        finally:
            self.events_processed += count
        raise RuntimeError("simulation exceeded max_events — runaway event loop?")

    def run(self) -> None:
        self.run_until()

    # -- convenience: stochastic service times ------------------------------
    def _next_normal(self) -> float:
        """One standard-normal draw from a prefetched block — a scalar
        ``Generator`` method call per event costs more than the draw itself,
        so jitter consumes the stream 256 draws at a time.  Still fully
        deterministic given the seed."""
        i = self._z_i
        block = self._z_block
        if block is None or i >= 256:
            block = self._z_block = self.rng.standard_normal(256)
            i = 0
        self._z_i = i + 1
        return block[i]

    def lognormal_jitter(self, mean: float, cv: float) -> float:
        """Multiplicative lognormal jitter around ``mean`` with coefficient of
        variation ``cv`` (cv=0 → deterministic)."""
        if cv <= 0.0:
            return mean
        params = self._jitter_params.get(cv)
        if params is None:
            sigma2 = math.log1p(cv * cv)
            params = (-0.5 * sigma2, math.sqrt(sigma2))
            self._jitter_params[cv] = params
        return mean * math.exp(params[0] + params[1] * self._next_normal())

    def jitter_coeffs(self, cv: float) -> tuple[float, float]:
        """``(a, b)`` such that ``lognormal_jitter(mean, cv) ==
        mean * exp(a + b * z)`` for the next standard-normal draw ``z``.

        Batched-stepping hook: lets a columnar stepper apply the identical
        jitter transform to a prefetched block of draws.  Uses (and fills)
        the same per-``cv`` coefficient cache as ``lognormal_jitter``."""
        params = self._jitter_params.get(cv)
        if params is None:
            sigma2 = math.log1p(cv * cv)
            params = (-0.5 * sigma2, math.sqrt(sigma2))
            self._jitter_params[cv] = params
        return params

    def normals(self, k: int) -> np.ndarray:
        """The next ``k`` standard-normal draws as one array.

        Batched-stepping hook: consumes the *same* 256-draw prefetched
        block stream as the per-event ``_next_normal``, so a vectorized
        stepper that pre-draws its jitter sees bit-identical values to a
        scalar run making ``k`` sequential ``lognormal_jitter`` calls."""
        out = np.empty(k, dtype=np.float64)
        filled = 0
        while filled < k:
            if self._z_block is None or self._z_i >= 256:
                self._z_block = self.rng.standard_normal(256)
                self._z_i = 0
            take = min(k - filled, 256 - self._z_i)
            out[filled:filled + take] = \
                self._z_block[self._z_i:self._z_i + take]
            self._z_i += take
            filled += take
        return out


class SimLock:
    """FIFO mutex on the virtual clock.

    Models the shared-model read-modify-write critical section the paper's
    HPC runs serialize on ("synchronization of the model updates via the
    shared filesystem"): one holder at a time, waiters queue.
    """

    def __init__(self, sim: Simulator, name: str = "lock") -> None:
        self.sim = sim
        self.name = name
        self._held = False
        self._waiters: list[Callable[[], None]] = []

    def acquire(self, on_acquired: Callable[[], None]) -> None:
        if not self._held:
            # uncontended: run the critical section synchronously — a
            # zero-delay handoff event models no time and only costs heap
            # traffic.  Contended handoffs (release → next waiter) stay
            # event-scheduled to bound recursion depth under lock convoys.
            self._held = True
            on_acquired()
        else:
            self._waiters.append(on_acquired)

    def release(self) -> None:
        if self._waiters:
            # hand off synchronously: like the uncontended acquire, the
            # zero-delay hop models no time.  Recursion depth is bounded by
            # the waiter queue (≤ one per worker): the next holder's
            # continuation schedules its lock-hold work and returns rather
            # than releasing inline.
            self._waiters.pop(0)()
        else:
            self._held = False

    @property
    def queue_len(self) -> int:
        return len(self._waiters)


class SharedResource:
    """Processor-sharing resource: ``capacity`` units/sec split evenly among
    active flows.  Models a shared filesystem / network link.

    Implemented with the standard *virtual-finish-time* formulation: virtual
    time ``V`` advances at the per-flow service rate (``capacity / n``), so a
    flow arriving with ``work`` units finishes exactly when ``V`` reaches
    ``V(arrival) + work`` — independent of later arrivals/departures, which
    only change how fast ``V`` advances.  Completions therefore pop off a
    finish-tag heap in O(log n), instead of rescanning every flow's
    remaining work on each arrival/departure.
    """

    def __init__(self, sim: Simulator, capacity: float, name: str = "res") -> None:
        self.sim = sim
        self.capacity = float(capacity)
        self.name = name
        self._flows: dict[int, Callable[[], None]] = {}
        self._finish_heap: list[tuple[float, int]] = []  # (finish vtag, fid)
        self._ids = itertools.count()
        self._vtime = 0.0
        self._last_ts = 0.0
        self._next_completion: _Scheduled | None = None

    @property
    def active_flows(self) -> int:
        return len(self._flows)

    def submit(self, work: float, on_done: Callable[[], None]) -> None:
        """Submit ``work`` units (e.g. bytes); ``on_done`` fires at completion."""
        if work <= 0:
            self.sim.schedule_fast(0.0, on_done)
            return
        flows = self._flows
        n = len(flows)
        if n:   # advance V at the pre-arrival rate (inlined _advance_vtime)
            dt = self.sim.now - self._last_ts
            if dt > 0:
                self._vtime += dt * (self.capacity / n)
        self._last_ts = self.sim.now
        fid = next(self._ids)
        flows[fid] = on_done
        heapq.heappush(self._finish_heap, (self._vtime + float(work), fid))
        if self._next_completion is not None:
            self._next_completion.canceled = True
        delay = max(self._finish_heap[0][0] - self._vtime, 0.0) \
            * (n + 1) / self.capacity
        self._next_completion = self.sim.schedule(delay, self._complete)

    def _complete(self) -> None:
        flows = self._flows
        n = len(flows)
        dt = self.sim.now - self._last_ts
        if dt > 0:
            self._vtime += dt * (self.capacity / n)
        self._last_ts = self.sim.now
        _vtag, fid = heapq.heappop(self._finish_heap)
        on_done = flows.pop(fid)
        if n > 1:
            delay = max(self._finish_heap[0][0] - self._vtime, 0.0) \
                * (n - 1) / self.capacity
            self._next_completion = self.sim.schedule(delay, self._complete)
        else:
            self._next_completion = None
        on_done()
