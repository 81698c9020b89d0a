"""Run-id tracing and metric collection (StreamInsight instrumentation layer).

Ports ``repro.core.metrics``.  Events append to per-``(run_id, component,
kind)`` columns of ``(ts, attrs)`` rows; ``record`` is one dict lookup plus
one ``list.append``, atomic under the GIL, so the engine's consumer threads
record without a lock, and derived queries (``latencies``, ``throughput``,
``steady_state_throughput``) read the columns with numpy.

The reference guards its time series, counters and merged summaries with a
lock.  Here they take no lock either: every write is one ``list.append``
(a series row, a counter increment, a worker's summary), and reads fold
the lists in append order — a counter is its increments summed one by one
from 0.0, merged summaries are merged in the order they arrived — which is
the arithmetic of the reference's locked read-modify-writes.
"""

from __future__ import annotations

import itertools
import sys
import time
import uuid
from dataclasses import dataclass, field

import numpy as np

__all__ = ["new_run_id", "TraceEvent", "MetricRegistry", "Timer", "percentile_summary"]

_counter = itertools.count()


def new_run_id(prefix: str = "run") -> str:
    """Unique run id propagated through producer → broker → processor."""
    return f"{prefix}-{next(_counter)}-{uuid.uuid4().hex[:8]}"


@dataclass(frozen=True, slots=True)
class TraceEvent:
    """One traced event, attributable to a run id."""

    run_id: str
    component: str
    kind: str
    ts: float
    attrs: dict = field(default_factory=dict)


class MetricRegistry:
    """Columnar event collector shared by producer, broker and engine."""

    def __init__(self) -> None:
        self._cols: dict[tuple[str, str, str], list[tuple[float, dict]]] = {}
        self._series: dict[str, list[tuple[float, float]]] = {}
        self._increments: dict[str, list[float]] = {}
        self._merged: list[dict[str, dict[str, list]]] = []   # workers' summaries

    def _column(self, run_id: str, component: str, kind: str) -> list:
        col = self._cols.get((run_id, component, kind))
        if col is None:
            # setdefault is atomic: racing first writers share one column
            col = self._cols.setdefault(
                (sys.intern(run_id), sys.intern(component), sys.intern(kind)), [])
        return col

    def record(self, run_id: str, component: str, kind: str, ts: float, **attrs) -> None:
        self._column(run_id, component, kind).append((ts, attrs))

    def emit(self, event: TraceEvent) -> None:
        self.record(event.run_id, event.component, event.kind, event.ts,
                    **event.attrs)

    def recorder(self, run_id: str, component: str, kind: str):
        """Pre-resolved ``rec(ts, **attrs)`` for one column (hot emitters)."""
        append = self._column(run_id, component, kind).append

        def rec(ts: float, **attrs) -> None:
            append((ts, attrs))

        return rec

    def events(self, run_id: str | None = None, component: str | None = None,
               kind: str | None = None) -> list[TraceEvent]:
        """Materialize matching events."""
        out = []
        for (rid, comp, knd), col in list(self._cols.items()):
            if run_id is not None and rid != run_id:
                continue
            if kind is not None and knd != kind:
                continue
            if component is not None and comp != component:
                continue
            out.extend(TraceEvent(rid, comp, knd, ts, attrs) for ts, attrs in list(col))
        return out

    def _kind_rows(self, run_id: str, kind: str) -> list[tuple[float, dict]]:
        rows: list[tuple[float, dict]] = []
        for (rid, _comp, knd), col in list(self._cols.items()):
            if rid == run_id and knd == kind:
                rows.extend(list(col))
        return rows

    # -- time series + counters ---------------------------------------------
    def observe(self, name: str, ts: float, value: float) -> None:
        self._series.setdefault(name, []).append((ts, value))

    def series(self, name: str) -> np.ndarray:
        return np.asarray(list(self._series.get(name, ())),
                          dtype=np.float64).reshape(-1, 2)

    def incr(self, name: str, amount: float = 1.0) -> None:
        self._increments.setdefault(name, []).append(amount)

    def counter(self, name: str) -> float:
        total = 0.0
        for amount in list(self._increments.get(name, ())):
            total += amount     # one by one: sum() compensates float sums
        return total

    # -- derived metrics -----------------------------------------------------
    def latencies(self, run_id: str, start_kind: str, end_kind: str,
                  key: str = "msg_id") -> np.ndarray:
        """Per-message latency between two event kinds, joined on attrs[key]
        (L^px = complete - append)."""
        start_rows = self._kind_rows(run_id, start_kind)
        end_rows = self._kind_rows(run_id, end_kind)
        starts = {attrs.get(key): ts for ts, attrs in start_rows}
        out = [ts - s for ts, attrs in end_rows
               if (s := starts.get(attrs.get(key))) is not None]
        return np.asarray(out, dtype=np.float64)

    def kind_count(self, run_id: str, kind: str) -> int:
        """Events of one kind recorded so far (O(columns))."""
        return sum(len(col) for (rid, _comp, knd), col in list(self._cols.items())
                   if rid == run_id and knd == kind)

    def kind_timestamps(self, run_id: str, kind: str) -> np.ndarray:
        """Sorted timestamps of one event kind (the throughput primitive)."""
        rows = self._kind_rows(run_id, kind)
        ts = np.fromiter((t for t, _ in rows), dtype=np.float64, count=len(rows))
        ts.sort()
        return ts

    def throughput(self, run_id: str, kind: str) -> float:
        """Events/sec of a given kind over the run's active window."""
        ts = self.kind_timestamps(run_id, kind)
        if ts.size < 2 or ts[-1] <= ts[0]:
            return 0.0
        return (ts.size - 1) / float(ts[-1] - ts[0])

    def steady_state_throughput(self, run_id: str, kind: str = "complete",
                                warmup_frac: float = 0.25) -> float:
        """Events/sec over the post-warmup window (max sustained throughput)."""
        ts = self.kind_timestamps(run_id, kind)
        if ts.size < 4:
            return 0.0
        window = ts[int(ts.size * warmup_frac):]
        span = float(window[-1] - window[0])
        if span <= 0:
            return 0.0
        return (window.size - 1) / span

    # -- compact cross-process trace channel ---------------------------------
    def export_summary(self) -> dict[str, dict[str, list]]:
        """``{run_id: {"component/kind": [count, t_min, t_max]}}`` — what a
        pooled sweep worker sends back instead of its event columns."""
        out: dict[str, dict[str, list]] = {}
        for (rid, comp, kind), col in list(self._cols.items()):
            rows = list(col)
            if not rows:
                continue
            ts = [t for t, _ in rows]
            out.setdefault(rid, {})[f"{comp}/{kind}"] = [len(rows), min(ts), max(ts)]
        return out

    def merge_summary(self, summary: dict[str, dict[str, list]]) -> None:
        """Merge a worker's ``export_summary`` into this registry (kept as
        it came; ``_merged_runs`` folds the summaries in arrival order)."""
        self._merged.append(summary)

    def _merged_runs(self) -> dict[str, dict[str, list]]:
        merged: dict[str, dict[str, list]] = {}
        for summary in list(self._merged):
            for rid, kinds in summary.items():
                dst = merged.setdefault(rid, {})
                for ck, (count, t_min, t_max) in kinds.items():
                    if ck in dst:
                        old = dst[ck]
                        dst[ck] = [old[0] + count, min(old[1], t_min), max(old[2], t_max)]
                    else:
                        dst[ck] = [count, t_min, t_max]
        return merged

    def trace_summary(self, run_id: str) -> dict[str, list]:
        """Per-(component/kind) ``[count, t_min, t_max]`` for one run, from
        the local columns or else from the merged worker summaries."""
        local = self.export_summary().get(run_id)
        if local:
            return local
        return dict(self._merged_runs().get(run_id, {}))

    def run_ids(self) -> list[str]:
        """All run ids this registry knows about (local or merged)."""
        return sorted({key[0] for key in list(self._cols)} | set(self._merged_runs()))


class Timer:
    """Context manager recording wall-clock duration into a registry series."""

    def __init__(self, registry: MetricRegistry, name: str, clock=None) -> None:
        self.registry = registry
        self.name = name
        self.clock = clock or time.perf_counter
        self.elapsed = 0.0

    def __enter__(self):
        self._t0 = self.clock()
        return self

    def __exit__(self, *exc):
        self.elapsed = self.clock() - self._t0
        self.registry.observe(self.name, self._t0, self.elapsed)
        return False


def percentile_summary(values) -> dict:
    values = np.asarray(values, dtype=np.float64)
    if values.size == 0:
        return {"count": 0}
    p50, p95, p99 = np.percentile(values, (50, 95, 99))
    return {
        "count": int(values.size),
        "mean": float(values.mean()),
        "std": float(values.std()),
        "p50": float(p50),
        "p95": float(p95),
        "p99": float(p99),
        "min": float(values.min()),
        "max": float(values.max()),
    }
