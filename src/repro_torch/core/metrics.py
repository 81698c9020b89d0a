"""Run-id tracing and metric collection (StreamInsight instrumentation layer).

Ports the lock-free columnar part of ``repro.core.metrics``: events append
to per-``(run_id, component, kind)`` columns of ``(ts, attrs)`` rows.
``record`` is one dict lookup plus one ``list.append`` (atomic under the
GIL), so the engine's consumer threads record without a lock; derived
queries (``latencies``, ``throughput``) read the columns with numpy.
"""

from __future__ import annotations

import itertools
import sys
import uuid
from dataclasses import dataclass, field

import numpy as np

__all__ = ["new_run_id", "TraceEvent", "MetricRegistry", "percentile_summary"]

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

    def _column(self, run_id: str, component: str, kind: str) -> list:
        col = self._cols.get((run_id, component, kind))
        if col is None:
            # setdefault is atomic: racing first writers share one column
            col = self._cols.setdefault(
                (sys.intern(run_id), sys.intern(component), sys.intern(kind)), [])
        return col

    def record(self, run_id: str, component: str, kind: str, ts: float, **attrs) -> None:
        self._column(run_id, component, kind).append((ts, attrs))

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

    def throughput(self, run_id: str, kind: str) -> float:
        """Events/sec of a given kind over the run's active window."""
        ts = np.sort(np.fromiter((t for t, _ in self._kind_rows(run_id, kind)),
                                 dtype=np.float64))
        if ts.size < 2 or ts[-1] <= ts[0]:
            return 0.0
        return (ts.size - 1) / float(ts[-1] - ts[0])


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
