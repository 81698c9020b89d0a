"""Local backend: real in-process execution on a thread pool (wall clock).

Ports ``repro.pilot.backends.local``.  Used by the wall-clock adaptation
path and integration tests; it is the "cloud VM / login node" analogue —
no simulation, callables actually run.

Elasticity: the pool's thread count is fixed at pilot start (the physical
ceiling, like a node's core count), but the *admitted* concurrency is a
capacity counter that ``scale_to`` moves live — tasks beyond the current
capacity queue on a condition variable until a slot frees or the capacity
grows.  Grants are immediate (``effective_allocation == allocation``): a
login node has no batch queue.  This is what lets the threaded streaming
engine's ``ControlLoop`` resize a wall-clock run the same way the simulated
backends resize virtual ones.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor

from repro_torch.pilot.api import Backend, ComputeUnit, Pilot, State, register_backend


__all__ = ["LocalBackend"]


class LocalBackend(Backend):
    scheme = "local"

    def __init__(self, **_kw) -> None:
        self._pools: dict[int, ThreadPoolExecutor] = {}
        self._caps: dict[int, dict] = {}   # uid -> {capacity, running, ceiling}
        self._cv = threading.Condition()  # simlint: allow[lock-site] — admission gate: many pool threads wait for a slot that scale_to/preempt/restore/finish move; leaf, no call out under it; kept for the reference gate; the port's manifest registers it

    def start_pilot(self, pilot: Pilot) -> None:
        workers = pilot.desc.concurrency or (
            pilot.desc.number_of_nodes * pilot.desc.cores_per_node)
        workers = max(1, workers)
        self._pools[pilot.uid] = ThreadPoolExecutor(max_workers=workers)
        self._caps[pilot.uid] = {"capacity": workers, "running": 0,
                                 "ceiling": workers,
                                 "revoked": 0,       # preempted worker slots
                                 "crash_next": 0}    # injected crash budget
        pilot.state = State.RUNNING

    # -- elasticity ----------------------------------------------------------
    def scale_to(self, pilot: Pilot, n: int) -> int:
        """Move the admitted concurrency, clamped to [1, pool size]."""
        with self._cv:
            st = self._caps[pilot.uid]
            st["capacity"] = max(1, min(int(n), st["ceiling"]))
            self._cv.notify_all()
            return st["capacity"]

    def allocation(self, pilot: Pilot) -> int:
        with self._cv:
            return self._caps[pilot.uid]["capacity"]

    def effective_allocation(self, pilot: Pilot) -> int:
        """Admitted slots actually available: capacity minus slots revoked
        by an in-force preemption (never below 1, so the pipeline can
        still drain)."""
        with self._cv:
            st = self._caps[pilot.uid]
            return max(1, st["capacity"] - st["revoked"])

    # -- fault surface ---------------------------------------------------------
    def inject_crash(self, pilot: Pilot, count: int = 1) -> int:
        """Fail the next ``count`` task executions with ``ConnectionError``
        — the wall-clock analogue of a worker crash killing the in-flight
        batch (the consumer's retry path re-submits)."""
        with self._cv:
            self._caps[pilot.uid]["crash_next"] += int(count)
        return int(count)

    def preempt(self, pilot: Pilot, count: int = 1) -> int:
        """Spot-style revocation of admitted worker slots: capacity drops
        by up to ``count`` (always keeping one slot) and returns after
        ``preempt_restore_s`` (pilot attrs, default 2 s) on a timer
        thread.  In-flight tasks finish — the wall-clock pool cannot kill
        a running thread, so revocation bites at the admission gate, which
        is the same queueing semantics the sim backends express."""
        with self._cv:
            st = self._caps[pilot.uid]
            take = max(0, min(int(count),
                              st["capacity"] - st["revoked"] - 1))
            st["revoked"] += take
            self._cv.notify_all()
        if take:
            restore_s = float(pilot.desc.attrs.get("preempt_restore_s", 2.0))
            t = threading.Timer(restore_s, self._restore, args=(pilot, take))
            t.daemon = True
            t.start()
        return take

    def _restore(self, pilot: Pilot, n: int) -> None:
        with self._cv:
            st = self._caps.get(pilot.uid)
            if st is None:
                return
            st["revoked"] = max(0, st["revoked"] - n)
            self._cv.notify_all()

    def submit(self, pilot: Pilot, cu: ComputeUnit) -> None:
        cu.submit_ts = time.perf_counter()
        cu.state = State.PENDING
        pool = self._pools[pilot.uid]
        st = self._caps[pilot.uid]

        def run() -> None:
            with self._cv:
                while st["running"] >= max(1, st["capacity"] - st["revoked"]) \
                        and not cu.state.is_final:
                    self._cv.wait(0.1)
                if cu.state.is_final:       # canceled while queued
                    return
                st["running"] += 1
                crash = st["crash_next"] > 0
                if crash:
                    st["crash_next"] -= 1
            try:
                cu._set_running(time.perf_counter())
                try:
                    if crash:
                        raise ConnectionError("worker crashed (injected)")
                    out = cu.desc.func(*cu.desc.args, **cu.desc.kwargs) if cu.desc.func else None
                    cu._set_done(time.perf_counter(), out)
                except BaseException as exc:  # noqa: BLE001 — report task failure
                    cu._set_failed(time.perf_counter(), exc)
            finally:
                with self._cv:
                    st["running"] -= 1
                    self._cv.notify_all()

        pool.submit(run)

    def cancel_pilot(self, pilot: Pilot) -> None:
        pool = self._pools.pop(pilot.uid, None)
        if pool is not None:
            pool.shutdown(wait=False, cancel_futures=True)
        now = time.perf_counter()
        for cu in pilot.compute_units:
            if not cu.state.is_final:
                cu._set_canceled(now)
        with self._cv:
            self._cv.notify_all()

    def drive_until(self, predicate, timeout) -> None:
        deadline = None if timeout is None else time.perf_counter() + timeout
        with self._cv:
            while not predicate():
                remaining = None if deadline is None else deadline - time.perf_counter()
                if remaining is not None and remaining <= 0:
                    raise TimeoutError("local backend drive_until timed out")
                self._cv.wait(timeout=remaining if remaining is not None else 0.2)

    def close(self) -> None:
        for pool in self._pools.values():
            pool.shutdown(wait=False, cancel_futures=True)
        with self._cv:
            self._cv.notify_all()


register_backend("local", LocalBackend)
