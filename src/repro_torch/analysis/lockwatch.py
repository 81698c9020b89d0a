"""Pass 2b — runtime lock-order instrumentation (opt-in shim).

Static extraction (``locks.py``) knows where locks are *born*; only a run
shows how they *nest*.  ``LockWatch.install()`` wraps the
``threading.Lock``/``RLock``/``Condition`` constructors so every lock
created afterwards is a tracked proxy.  While installed it records:

* the **acquisition graph** — a directed edge ``A → B`` whenever a thread
  acquires lock B while already holding lock A, keyed by the lock's
  *creation site* (file:line:scope), so all instances born at one site
  collapse into one node.  A cycle (the classic ABBA) is a deadlock the
  scheduler merely hasn't lost yet — the port's lockwatch test and
  ``chip_smoke.py``'s ``lockwatch`` phase fail on any;
* **waits-while-holding** — a ``Condition.wait`` (which ``Event.wait``
  reduces to) entered while the thread holds *other* tracked locks.
  Cross-component holds (e.g. waiting on an engine condition while
  holding the broker lock) stall every producer behind a consumer's
  sleep and are reported as ``cross_component_waits``.

The shim is deliberately constructor-time only: locks created before
``install()`` (module-level singletons, interpreter internals) stay
untracked — the target is the lock population a test run creates.

Everything here is wall-path tooling: the shim exists to *verify* the sim
contract, it never runs on the sim path itself.  It is installed in code
only, never from the environment: the test suite's conftest installs the
JAX package's shim from ``SIMLINT_LOCKWATCH_OUT``, so the two never wrap
``threading`` at once.
"""

from __future__ import annotations

import _thread
import json
import sys
import threading

__all__ = ["LockWatch"]

_COMPONENTS = (
    ("broker.py", "broker"),
    ("engine.py", "engine"),
    ("autoscale.py", "autoscale"),
    ("metrics.py", "metrics"),
    ("streaminsight.py", "streaminsight"),
    ("miniapp.py", "miniapp"),
    ("local.py", "backend.local"),
    ("torchdevice.py", "backend.torchdevice"),
)


def _component(site: str) -> str:
    path = site.split(":", 1)[0]
    for suffix, comp in _COMPONENTS:
        if path.endswith(suffix):
            return comp
    if "repro_torch/" in path.replace("\\", "/"):
        return "repro_torch.other"
    return "external"


def _creation_site() -> str:
    """file:line:function of the frame that called the lock constructor,
    skipping shim and threading internals."""
    f = sys._getframe(2)
    while f is not None:
        fn = f.f_code.co_filename
        if not (fn.endswith("lockwatch.py") or fn.endswith("threading.py")):
            short = fn
            for marker in ("/src/", "/tests/"):
                i = fn.rfind(marker)
                if i != -1:
                    short = fn[i + 1:]
                    break
            return f"{short}:{f.f_lineno}:{f.f_code.co_name}"
        f = f.f_back
    return "<unknown>"


class _TrackedLock:
    """Proxy around a raw lock, feeding the watch's per-thread held stack.

    Exposes the RLock protocol (``_is_owned``/``_release_save``/
    ``_acquire_restore``) when the inner lock does, so a tracked lock can
    serve as a ``Condition``'s lock transparently.
    """

    def __init__(self, watch: "LockWatch", inner, site: str) -> None:
        self._watch = watch
        self._inner = inner
        self.site = site

    def acquire(self, blocking: bool = True, timeout: float = -1):
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            self._watch._note_acquired(self)
        return ok

    __enter__ = acquire

    def release(self) -> None:
        self._inner.release()
        self._watch._note_released(self)

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        return self._inner.locked()

    # -- RLock protocol for Condition ---------------------------------------
    # Condition picks the RLock protocol whenever the lock exposes these
    # attributes; since the proxy always does, each must fall back to the
    # plain-lock behaviour (Condition's own defaults) when the inner lock
    # is a primitive Lock.
    def _is_owned(self):
        inner = self._inner
        if hasattr(inner, "_is_owned"):
            return inner._is_owned()
        if inner.acquire(False):
            inner.release()
            return False
        return True

    def _release_save(self):
        inner = self._inner
        if hasattr(inner, "_release_save"):
            state = inner._release_save()
        else:
            inner.release()
            state = None
        self._watch._note_released(self, all_holds=True)
        return state

    def _acquire_restore(self, state) -> None:
        inner = self._inner
        if hasattr(inner, "_acquire_restore"):
            inner._acquire_restore(state)
        else:
            inner.acquire()
        self._watch._note_acquired(self)

    def __getattr__(self, name):
        # pass through anything else the stdlib pokes at (_at_fork_reinit,
        # acquire_lock aliases, ...)
        return getattr(object.__getattribute__(self, "_inner"), name)

    def __repr__(self) -> str:
        return f"<TrackedLock {self.site}>"


class LockWatch:
    """Install/uninstall the shim; accumulate the acquisition graph."""

    def __init__(self) -> None:
        # raw allocate_lock: the graph lock itself must never be tracked
        # (it is only ever taken *after* a tracked acquire succeeds, so it
        # can introduce no ordering of its own)
        self._graph_lock = _thread.allocate_lock()
        self._tls = threading.local()
        self.edges: dict[str, set[str]] = {}
        self.sites: dict[str, str] = {}            # site -> kind
        self.waits: list[dict] = []                # wait-while-holding events
        self.acquisitions = 0
        self._installed = False
        self._saved: dict[str, object] = {}

    # -- per-thread held stack ----------------------------------------------
    def _held(self) -> list:
        held = getattr(self._tls, "held", None)
        if held is None:
            held = self._tls.held = []
        return held

    def _note_acquired(self, lock: _TrackedLock) -> None:
        held = self._held()
        if any(h is lock for h in held):     # reentrant re-acquire
            held.append(lock)
            return
        if held:
            with self._graph_lock:
                self.acquisitions += 1
                for h in {id(h): h for h in held}.values():
                    # same-site pairs (two instances born at one line) are
                    # skipped: a site-level self-edge would always read as
                    # a cycle, but the real ordering there is an
                    # instance-level question this graph can't decide
                    if h is not lock and h.site != lock.site:
                        self.edges.setdefault(h.site, set()).add(lock.site)
        else:
            with self._graph_lock:
                self.acquisitions += 1
        held.append(lock)

    def _note_released(self, lock: _TrackedLock, all_holds: bool = False)\
            -> None:
        held = self._held()
        for i in range(len(held) - 1, -1, -1):
            if held[i] is lock:
                del held[i]
                if not all_holds:
                    return

    def _note_wait(self, cond_lock, timeout) -> None:
        held = self._held()
        others = sorted({h.site for h in held if h is not cond_lock})
        if not others:
            return
        cond_site = getattr(cond_lock, "site", "<untracked>")
        with self._graph_lock:
            self.waits.append({
                "cond": cond_site,
                "held": others,
                "cross_component": [
                    s for s in others
                    if _component(s) != _component(cond_site)],
            })

    # -- install / uninstall -------------------------------------------------
    def install(self) -> "LockWatch":
        if self._installed:
            return self
        watch = self
        orig_lock, orig_rlock = threading.Lock, threading.RLock
        orig_cond = threading.Condition

        def make_lock():
            site = _creation_site()
            with watch._graph_lock:
                watch.sites.setdefault(site, "Lock")
            return _TrackedLock(watch, orig_lock(), site)

        def make_rlock():
            site = _creation_site()
            with watch._graph_lock:
                watch.sites.setdefault(site, "RLock")
            return _TrackedLock(watch, orig_rlock(), site)

        class TrackedCondition(orig_cond):
            def wait(self, timeout=None):
                watch._note_wait(self._lock, timeout)
                return super().wait(timeout)

        self._saved = {"Lock": orig_lock, "RLock": orig_rlock,
                       "Condition": orig_cond}
        threading.Lock = make_lock
        threading.RLock = make_rlock
        threading.Condition = TrackedCondition
        self._installed = True
        return self

    def uninstall(self) -> None:
        if not self._installed:
            return
        threading.Lock = self._saved["Lock"]
        threading.RLock = self._saved["RLock"]
        threading.Condition = self._saved["Condition"]
        self._installed = False

    # -- analysis -------------------------------------------------------------
    def cycles(self) -> list[list[str]]:
        """Cycles in the site-level acquisition graph (DFS, each reported
        once from its smallest node)."""
        found: list[list[str]] = []
        seen_cycles: set[tuple[str, ...]] = set()
        edges = {a: sorted(bs) for a, bs in self.edges.items()}

        def dfs(node: str, stack: list[str], on_stack: set[str]) -> None:
            for nxt in edges.get(node, ()):
                if nxt in on_stack:
                    cyc = stack[stack.index(nxt):] + [nxt]
                    lo = min(range(len(cyc) - 1), key=lambda i: cyc[i])
                    key = tuple(cyc[lo:-1] + cyc[:lo])
                    if key not in seen_cycles:
                        seen_cycles.add(key)
                        found.append(cyc)
                elif nxt not in visited:
                    visited.add(nxt)
                    stack.append(nxt)
                    on_stack.add(nxt)
                    dfs(nxt, stack, on_stack)
                    on_stack.discard(nxt)
                    stack.pop()

        visited: set[str] = set()
        for start in sorted(edges):
            if start not in visited:
                visited.add(start)
                dfs(start, [start], {start})
        return found

    def cross_component_waits(self) -> list[dict]:
        return [w for w in self.waits if w["cross_component"]]

    def report(self) -> dict:
        return {
            "sites": dict(sorted(self.sites.items())),
            "edges": {a: sorted(bs)
                      for a, bs in sorted(self.edges.items())},
            "acquisitions": self.acquisitions,
            "cycles": self.cycles(),
            "waits_while_holding": self.waits,
            "cross_component_waits": self.cross_component_waits(),
        }

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.report(), f, indent=1, sort_keys=True)

