"""The Pilot-API: unified resource management (paper §III).

Ports ``repro.pilot.api``.  A *pilot* is a user-defined set of resources,
requested with a normative ``PilotDescription``; *compute-units* are
self-contained tasks submitted to a running pilot.  Backends are plugins
keyed by the URL scheme of ``PilotDescription.resource``; this package
provides

    torch://            a device pilot: compute-units run on one torch device
    serverless://       AWS Lambda + Kinesis mechanism simulation (virtual clock)
    hpc://<machine>     Kafka + Dask on HPC mechanism simulation (virtual clock)

``PilotComputeService(**kw)`` hands its keyword arguments (``seed``,
``sim``) to every backend it creates.  Done-callbacks fire exactly once per
unit, also when one is added from another thread while the unit finishes:
each callback is taken off the unit's list by one atomic ``list`` operation,
either by the finishing side or by the adding side, and whoever takes it
runs it — no lock.
"""

from __future__ import annotations

import enum
import threading
from dataclasses import dataclass, field
from typing import Any, Callable

__all__ = [
    "State",
    "TaskProfile",
    "PilotDescription",
    "ComputeUnitDescription",
    "ComputeUnit",
    "Pilot",
    "Backend",
    "PilotComputeService",
    "register_backend",
]


class State(enum.Enum):
    NEW = "new"
    PENDING = "pending"
    RUNNING = "running"
    DONE = "done"
    FAILED = "failed"
    CANCELED = "canceled"

    @property
    def is_final(self) -> bool:
        return self in _FINAL_STATES


_FINAL_STATES = frozenset((State.DONE, State.FAILED, State.CANCELED))


@dataclass(frozen=True)
class TaskProfile:
    """Mechanism-level cost profile of a compute-unit (read by simulated
    backends to derive service times; ignored by real-execution backends).
    Fields as in the reference: distance-phase ``flops``, shared-model
    ``serial_flops``, shared-state ``read_bytes``/``write_bytes``, the
    triggering message's ``msg_bytes``, ``coherence_peers`` and the working
    set ``memory_mb``."""

    flops: float = 0.0
    serial_flops: float = 0.0
    read_bytes: float = 0.0
    write_bytes: float = 0.0
    msg_bytes: float = 0.0
    coherence_peers: int = 0
    memory_mb: float = 64.0


@dataclass
class PilotDescription:
    """Normative resource request; backend-specific details go in ``attrs``
    (``torch://`` reads ``attrs["device"]``)."""

    resource: str = "torch://"
    number_of_nodes: int = 1
    cores_per_node: int = 1
    memory_mb: int = 3008
    concurrency: int | None = None
    walltime_s: float = 900.0
    partitions: int = 1
    attrs: dict = field(default_factory=dict)

    @property
    def scheme(self) -> str:
        return self.resource.split("://", 1)[0]


@dataclass(slots=True)
class ComputeUnitDescription:
    """A self-contained task: a real callable and/or a cost profile."""

    func: Callable[..., Any] | None = None
    args: tuple = ()
    kwargs: dict = field(default_factory=dict)
    profile: TaskProfile | None = None
    name: str = "cu"
    run_id: str | None = None
    partition: int | None = None   # streaming mode: broker partition binding


class ComputeUnit:
    """Handle for a submitted task."""

    __slots__ = ("desc", "uid", "pilot", "state", "result_value", "exception",
                 "submit_ts", "start_ts", "end_ts", "_done", "callbacks", "attrs")

    def __init__(self, desc: ComputeUnitDescription, uid: int, pilot: "Pilot") -> None:
        self.desc = desc
        self.uid = uid
        self.pilot = pilot
        self.state = State.NEW
        self.result_value: Any = None
        self.exception: BaseException | None = None
        self.submit_ts = 0.0
        self.start_ts = 0.0
        self.end_ts = 0.0
        self._done: threading.Event | None = None   # created on first access
        self.callbacks: list = []   # fn(cu) invoked once, on any final state
        self.attrs: dict = {}       # backend-set placement info (container/worker)

    @property
    def done_event(self) -> threading.Event:
        """Event set on any final state (created on first access)."""
        if self._done is None:
            self._done = threading.Event()
            if self.state.is_final:
                self._done.set()
        return self._done

    def add_done_callback(self, fn) -> None:
        """Run ``fn(cu)`` once the unit is final (at once if it already is)."""
        if not self.state.is_final:
            self.callbacks.append(fn)
            if not self.state.is_final:
                return
            # final meanwhile: the finisher may have taken fn already
            try:
                self.callbacks.remove(fn)
            except ValueError:
                return
        fn(self)

    def _fire_callbacks(self) -> None:
        while True:
            try:
                fn = self.callbacks.pop(0)
            except IndexError:
                return
            fn(self)

    def _finish(self, state: State, ts: float) -> None:
        self.state = state
        self.end_ts = ts
        if self._done is not None:
            self._done.set()
        self._fire_callbacks()

    # -- lifecycle (driven by the backend) ----------------------------------
    def _set_running(self, ts: float) -> None:
        self.state = State.RUNNING
        self.start_ts = ts

    def _set_done(self, ts: float, result: Any) -> None:
        self.result_value = result
        self._finish(State.DONE, ts)

    def _set_failed(self, ts: float, exc: BaseException) -> None:
        self.exception = exc
        self._finish(State.FAILED, ts)

    def _set_canceled(self, ts: float) -> None:
        self._finish(State.CANCELED, ts)

    # -- user API ------------------------------------------------------------
    def wait(self, timeout: float | None = None) -> "ComputeUnit":
        self.pilot.backend.drive_until(lambda: self.state.is_final, timeout)
        return self

    def result(self, timeout: float | None = None) -> Any:
        self.wait(timeout)
        if self.state == State.FAILED:
            raise self.exception
        if self.state == State.CANCELED:
            raise RuntimeError(f"compute unit {self.uid} canceled")
        return self.result_value

    @property
    def runtime(self) -> float:
        return self.end_ts - self.start_ts

    @property
    def wait_time(self) -> float:
        return self.start_ts - self.submit_ts


class Pilot:
    """A resource container on some backend."""

    def __init__(self, desc: PilotDescription, backend: "Backend", uid: int) -> None:
        self.desc = desc
        self.backend = backend
        self.uid = uid
        self.state = State.PENDING
        self._cu_uid = 0
        self.compute_units: list[ComputeUnit] = []

    def submit_compute_unit(self, desc: ComputeUnitDescription | None = None, **kw) -> ComputeUnit:
        if desc is None:
            desc = ComputeUnitDescription(**kw)
        if self.state.is_final:
            raise RuntimeError(f"pilot {self.uid} is {self.state}")
        cu = ComputeUnit(desc, self._cu_uid, self)
        self._cu_uid += 1
        self.compute_units.append(cu)
        self.backend.submit(self, cu)
        return cu

    def wait_all(self, timeout: float | None = None) -> None:
        self.backend.drive_until(
            lambda: all(cu.state.is_final for cu in self.compute_units), timeout)

    def cancel(self) -> None:
        self.backend.cancel_pilot(self)
        self.state = State.CANCELED


class Backend:
    """Backend plugin interface."""

    scheme = "abstract"

    def start_pilot(self, pilot: Pilot) -> None:
        raise NotImplementedError

    def submit(self, pilot: Pilot, cu: ComputeUnit) -> None:
        raise NotImplementedError

    def shared_resource(self, pilot: Pilot, name: str):
        """A pilot's named shared resource (the HPC backend's ``"fs"``
        Lustre ``SharedResource`` or ``"model_lock"``).  Backends without
        shared infrastructure raise ``LookupError``: serverless containers
        are isolated by construction."""
        raise LookupError(
            f"backend {self.scheme!r} exposes no shared resource {name!r}")

    # -- elasticity ------------------------------------------------------------
    def scale_to(self, pilot: Pilot, n: int) -> int:
        """Grow or shrink the pilot's execution capacity to ``n`` units
        mid-run; returns the granted target.  Static backends raise."""
        raise NotImplementedError(f"backend {self.scheme!r} is not elastic")

    def allocation(self, pilot: Pilot) -> int:
        """Current target capacity (execution units) of the pilot."""
        raise NotImplementedError(f"backend {self.scheme!r} is not elastic")

    def effective_allocation(self, pilot: Pilot) -> int:
        """Capacity granted right now, which can trail the target (HPC
        grants wait out the batch queue).  Defaults to ``allocation``."""
        return self.allocation(pilot)

    # -- fault surface (driven by streaming.faults.FaultInjector) -------------
    def inject_crash(self, pilot: Pilot, count: int = 1) -> int:
        """Crash up to ``count`` execution units; in-flight work fails with
        ``ConnectionError``.  Returns the units crashed (0 here)."""
        return 0

    def preempt(self, pilot: Pilot, count: int = 1) -> int:
        """Revoke up to ``count`` units of granted capacity (spot
        preemption).  Returns the units revoked (0 here)."""
        return 0

    def cancel_pilot(self, pilot: Pilot) -> None:
        pass

    def drive_until(self, predicate: Callable[[], bool], timeout: float | None) -> None:
        """Advance execution until ``predicate`` holds."""
        raise NotImplementedError

    def close(self) -> None:
        pass


_BACKENDS: dict[str, Callable[..., Backend]] = {}


def register_backend(scheme: str, factory: Callable[..., Backend]) -> None:
    _BACKENDS[scheme] = factory


class PilotComputeService:
    """Entry point (the paper's Pilot-Manager): routes PilotDescriptions to
    backend plugins and tracks live pilots."""

    def __init__(self, **backend_kwargs) -> None:
        self._pilot_uid = 0
        self.pilots: list[Pilot] = []
        self._backends: dict[str, Backend] = {}
        self._backend_kwargs = backend_kwargs

    def _backend(self, scheme: str) -> Backend:
        if scheme not in self._backends:
            if scheme not in _BACKENDS:
                # late registration: import built-in plugins on demand
                from repro_torch.pilot import backends as _b  # noqa: F401
            if scheme not in _BACKENDS:
                raise ValueError(f"no backend registered for scheme '{scheme}'; "
                                 f"known: {sorted(_BACKENDS)}")
            self._backends[scheme] = _BACKENDS[scheme](**self._backend_kwargs)
        return self._backends[scheme]

    def submit_pilot(self, desc: PilotDescription) -> Pilot:
        backend = self._backend(desc.scheme)
        pilot = Pilot(desc, backend, self._pilot_uid)
        self._pilot_uid += 1
        backend.start_pilot(pilot)
        self.pilots.append(pilot)
        return pilot

    def close(self) -> None:
        for b in self._backends.values():
            b.close()
