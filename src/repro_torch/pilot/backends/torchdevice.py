"""Torch device backend: a pilot is one torch device.

Counterpart of the reference's ``pilot/backends/jaxmesh.py``.  A pilot takes
``attrs["device"]`` (default ``"cuda"``; raises when no card is present).
Each compute-unit runs inline in ``submit``, in the submitting thread, with
the pilot's device current, and ends with a synchronize of the current
stream: the CU's end timestamp (and the engine's ``complete`` event) then
marks kernel completion, not kernel enqueue.

Execution is inline, so a CU is final when ``submit`` returns and nothing
here needs a lock or condition variable.
"""

from __future__ import annotations

import contextlib
import time

import torch

from repro_torch import resolve_device
from repro_torch.pilot.api import Backend, ComputeUnit, Pilot, State, register_backend

__all__ = ["TorchDeviceBackend"]


class TorchDeviceBackend(Backend):
    scheme = "torch"

    def __init__(self, **_kw) -> None:
        pass

    def start_pilot(self, pilot: Pilot) -> None:
        pilot.device = resolve_device(pilot.desc.attrs.get("device", "cuda"))
        pilot.state = State.RUNNING

    def submit(self, pilot: Pilot, cu: ComputeUnit) -> None:
        device = pilot.device
        cuda = device.type == "cuda"
        cu.submit_ts = time.perf_counter()
        cu._set_running(cu.submit_ts)
        try:
            with torch.cuda.device(device) if cuda else contextlib.nullcontext():
                out = cu.desc.func(*cu.desc.args, **cu.desc.kwargs) if cu.desc.func else None
                if cuda:
                    torch.cuda.current_stream().synchronize()
        except Exception as exc:  # noqa: BLE001 — the CU carries it; the engine retries
            cu._set_failed(time.perf_counter(), exc)
            return
        cu._set_done(time.perf_counter(), out)

    def drive_until(self, predicate, timeout) -> None:
        # CUs finish inside submit, in their submitter's thread; a predicate
        # still false here waits on another thread's inline execution
        deadline = None if timeout is None else time.perf_counter() + timeout
        while not predicate():
            if deadline is not None and time.perf_counter() >= deadline:
                raise TimeoutError("torch drive_until timed out")
            time.sleep(0.001)


register_backend("torch", TorchDeviceBackend)
