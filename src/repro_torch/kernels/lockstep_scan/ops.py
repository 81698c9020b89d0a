"""Public wrappers for the lockstep seed scans.

Dispatch is by the tensors' device: CPU tensors run the plain versions in
``ref.py``; CUDA tensors launch the hand-written kernels in
``csrc/lockstep_scan.cu`` on the current stream, or raise.  There is no
fallback from one to the other.  ``LAUNCHES`` counts the calls that launch
a kernel, one per call.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.lockstep_scan.ref import grid_lockstep_scan_ref, lockstep_scan_ref

__all__ = ["lockstep_scan", "grid_lockstep_scan", "LAUNCHES"]

LAUNCHES = {"lockstep_scan": 0, "grid_lockstep_scan": 0}

_lib: ctypes.CDLL | None = None


def _kernels() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.library("lockstep_scan")
        ptr, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.lockstep_chain.argtypes = [ptr, ptr, ptr, f, f, ptr, i, i, i, ptr]
        lib.lockstep_chain.restype = i
        lib.grid_lockstep.argtypes = [ptr] * 5 + [i] * 5 + [ptr]
        lib.grid_lockstep.restype = i
        _lib = lib
    return _lib


def _check(named: dict, shapes: dict, dtypes: dict) -> torch.device:
    for name, t in named.items():
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shapes[name]}")
        if t.dtype != dtypes.get(name, torch.float32):
            raise TypeError(f"{name} is {t.dtype}, expected {dtypes.get(name, torch.float32)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    devices = {t.device for t in named.values()}
    if len(devices) != 1:
        raise ValueError(f"operands on {sorted(str(d) for d in devices)}")
    dev = devices.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for tensors on {dev}")
    return dev


def lockstep_scan(appends: torch.Tensor, means: torch.Tensor, z: torch.Tensor,
                  a: float, b: float) -> torch.Tensor:
    """appends (n,), means (n,), z (S, n): float32, contiguous, on one device.
    Returns the finishes (S, n), float32: per seed row, ``finish =
    max(appends[i], finish) + means[i] * exp(a + b * z[i])`` from 0."""
    if z.dim() != 2:
        raise ValueError(f"expected z (S, n), got {tuple(z.shape)}")
    S, n = z.shape
    dev = _check({"appends": appends, "means": means, "z": z},
                 {"appends": (n,), "means": (n,), "z": (S, n)}, {})
    if dev.type == "cpu":
        return lockstep_scan_ref(appends, means, z, a, b)
    out = torch.empty_like(z)
    if S == 0:
        return out
    err = _kernels().lockstep_chain(
        appends.data_ptr(), means.data_ptr(), z.data_ptr(), a, b, out.data_ptr(), S, n,
        dev.index, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"lockstep_scan kernel launch failed: cudaError_t {err}")
    LAUNCHES["lockstep_scan"] += 1
    return out


def grid_lockstep_scan(floors: torch.Tensor, parts: torch.Tensor, conts: torch.Tensor,
                       dt: torch.Tensor, n_parts: int, n_conts: int) -> torch.Tensor:
    """floors (n,) float32, parts and conts (n,) int32 in [0, n_parts) and
    [0, n_conts), dt (S, n) float32; contiguous, on one device.  Returns the
    finishes (S, n), float32 (see ``ref.grid_lockstep_scan_ref``).  On the
    card an index out of range makes that step's finish NaN; the plain
    version raises."""
    if dt.dim() != 2:
        raise ValueError(f"expected dt (S, n), got {tuple(dt.shape)}")
    if n_parts <= 0 or n_conts <= 0:
        raise ValueError(f"n_parts={n_parts} and n_conts={n_conts} must be positive")
    S, n = dt.shape
    dev = _check({"floors": floors, "parts": parts, "conts": conts, "dt": dt},
                 {"floors": (n,), "parts": (n,), "conts": (n,), "dt": (S, n)},
                 {"parts": torch.int32, "conts": torch.int32})
    if dev.type == "cpu":
        return grid_lockstep_scan_ref(floors, parts, conts, dt, n_parts, n_conts)
    out = torch.empty_like(dt)
    if S == 0:
        return out
    err = _kernels().grid_lockstep(
        floors.data_ptr(), parts.data_ptr(), conts.data_ptr(), dt.data_ptr(), out.data_ptr(),
        S, n, n_parts, n_conts, dev.index, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"grid_lockstep_scan kernel launch failed: cudaError_t {err}")
    LAUNCHES["grid_lockstep_scan"] += 1
    return out
