"""Public wrappers for the K-Means distance kernels.

Ports ``repro.kernels.kmeans_distance.ops``.  Dispatch is by the tensors'
device: CPU tensors run the plain versions in ``ref.py``; CUDA tensors
launch the hand-written kernels in ``csrc/kmeans_distance.cu`` on the
current stream, or raise.  There is no fallback from one to the other.

The kernels mask ragged n, k and d themselves, so nothing is padded here.
``LAUNCHES`` counts kernel launches per wrapper, so a run can show that its
main path went through the kernels.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.kmeans_distance.ref import assign_ref, pairwise_sq_dists_ref

__all__ = ["pairwise_sq_dists", "assign", "LAUNCHES"]

LAUNCHES = {"pairwise_sq_dists": 0, "assign": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_ROW_TILES = 65535          # K1's grid.y limit, in 64-row tiles
_lib: ctypes.CDLL | None = None


def _kernels() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.library("kmeans_distance")
        ptr, i = ctypes.c_void_p, ctypes.c_int
        lib.kd_pairwise_sq_dists.argtypes = [ptr, ptr, ptr, i, i, i, i, i, ptr]
        lib.kd_pairwise_sq_dists.restype = ctypes.c_int
        lib.kd_assign.argtypes = [ptr, ptr, ptr, ptr, i, i, i, i, i, ptr]
        lib.kd_assign.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(x: torch.Tensor, c: torch.Tensor) -> None:
    if x.dim() != 2 or c.dim() != 2 or x.shape[1] != c.shape[1] or x.shape[1] == 0:
        raise ValueError(f"expected x (n, d) and c (k, d) with d > 0, got {tuple(x.shape)} "
                         f"and {tuple(c.shape)}")
    if x.dtype not in _DTYPE_CODES or c.dtype != x.dtype:
        raise TypeError(f"expected float32 or bfloat16 inputs of one dtype, got "
                        f"{x.dtype} and {c.dtype}")
    if x.device != c.device:
        raise ValueError(f"x on {x.device} but c on {c.device}")


def _check_cuda(x: torch.Tensor, c: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for tensors on {x.device}")
    if not (x.is_contiguous() and c.is_contiguous()):
        raise ValueError("the kernels take contiguous row-major x and c")
    n, d = x.shape
    k = c.shape[0]
    if n == 0 or k == 0:
        raise ValueError(f"empty input: n={n}, k={k}")
    if (n + 63) // 64 > _MAX_ROW_TILES or max(k, d) >= 2 ** 31:
        raise ValueError(f"n={n}, k={k} exceed the kernel's grid")


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err}")


def pairwise_sq_dists(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """(n, d), (k, d) -> (n, k) float32 squared Euclidean distances."""
    _check(x, c)
    if x.device.type == "cpu":
        return pairwise_sq_dists_ref(x, c)
    _check_cuda(x, c)
    n, d = x.shape
    k = c.shape[0]
    out = torch.empty((n, k), dtype=torch.float32, device=x.device)
    err = _kernels().kd_pairwise_sq_dists(
        x.data_ptr(), c.data_ptr(), out.data_ptr(), n, k, d,
        _DTYPE_CODES[x.dtype], x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(err, "pairwise_sq_dists")
    LAUNCHES["pairwise_sq_dists"] += 1
    return out


def assign(x: torch.Tensor, c: torch.Tensor):
    """Fused assignment -> (labels (n,) int32, best_sq_dist (n,) float32);
    never materialises the (n, k) matrix on the card."""
    _check(x, c)
    if x.device.type == "cpu":
        return assign_ref(x, c)
    _check_cuda(x, c)
    n, d = x.shape
    k = c.shape[0]
    labels = torch.empty((n,), dtype=torch.int32, device=x.device)
    best = torch.empty((n,), dtype=torch.float32, device=x.device)
    err = _kernels().kd_assign(
        x.data_ptr(), c.data_ptr(), labels.data_ptr(), best.data_ptr(), n, k, d,
        _DTYPE_CODES[x.dtype], x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(err, "assign")
    LAUNCHES["assign"] += 1
    return labels, best
