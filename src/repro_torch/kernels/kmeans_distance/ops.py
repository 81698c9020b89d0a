"""Public wrappers for the K-Means distance kernels.

Ports ``repro.kernels.kmeans_distance.ops``.  Dispatch is by the tensors'
device: CPU tensors run the plain versions in ``ref.py``; CUDA tensors
launch the hand-written kernels in ``csrc/kmeans_distance.cu`` on the
current stream, or raise.  There is no fallback from one to the other.

The kernels mask ragged n, k and d themselves, so nothing is padded here.
``assign`` cuts k into slices (``slice_width``) so that its grid fills the
card, allocates the slices' scratch with ``torch.empty`` and combines them in
slice order on the card (one call of the C entry point, one or two CUDA
kernels).  ``LAUNCHES`` counts wrapper calls that launched their kernels, so
a run can show that its main path went through them.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.kmeans_distance.ref import assign_ref, pairwise_sq_dists_ref

__all__ = ["pairwise_sq_dists", "assign", "slice_width", "assign_slice_width", "LAUNCHES"]

LAUNCHES = {"pairwise_sq_dists": 0, "assign": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the constants of csrc/kmeans_distance.cu that the grids below depend on
MAX_REG_DIM = 16                # d up to this takes the register design
REG_ROWS, TILE_ROWS = 512, 32  # K2's rows per block: register design, general design
KS_MAX = 512                    # centroids a register-design slice stages
PANEL = 64                      # centroids per step of the general design
_MAX_GRID_Y = 65535             # K1's row tiles (general design), K2's slices
_lib: ctypes.CDLL | None = None


def _kernels() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.library("kmeans_distance")
        ptr, i = ctypes.c_void_p, ctypes.c_int
        lib.kd_pairwise_sq_dists.argtypes = [ptr, ptr, ptr, i, i, i, i, i, ptr]
        lib.kd_pairwise_sq_dists.restype = ctypes.c_int
        lib.kd_assign.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, i, i, i, i, i, i, ptr]
        lib.kd_assign.restype = ctypes.c_int
        lib.kd_assign_slots.argtypes = [i, i, i, ctypes.POINTER(i)]
        lib.kd_assign_slots.restype = ctypes.c_int
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
    if max(n, k, d) >= 2 ** 31 or (d > MAX_REG_DIM and -(-n // 64) > _MAX_GRID_Y):
        raise ValueError(f"n={n}, k={k}, d={d} exceed the kernels' grids")


def slice_width(n: int, k: int, d: int, slots: int) -> int:
    """Centroids per k-slice of K2 for an (n, d) x (k, d) call on a card
    that holds ``slots`` of its blocks at once.

    The grid is (row tiles) x (slices).  Enough slices to fill the resident
    blocks about once (the fewest waves that the register design's
    ``KS_MAX`` allows), each of an equal share of k; the general design's
    slices are whole 64-centroid panels."""
    reg = d <= MAX_REG_DIM
    tiles = -(-n // (REG_ROWS if reg else TILE_ROWS))
    least = -(-k // KS_MAX) if reg else 1
    waves = -(-tiles * least // max(1, slots))
    slices = max(least, min(k, waves * max(1, slots) // tiles))
    width = -(-k // slices)
    return width if reg else -(-width // PANEL) * PANEL


@functools.lru_cache(maxsize=256)
def assign_slice_width(n: int, k: int, d: int, dtype: torch.dtype, device_index: int) -> int:
    """The slice width ``assign`` takes for x (n, d), c (k, d) of ``dtype``
    on card ``device_index``: ``slice_width`` at the card's resident blocks
    of K2's slice kernel (the CUDA occupancy query)."""
    slots = ctypes.c_int(0)
    err = _kernels().kd_assign_slots(d, _DTYPE_CODES[dtype], device_index, ctypes.byref(slots))
    _raise_on(err, "assign occupancy query")
    width = slice_width(n, k, d, slots.value)
    if -(-k // width) > _MAX_GRID_Y:
        raise ValueError(f"n={n}, k={k} need more k-slices than the kernel's grid has")
    return width


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
    never materialises the (n, k) matrix on the card.  Bit-equal to
    ``assign_ref`` in float32, ties to the smallest index."""
    _check(x, c)
    if x.device.type == "cpu":
        return assign_ref(x, c)
    _check_cuda(x, c)
    n, d = x.shape
    k = c.shape[0]
    width = assign_slice_width(n, k, d, x.dtype, x.device.index)
    slices = -(-k // width)
    # one allocation: labels, best and, with more than one slice, the
    # slices' labels and best distances, (slices, n) each
    buf = torch.empty(((2 + 2 * slices if slices > 1 else 2), n), dtype=torch.int32,
                      device=x.device)
    at = buf.data_ptr()
    part = (at + 8 * n, at + 8 * n + 4 * slices * n) if slices > 1 else (None, None)
    err = _kernels().kd_assign(
        x.data_ptr(), c.data_ptr(), at, at + 4 * n, *part, n, k, d, width,
        _DTYPE_CODES[x.dtype], x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(err, "assign")
    LAUNCHES["assign"] += 1
    return buf[0], buf[1].view(torch.float32)
