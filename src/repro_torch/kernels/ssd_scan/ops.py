"""Public wrapper for the SSD chunked-scan kernel (K4).

Ports ``repro.kernels.ssd_scan.ops``.  The wrapper keeps the model layout:
x (B, S, H, P), dt (B, S, H), A (H,), Bm and Cm (B, S, N), and an optional
initial state h0 (B, H, P, N); it returns y (B, S, H, P) and the final
state (B, H, P, N), both float32.  Dispatch is by the tensors' device: CPU
tensors run the plain chunked SSD ``models.ssm.ssd_chunked`` (the
reference wrapper's own fallback); CUDA tensors launch the hand-written
kernel in ``csrc/ssd_scan.cu`` on the current stream, or raise.  There is
no fallback from one to the other.

The kernels read the model layout themselves, so the reference's two
``moveaxis`` copies to a head-major layout are gone.  Their chunk length is
their own (64); ``chunk`` only keeps the reference's contract that
``min(chunk, S)`` divides S.  One call launches three CUDA kernels (span-local
states with C Bᵀ per chunk beside them, state passing across spans, output;
see the source's note) on scratch this wrapper allocates.  ``LAUNCHES`` counts
calls that launch them, one per call (CPython's GIL keeps the single
``+=`` whole across the serving path's consumer threads).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

__all__ = ["ssd_scan", "chunk_length", "smem_bytes", "LAUNCHES", "MAX_STATE", "PHASES"]

LAUNCHES = {"ssd_scan": 0}
MAX_STATE = 256                 # the kernels' largest N (shared memory)
PHASES = ("state", "pass", "out")     # the CUDA kernels of one call, in order
Q = 64                          # the kernels' chunk length
SPAN = 4                        # the kernels' chunks per span

_lib: ctypes.CDLL | None = None


def _kernels() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.library("ssd_scan")
        ptr, i = ctypes.c_void_p, ctypes.c_int
        lib.ssd_forward.argtypes = [ptr] * 11 + [i] * 6 + [ptr]
        lib.ssd_forward.restype = ctypes.c_int
        lib.ssd_smem_bytes.argtypes = [i, i]
        lib.ssd_smem_bytes.restype = ctypes.c_int
        _lib = lib
    return _lib


def chunk_length(S: int, chunk: int) -> int:
    """``min(chunk, S)``; raises unless it divides S, as the reference's
    ``ssd_chunked`` and ``ssd_scan_pallas`` assert."""
    Q = min(chunk, S)
    if Q <= 0 or S % Q:
        raise ValueError(f"sequence length {S} is not a multiple of the chunk "
                         f"min({chunk}, {S}) = {Q}")
    return Q


def _check(x, dt, A, Bm, Cm, h0, chunk) -> None:
    if x.dim() != 4:
        raise ValueError(f"expected x (B, S, H, P), got {tuple(x.shape)}")
    B, S, H, P = x.shape
    N = Bm.shape[-1] if Bm.dim() == 3 else -1
    want = {"dt": (B, S, H), "A": (H,), "Bm": (B, S, N), "Cm": (B, S, N)}
    if h0 is not None:
        want["h0"] = (B, H, P, N)
    named = {"x": x, "dt": dt, "A": A, "Bm": Bm, "Cm": Cm, "h0": h0}
    for name, shape in want.items():
        if tuple(named[name].shape) != shape:
            raise ValueError(f"{name} has shape {tuple(named[name].shape)}, expected "
                             f"{shape} for x {tuple(x.shape)}")
    if min(B, S, H, P, N) <= 0:
        raise ValueError(f"empty operand: x {tuple(x.shape)}, N = {N}")
    if N > MAX_STATE:
        raise ValueError(f"N={N} exceeds the kernel's {MAX_STATE}")
    tensors = [t for t in named.values() if t is not None]
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"expected float32 operands, got "
                        f"{[str(t.dtype) for t in tensors]}")
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"operands on {sorted({str(t.device) for t in tensors})}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the kernel takes contiguous operands in the model layout")
    chunk_length(S, chunk)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
             Cm: torch.Tensor, *, chunk: int, h0: torch.Tensor | None = None):
    """x (B, S, H, P); dt (B, S, H); A (H,); Bm, Cm (B, S, N); h0 (B, H, P, N)
    or None (zeros); float32 and contiguous.  Returns (y (B, S, H, P),
    h_final (B, H, P, N)), float32."""
    _check(x, dt, A, Bm, Cm, h0, chunk)
    if x.device.type == "cpu":
        from repro_torch.models.ssm import ssd_chunked
        y, h = ssd_chunked(x, dt, A, Bm, Cm, chunk, h0)
        return y, h.contiguous()        # as the kernel returns it
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for tensors on {x.device}")
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    n_chunks = -(-S // Q)
    n_spans = -(-n_chunks // SPAN)
    y = torch.empty_like(x)
    h = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
    cbt = torch.empty((B, n_chunks, Q, Q), dtype=torch.float32, device=x.device)
    states = torch.empty((B * H, n_spans, P, N), dtype=torch.float32, device=x.device)
    logdec = torch.empty((B * H, n_spans), dtype=torch.float32, device=x.device)
    err = _kernels().ssd_forward(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
        None if h0 is None else h0.data_ptr(), y.data_ptr(), h.data_ptr(), cbt.data_ptr(),
        states.data_ptr(), logdec.data_ptr(), B, S, H, P, N, x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: cudaError_t {err}")
    LAUNCHES["ssd_scan"] += 1
    return y, h


def smem_bytes(n: int) -> dict[str, int]:
    """Dynamic shared memory of one block of each phase at state size ``n``,
    in bytes (as the kernels' source computes it)."""
    return {name: _kernels().ssd_smem_bytes(i, n) for i, name in enumerate(PHASES)}
