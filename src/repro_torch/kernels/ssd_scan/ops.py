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

Training: where grad mode is on and an input requires grad, a CUDA call
goes through ``_SSDScan``, a ``torch.autograd.Function``.  Its forward
launches the same three kernels and keeps their span-states scratch (the
state entering each span of SPAN chunks, which the pass kernel writes there
anyway), counted in ``STATES_KEPT``; its backward launches the three
kernels of ``csrc/ssd_scan_bwd.cu`` (``ssd_scan_bwd``), counted once a call
in ``LAUNCHES["ssd_scan_bwd"]``, and takes ``None`` for either cotangent.
Otherwise (serving, or ``torch.no_grad``) the scratch is dropped and
nothing is saved, as before.  Under ``models.transformer``'s remat
(``cfg.remat`` ``"full"`` or ``"dots"``) a checkpointed layer's forward
runs again in the backward: the recompute is a launch like the first, in
``LAUNCHES`` and ``STATES_KEPT``, so such a layer launches the forward
twice a microbatch and the backward once.  The kernels have no atomics, so
the recomputed y and span states are the first forward's bits, saved with
the same shapes, dtypes and device; every output and scratch is allocated
fresh, never a tensor the selective policy keeps.  On the CPU, autograd
differentiates ``ssd_chunked``.

Meta tensors take a shape-only path, and only inside the dry run's count
(a ``roofline.counter.CostCounter`` on the dispatch-mode stack; elsewhere
they raise as any other device does): the forward, the Function and the
backward run every check the kernels run, launch nothing, return meta
outputs of the kernels' shapes (y, the final state, the span states; the
six gradients), and add their work (``roofline.kernels``) to the counter,
which counts the calls by name.  ``LAUNCHES`` and ``STATES_KEPT`` stay
untouched.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.roofline.counter import active, shape_only
from repro_torch.roofline.kernels import ssd_scan_bwd_work, ssd_scan_work

__all__ = ["ssd_scan", "ssd_scan_bwd", "chunk_length", "smem_bytes", "LAUNCHES",
           "STATES_KEPT", "MAX_STATE", "PHASES", "BWD_PHASES"]

LAUNCHES = {"ssd_scan": 0, "ssd_scan_bwd": 0}
STATES_KEPT = {"ssd_scan": 0}   # forward launches whose span states were kept (training)
MAX_STATE = 256                 # the kernels' largest N (shared memory)
PHASES = ("state", "pass", "out")     # the CUDA kernels of one call, in order
BWD_PHASES = ("carry", "chunk", "sum")   # those of one backward call
Q = 64                          # the kernels' chunk length
SPAN = 4                        # the kernels' chunks per span

_lib: ctypes.CDLL | None = None
_bwd_lib: ctypes.CDLL | None = None


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


def _bwd_kernels() -> ctypes.CDLL:
    global _bwd_lib
    if _bwd_lib is None:
        lib = _build.library("ssd_scan_bwd")
        ptr, i = ctypes.c_void_p, ctypes.c_int
        lib.ssd_backward.argtypes = [ptr] * 20 + [i] * 6 + [ptr]
        lib.ssd_backward.restype = ctypes.c_int
        lib.ssd_bwd_group.argtypes = [i] * 5
        lib.ssd_bwd_group.restype = ctypes.c_int
        lib.ssd_bwd_state_ld.argtypes = [i]
        lib.ssd_bwd_state_ld.restype = ctypes.c_int
        _bwd_lib = lib
    return _bwd_lib


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
    if x.device.type != "cuda" and not shape_only(x):
        raise ValueError(f"no kernel for tensors on {x.device}")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, dt, A, Bm, Cm, h0)):
        return _SSDScan.apply(x, dt, A, Bm, Cm, h0)
    return _forward(x, dt, A, Bm, Cm, h0, keep_states=False)[:2]


def _forward(x, dt, A, Bm, Cm, h0, keep_states: bool):
    """Launch the three forward kernels; (y, h_final, the span states or
    None)."""
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    n_chunks = -(-S // Q)
    n_spans = -(-n_chunks // SPAN)
    y = torch.empty_like(x)
    h = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
    cbt = torch.empty((B, n_chunks, Q, Q), dtype=torch.float32, device=x.device)
    states = torch.empty((B * H, n_spans, P, N), dtype=torch.float32, device=x.device)
    logdec = torch.empty((B * H, n_spans), dtype=torch.float32, device=x.device)
    if x.device.type == "meta":
        active().add_kernel("ssd_scan", *ssd_scan_work(B, S, H, P, N, h0 is not None, Q,
                                                       with_states=keep_states))
        return y, h, states if keep_states else None
    err = _kernels().ssd_forward(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
        None if h0 is None else h0.data_ptr(), y.data_ptr(), h.data_ptr(), cbt.data_ptr(),
        states.data_ptr(), logdec.data_ptr(), B, S, H, P, N, x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: cudaError_t {err}")
    LAUNCHES["ssd_scan"] += 1
    if keep_states:
        STATES_KEPT["ssd_scan"] += 1
        return y, h, states
    return y, h, None


def ssd_scan_bwd(x, dt, A, Bm, Cm, dy, states, dh=None):
    """The gradient of ``ssd_scan`` on the card: x, dt, A, Bm, Cm as the
    forward took them, dy (B, S, H, P) the cotangent of y, ``states`` (B·H,
    n_spans, P, N) the forward's span states, dh (B, H, P, N) the
    cotangent of the final state or None (zero); all float32, contiguous,
    on one card.  Returns (dx, ddt, dA, dB, dC, dh0); dB, dC and dA sum
    over heads, positions and batch rows in a fixed order (no atomics), so
    two calls give the same bits."""
    _check(x, dt, A, Bm, Cm, None, x.shape[1])
    if x.device.type != "cuda" and not shape_only(x):
        raise ValueError(f"the backward kernels run on the card; got tensors on {x.device}")
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    n_chunks = -(-S // Q)
    want = {"dy": (dy, (B, S, H, P)), "states": (states, (B * H, -(-n_chunks // SPAN), P, N))}
    if dh is not None:
        want["dh"] = (dh, (B, H, P, N))
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
        if t.dtype != torch.float32 or t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 tensor on {x.device}")
    if x.device.type == "meta":
        active().add_kernel("ssd_scan_bwd", *ssd_scan_bwd_work(B, S, H, P, N, dh is not None, Q))
        return (torch.empty_like(x), torch.empty_like(dt), torch.empty_like(A),
                torch.empty_like(Bm), torch.empty_like(Cm),
                torch.empty((B, H, P, N), dtype=torch.float32, device=x.device))
    lib = _bwd_kernels()
    group = lib.ssd_bwd_group(B, S, H, N, x.device.index)
    if group <= 0:
        raise RuntimeError(f"ssd_scan backward: no head group for {(B, S, H, N)}")
    f32 = dict(dtype=torch.float32, device=x.device)
    ld = lib.ssd_bwd_state_ld(N)        # the kernels' row stride of R and h_in
    R = torch.empty((B * H, n_chunks, P, ld), **f32)
    hin = torch.empty((B * H, n_chunks, P, ld), **f32)
    cbt = torch.empty((B, n_chunks, Q, Q), **f32)
    dApart = torch.empty((B * H, n_chunks), **f32)
    dBp = torch.empty((B, S, -(-H // group), N), **f32)
    dCp = torch.empty((B, S, -(-H // group), N), **f32)
    dx, ddt = torch.empty_like(x), torch.empty_like(dt)
    dA, dB, dC = torch.empty_like(A), torch.empty_like(Bm), torch.empty_like(Cm)
    dh0 = torch.empty((B, H, P, N), **f32)
    err = lib.ssd_backward(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
        dy.data_ptr(), None if dh is None else dh.data_ptr(), states.data_ptr(),
        R.data_ptr(), hin.data_ptr(), cbt.data_ptr(), dBp.data_ptr(), dCp.data_ptr(),
        dApart.data_ptr(), dx.data_ptr(), ddt.data_ptr(), dA.data_ptr(), dB.data_ptr(),
        dC.data_ptr(), dh0.data_ptr(), B, S, H, P, N, x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan backward launch failed: cudaError_t {err}")
    LAUNCHES["ssd_scan_bwd"] += 1
    return dx, ddt, dA, dB, dC, dh0


class _SSDScan(torch.autograd.Function):
    """K4 with its gradient: the forward kernels keeping their span states,
    the backward kernels reading them."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, h0):
        y, h, states = _forward(x, dt, A, Bm, Cm, h0, keep_states=True)
        ctx.save_for_backward(x, dt, A, Bm, Cm, states)
        ctx.has_h0 = h0 is not None
        ctx.set_materialize_grads(False)     # an unused output's cotangent stays None
        return y, h

    @staticmethod
    def backward(ctx, dy, dh):
        x, dt, A, Bm, Cm, states = ctx.saved_tensors
        dy = torch.zeros_like(x) if dy is None else dy.contiguous()
        dh = None if dh is None else dh.contiguous()
        dx, ddt, dA, dB, dC, dh0 = ssd_scan_bwd(x, dt, A, Bm, Cm, dy, states, dh)
        return dx, ddt, dA, dB, dC, dh0 if ctx.has_h0 else None


def smem_bytes(n: int) -> dict[str, int]:
    """Dynamic shared memory of one block of each phase at state size ``n``,
    in bytes (as the kernels' source computes it)."""
    return {name: _kernels().ssd_smem_bytes(i, n) for i, name in enumerate(PHASES)}

