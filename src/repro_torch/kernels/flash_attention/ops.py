"""Public wrapper for the flash-attention kernel (K3).

Ports ``repro.kernels.flash_attention.ops``.  Dispatch is by the tensors'
device: CPU tensors run the plain version ``ref.mha_ref``; CUDA tensors
launch the hand-written kernel in ``csrc/flash_attention.cu`` on the
current stream, or raise.  There is no fallback from one to the other.

The reference pads Dh to the TPU's 128 lanes (with a q prescale) and S to
its block size; the kernel takes any Dh <= 256 with scale 1/sqrt(Dh) and
masks a ragged S itself, so nothing is padded here.  ``window`` > 0 is
local attention (the reference model's ``attend_full``/``attend_chunked``
mask ``qpos - window < kpos <= qpos``), which the TPU kernel lacks.  ``LAUNCHES`` counts
kernel launches, so a run can show that its main path went through the
kernel; the serving path calls this wrapper from one thread per partition,
and CPython's GIL keeps the single ``+=`` on a dict entry whole.

Training: where grad mode is on and q, k or v requires grad, a CUDA call
goes through ``_FlashAttention``, a ``torch.autograd.Function``.  Its
forward launches the same kernel with an f32 (BH, S) ``lse`` output and
saves q, k, v, the output and lse; its backward launches
``csrc/flash_attention_bwd.cu`` (D = rowsum(dO o O), then dK/dV, for bf16 a
pass that sums the G-chunks' partials, then dQ), counted once a call in
``LAUNCHES["flash_attention_bwd"]`` and once in ``BWD_ROUTES`` under the
route it took: ``"tma"`` (bf16, tiles loaded by TMA), ``"copy"`` (bf16,
where Dh % 8 != 0 or an input is not 16-byte aligned: the same kernels with
the tiles copied by threads) or ``"f32"``.  ``LSE_WRITES`` counts the
forward launches that wrote lse.  Under ``models.transformer``'s remat
(``cfg.remat`` ``"full"`` or ``"dots"``) a checkpointed layer's forward
runs again in the backward: the recompute is a launch like the first, in
``LAUNCHES`` and ``LSE_WRITES``, so such a layer launches the forward twice
a microbatch and the backward once.  The kernel has no atomics, so the
recomputed out and lse are the first forward's bits, and the Function saves
tensors of the same shapes, dtypes and device both times (as the
checkpoint's determinism check requires); both are written into fresh
outputs, never into a tensor the selective policy keeps.  Otherwise
(serving, or ``torch.no_grad``) lse is not written and nothing is saved.
The backward takes every Dh the forward takes.  On the CPU, autograd
differentiates ``mha_ref`` itself.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import mha_ref

__all__ = ["flash_attention", "flash_attention_bwd", "smem_bytes", "bwd_smem_bytes",
           "LAUNCHES", "LSE_WRITES", "BWD_ROUTES", "MAX_HEAD_DIM", "MAX_BWD_HEAD_DIM"]

LAUNCHES = {"flash_attention": 0, "flash_attention_bwd": 0}
LSE_WRITES = {"flash_attention": 0}     # forward launches that wrote lse (training)
BWD_ROUTES = {"tma": 0, "copy": 0, "f32": 0}   # backward launches by route
MAX_HEAD_DIM = 256
MAX_BWD_HEAD_DIM = 256

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GRID_Y = 65535             # CUDA's grid.y limit
_BQ = 64                        # query rows per block, both kernels
_ROUTE_NAMES = ("f32", "tma", "copy")   # the backward's route codes
_lib: ctypes.CDLL | None = None
_bwd_lib: ctypes.CDLL | None = None


def _kernels() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.library("flash_attention")
        ptr, i = ctypes.c_void_p, ctypes.c_int
        lib.fa_forward.argtypes = [ptr, ptr, ptr, ptr, ptr, i, i, i, i, i, i, i, ptr]
        lib.fa_forward.restype = ctypes.c_int
        lib.fa_smem_bytes.argtypes = [i, i]
        lib.fa_smem_bytes.restype = ctypes.c_int
        _lib = lib
    return _lib


def _bwd_kernels() -> ctypes.CDLL:
    global _bwd_lib
    if _bwd_lib is None:
        lib = _build.library("flash_attention_bwd")
        ptr, i = ctypes.c_void_p, ctypes.c_int
        lib.fa_backward.argtypes = ([ptr] * 10 + [ctypes.c_longlong] + [i] * 7
                                    + [ptr, ctypes.POINTER(i)])
        lib.fa_backward.restype = ctypes.c_int
        lib.fa_bwd_scratch_floats.argtypes = [i] * 6
        lib.fa_bwd_scratch_floats.restype = ctypes.c_longlong
        lib.fa_bwd_smem_bytes.argtypes = [i, i, i]
        lib.fa_bwd_smem_bytes.restype = ctypes.c_int
        lib.fa_bwd_max_head_dim.restype = ctypes.c_int
        if lib.fa_bwd_max_head_dim() != MAX_BWD_HEAD_DIM:
            raise RuntimeError("flash_attention_bwd.cu and ops.py disagree on the "
                               "backward's largest head dim")
        _bwd_lib = lib
    return _bwd_lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
           window: int) -> None:
    if not causal:
        raise NotImplementedError("the flash-attention kernel computes causal "
                                  "attention only (as the reference's padded "
                                  "flash path does)")
    if window < 0:
        raise ValueError(f"window={window}: 0 (none) or a positive local window")
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape:
        raise ValueError(f"expected q (BH, S, Dh) and k, v (BKV, S, Dh), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    bh, s, dh = q.shape
    bkv = k.shape[0]
    if k.shape[1:] != (s, dh) or bh == 0 or bkv == 0 or s == 0:
        raise ValueError(f"q {tuple(q.shape)} and k, v {tuple(k.shape)} disagree "
                         f"on (S, Dh) or are empty")
    if bh % bkv:
        raise ValueError(f"BH={bh} is not a multiple of BKV={bkv}")
    if not 0 < dh <= MAX_HEAD_DIM:
        raise ValueError(f"Dh={dh} outside the kernel's 1..{MAX_HEAD_DIM}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"expected float32 or bfloat16 q, k, v of one dtype, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not q.device == k.device == v.device:
        raise ValueError(f"q, k, v on {q.device}, {k.device}, {v.device}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("the kernel takes contiguous row-major q, k, v")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """Causal GQA attention: q (BH, S, Dh); k, v (BKV, S, Dh), contiguous,
    with BH = BKV·G; q row b reads kv row b // G; with ``window`` > 0 query
    i sees keys i - window + 1 .. i only.  Returns (BH, S, Dh) in q's
    dtype.  On the card, f32 inputs are computed on the tensor cores in
    3xTF32 (each operand split into two TF32 parts, three products, f32
    sums), which keeps f32 accuracy; bf16 inputs with f32 accumulation and
    bf16 tensor-core products, with P split hi/lo so that the PV product
    keeps ~16 bits of each probability.
    Differentiable: on the card through the backward kernels, on the CPU
    through ``mha_ref``."""
    _check(q, k, v, causal, window)
    if q.device.type == "cpu":
        return mha_ref(q, k, v, causal=True, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for tensors on {q.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _FlashAttention.apply(q, k, v, window)
    return _forward(q, k, v, window, with_lse=False)[0]


def _forward(q, k, v, window: int, with_lse: bool):
    """Launch the forward kernel; (out, lse or None)."""
    bh, s, dh = q.shape
    # grid (BH, the 64-query tiles): the tiles are grid.y, in both dtypes
    if -(-s // _BQ) > _MAX_GRID_Y:
        raise ValueError(f"S={s} exceeds the kernel's grid ({_MAX_GRID_Y} tiles of {_BQ})")
    out = torch.empty_like(q)
    lse = torch.empty((bh, s), dtype=torch.float32, device=q.device) if with_lse else None
    err = _kernels().fa_forward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), bh, k.shape[0], s, dh, window,
        _DTYPE_CODES[q.dtype], q.device.index, torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: cudaError_t {err}")
    LAUNCHES["flash_attention"] += 1
    if with_lse:
        LSE_WRITES["flash_attention"] += 1
    return out, lse


def flash_attention_bwd(q, k, v, out, dout, lse, window: int = 0):
    """dq, dk, dv of ``flash_attention`` on the card: q, out, dout (BH, S,
    Dh); k, v (BKV, S, Dh); lse (BH, S) f32 as the forward wrote it; all
    contiguous CUDA tensors of one dtype (lse f32).  Returns them in the
    inputs' dtype, f32-accumulated; dk and dv sum the G heads of each kv row
    in a fixed order (no atomics), so two calls give the same bits."""
    _check(q, k, v, True, window)
    if q.device.type != "cuda":
        raise ValueError(f"the backward kernel runs on the card; got tensors on {q.device}")
    bh, s, dh = q.shape
    if out.shape != q.shape or dout.shape != q.shape or lse.shape != (bh, s):
        raise ValueError(f"out {tuple(out.shape)}, dout {tuple(dout.shape)} and lse "
                         f"{tuple(lse.shape)} do not match q {tuple(q.shape)}")
    if out.dtype != q.dtype or dout.dtype != q.dtype or lse.dtype != torch.float32:
        raise TypeError(f"out, dout in {q.dtype} and lse in float32, got {out.dtype}, "
                        f"{dout.dtype}, {lse.dtype}")
    if not all(t.device == q.device and t.is_contiguous() for t in (out, dout, lse)):
        raise ValueError("out, dout and lse must be contiguous and on q's device")
    if -(-s // _BQ) > _MAX_GRID_Y:
        raise ValueError(f"S={s} exceeds the backward's grid ({_MAX_GRID_Y} tiles of {_BQ})")
    lib, code, dev = _bwd_kernels(), _DTYPE_CODES[q.dtype], q.device.index
    n_scratch = lib.fa_bwd_scratch_floats(bh, k.shape[0], s, dh, code, dev)
    if n_scratch < 0:
        raise RuntimeError(f"flash_attention backward: no SM count for {q.device}")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    scratch = torch.empty(n_scratch, dtype=torch.float32, device=q.device)
    route = ctypes.c_int(-1)
    err = lib.fa_backward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), scratch.data_ptr(),
        n_scratch, bh, k.shape[0], s, dh, window, code, dev,
        torch.cuda.current_stream(q.device).cuda_stream, ctypes.byref(route))
    if err != 0:
        raise RuntimeError(f"flash_attention backward launch failed: cudaError_t {err}")
    LAUNCHES["flash_attention_bwd"] += 1
    BWD_ROUTES[_ROUTE_NAMES[route.value]] += 1
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """K3 with its gradient: the forward kernel writing lse, the backward
    kernels reading it."""

    @staticmethod
    def forward(ctx, q, k, v, window):
        out, lse = _forward(q, k, v, window, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.window = window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout.contiguous(), lse, ctx.window)
        return dq, dk, dv, None


def smem_bytes(dh: int, *, dtype: torch.dtype) -> int:
    """Dynamic shared memory of one kernel block at head dim ``dh`` for
    inputs of ``dtype``, in bytes (as the kernel's source computes it: the
    f32 and bf16 kernels stage their tiles differently)."""
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"no kernel for {dtype}; expected float32 or bfloat16")
    return _kernels().fa_smem_bytes(dh, _DTYPE_CODES[dtype])


def bwd_smem_bytes(dh: int, *, dtype: torch.dtype) -> dict[str, int]:
    """Dynamic shared memory of one block of the backward's dK/dV and dQ
    kernels at head dim ``dh``, in bytes (as their source computes it)."""
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"no kernel for {dtype}; expected float32 or bfloat16")
    code = _DTYPE_CODES[dtype]
    return {"dkdv": _bwd_kernels().fa_bwd_smem_bytes(dh, code, 1),
            "dq": _bwd_kernels().fa_bwd_smem_bytes(dh, code, 0)}
