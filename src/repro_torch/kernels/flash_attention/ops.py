"""Public wrapper for the flash-attention kernel (K3).

Ports ``repro.kernels.flash_attention.ops``.  Dispatch is by the tensors'
device: CPU tensors run the plain version ``ref.mha_ref``; CUDA tensors
launch the hand-written kernel in ``csrc/flash_attention.cu`` on the
current stream, or raise.  There is no fallback from one to the other.

The reference pads Dh to the TPU's 128 lanes (with a q prescale) and S to
its block size; the kernel takes any Dh <= 128 with scale 1/sqrt(Dh) and
masks a ragged S itself, so nothing is padded here.  ``LAUNCHES`` counts
kernel launches, so a run can show that its main path went through the
kernel; the serving path calls this wrapper from one thread per partition,
and CPython's GIL keeps the single ``+=`` on a dict entry whole.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import mha_ref

__all__ = ["flash_attention", "smem_bytes", "LAUNCHES", "MAX_HEAD_DIM"]

LAUNCHES = {"flash_attention": 0}
MAX_HEAD_DIM = 128

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_ROWS = 65535               # the kernel's grid.y limit (q rows BH)
_lib: ctypes.CDLL | None = None


def _kernels() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.library("flash_attention")
        ptr, i = ctypes.c_void_p, ctypes.c_int
        lib.fa_forward.argtypes = [ptr, ptr, ptr, ptr, i, i, i, i, i, i, ptr]
        lib.fa_forward.restype = ctypes.c_int
        lib.fa_smem_bytes.argtypes = [i]
        lib.fa_smem_bytes.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool) -> None:
    if not causal:
        raise NotImplementedError("the flash-attention kernel computes causal "
                                  "attention only (as the reference's padded "
                                  "flash path does)")
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
                    causal: bool = True) -> torch.Tensor:
    """Causal GQA attention: q (BH, S, Dh); k, v (BKV, S, Dh), contiguous,
    with BH = BKV·G; q row b reads kv row b // G.  Returns (BH, S, Dh) in q's
    dtype, computed in fp32."""
    _check(q, k, v, causal)
    if q.device.type == "cpu":
        return mha_ref(q, k, v, causal=True)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for tensors on {q.device}")
    bh, s, dh = q.shape
    if bh > _MAX_ROWS:
        raise ValueError(f"BH={bh} exceeds the kernel's grid ({_MAX_ROWS})")
    out = torch.empty_like(q)
    err = _kernels().fa_forward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh, k.shape[0],
        s, dh, _DTYPE_CODES[q.dtype], q.device.index,
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: cudaError_t {err}")
    LAUNCHES["flash_attention"] += 1
    return out


def smem_bytes(dh: int) -> int:
    """Dynamic shared memory of one kernel block at head dim ``dh``, in
    bytes (as the kernel's source computes it)."""
    return _kernels().fa_smem_bytes(dh)
