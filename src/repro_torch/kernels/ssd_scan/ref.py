"""Plain PyTorch oracle for the SSD kernel: the naive O(S) recurrence.

Ports ``repro.kernels.ssd_scan.ref.ssd_ref``.  Computes in the inputs'
floating type if it is float64 (so the card can hold K4 against a float64
oracle), else in float32; one step per position, so it is an oracle, not a
yardstick of speed.
"""

from __future__ import annotations

import torch

__all__ = ["ssd_ref"]


def ssd_ref(x, dt, A, Bm, Cm, h0=None):
    """Sequential state-space recurrence (Mamba-2 §3, eq. 1-2).

    x  (B, S, H, P); dt (B, S, H); A (H,) negative; Bm, Cm (B, S, N).
    h_t = exp(dt_t A) h_{t-1} + dt_t x_t ⊗ B_t ;  y_t = C_t · h_t
    Returns y (B, S, H, P) and final h (B, H, P, N), float32 (float64 for
    float64 inputs).
    """
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    ft = torch.float64 if x.dtype == torch.float64 else torch.float32
    x, dt, A, Bm, Cm = (t.to(ft) for t in (x, dt, A, Bm, Cm))
    h = (torch.zeros((Bsz, H, P, N), dtype=ft, device=x.device) if h0 is None
         else h0.to(ft))
    ys = []
    for t in range(S):
        a = torch.exp(dt[:, t] * A[None])                          # (B, H)
        h = h * a[..., None, None] + torch.einsum(
            "bhp,bn->bhpn", x[:, t] * dt[:, t, :, None], Bm[:, t])
        ys.append(torch.einsum("bn,bhpn->bhp", Cm[:, t], h))
    return torch.stack(ys, dim=1), h
