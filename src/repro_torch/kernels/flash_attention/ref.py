"""Plain PyTorch version of the flash-attention kernel (causal GQA).

Ports ``repro.kernels.flash_attention.ref.mha_ref``: fp32 math, kv rows
repeated G = BH / BKV times along the row axis, masked scores set to
``-1e30``, output in q's dtype.  ``window`` > 0 adds the reference model's
local-attention mask (``attend_full``: key j is seen from query i iff
``i - window < j``), which the reference's ``mha_ref`` does not take.  Materialises the (BH, S, S) scores, so it
is a correctness oracle, not a yardstick of speed.
"""

from __future__ import annotations

import math

import torch

__all__ = ["mha_ref", "NEG_INF"]

NEG_INF = -1e30


def mha_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
            causal: bool = True, scale: float | None = None,
            window: int = 0) -> torch.Tensor:
    """q (BH, S, Dh); k, v (BKV, S, Dh) with BH = BKV * G.  fp32 math."""
    BH, S, Dh = q.shape
    G = BH // k.shape[0]
    scale = scale if scale is not None else 1.0 / math.sqrt(Dh)
    qf = q.float() * scale
    kf = k.float().repeat_interleave(G, dim=0)
    vf = v.float().repeat_interleave(G, dim=0)
    s = torch.bmm(qf, kf.transpose(1, 2))
    if window and not causal:
        raise ValueError("a local window is causal: pass causal=True")
    if causal:
        idx = torch.arange(S, device=q.device)
        mask = idx[None, :] <= idx[:, None]                           # kpos <= qpos
        if window:
            mask = mask & (idx[None, :] > idx[:, None] - window)
        s = torch.where(mask[None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.bmm(p, vf).to(q.dtype)
