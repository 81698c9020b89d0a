"""Plain PyTorch version of the flash-attention kernel (causal GQA).

Ports ``repro.kernels.flash_attention.ref.mha_ref``: fp32 math, kv rows
repeated G = BH / BKV times along the row axis, masked scores set to
``-1e30``, output in q's dtype.  ``window`` > 0 adds the reference model's
local-attention mask (``attend_full``: key j is seen from query i iff
``i - window < j``), which the reference's ``mha_ref`` does not take.  Materialises the (BH, S, S) scores, so it
is a correctness oracle, not a yardstick of speed.

``lse_ref`` and ``mha_bwd_ref`` are the plain versions of the training
path's two outputs of the kernels: each row's log-sum-exp of its scaled
scores (the forward writes it when a gradient is needed), and dq, dk, dv
by the explicit formulas of the backward from that lse.  The reference has
neither: it differentiates its model's attention through XLA.
"""

from __future__ import annotations

import math

import torch

__all__ = ["mha_ref", "lse_ref", "mha_bwd_ref", "NEG_INF"]

NEG_INF = -1e30


def mha_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
            causal: bool = True, scale: float | None = None,
            window: int = 0) -> torch.Tensor:
    """q (BH, S, Dh); k, v (BKV, S, Dh) with BH = BKV * G.  fp32 math."""
    G = q.shape[0] // k.shape[0]
    vf = v.float().repeat_interleave(G, dim=0)
    p = torch.softmax(_scores(q, k, causal, scale, window), dim=-1)
    return torch.bmm(p, vf).to(q.dtype)


def _mask(S: int, window: int, device) -> torch.Tensor:
    """(S, S) bool: key j visible from query i (causal, local with ``window``)."""
    idx = torch.arange(S, device=device)
    mask = idx[None, :] <= idx[:, None]                               # kpos <= qpos
    if window:
        mask = mask & (idx[None, :] > idx[:, None] - window)
    return mask


def _scores(q, k, causal, scale, window) -> torch.Tensor:
    """(BH, S, S) f32 scaled scores, masked scores ``NEG_INF``."""
    BH, S, Dh = q.shape
    G = BH // k.shape[0]
    scale = scale if scale is not None else 1.0 / math.sqrt(Dh)
    qf = q.float() * scale
    kf = k.float().repeat_interleave(G, dim=0)
    s = torch.bmm(qf, kf.transpose(1, 2))
    if window and not causal:
        raise ValueError("a local window is causal: pass causal=True")
    if causal:
        s = torch.where(_mask(S, window, q.device)[None], s, torch.full_like(s, NEG_INF))
    return s


def lse_ref(q: torch.Tensor, k: torch.Tensor, *, window: int = 0) -> torch.Tensor:
    """(BH, S) f32 log-sum-exp of each causal row's scaled scores."""
    return torch.logsumexp(_scores(q, k, True, None, window), dim=-1)


def mha_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                do: torch.Tensor, lse: torch.Tensor, *, window: int = 0):
    """dq, dk, dv of causal GQA attention by the explicit formulas, f32 math
    from the given lse (BH, S) and output ``o``:  P = exp(s - lse) (0 where
    masked), D = rowsum(do * o), dV = P^T dO, dS = P (dO V^T - D),
    dQ = scale dS K, dK = scale dS^T Q, with the G query heads of a kv row
    summed.  Returns them in the inputs' dtype."""
    BH, S, Dh = q.shape
    BKV = k.shape[0]
    G = BH // BKV
    scale = 1.0 / math.sqrt(Dh)
    dof = do.float()
    kf = k.float().repeat_interleave(G, dim=0)
    vf = v.float().repeat_interleave(G, dim=0)
    mask = _mask(S, window, q.device)[None]
    s = _scores(q, k, True, None, window)
    p = torch.where(mask, torch.exp(s - lse.float()[..., None]), torch.zeros_like(s))
    delta = (dof * o.float()).sum(-1, keepdim=True)
    ds = p * (torch.bmm(dof, vf.transpose(1, 2)) - delta)
    dq = scale * torch.bmm(ds, kf)
    dk = scale * torch.bmm(ds.transpose(1, 2), q.float())
    dv = torch.bmm(p.transpose(1, 2), dof)
    dk = dk.view(BKV, G, S, Dh).sum(1)
    dv = dv.view(BKV, G, S, Dh).sum(1)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
