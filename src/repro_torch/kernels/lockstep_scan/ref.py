"""Plain PyTorch versions of the lockstep seed scans.

The reference runs both recurrences as ``jax.vmap(lax.scan)`` over the seed
axis (``repro.sim.batched.lockstep_completion_times`` and
``_grid_scan_fn``); here the seed axis is the first tensor dimension and the
scan a Python loop, with the same float32 operations in the same order.
One step is a few eager ops, so these are oracles for the kernels and the
CPU route of the wrappers, not a yardstick of speed.
"""

from __future__ import annotations

import torch

__all__ = ["lockstep_scan_ref", "grid_lockstep_scan_ref"]


def lockstep_scan_ref(appends: torch.Tensor, means: torch.Tensor, z: torch.Tensor,
                      a: float, b: float) -> torch.Tensor:
    """appends (n,), means (n,), z (S, n), float32.  For each seed row,
    ``finish = max(appends[i], finish) + means[i] * exp(a + b * z[i])`` from
    0, ``a`` and ``b`` rounded to float32.  Returns the finishes (S, n)."""
    a32 = torch.tensor(a, dtype=torch.float32, device=z.device)
    b32 = torch.tensor(b, dtype=torch.float32, device=z.device)
    dt = means[None, :] * torch.exp(a32 + b32 * z)
    out = torch.empty_like(z)
    finish = torch.zeros(z.shape[0], dtype=torch.float32, device=z.device)
    for i in range(z.shape[1]):
        finish = torch.maximum(appends[i], finish) + dt[:, i]
        out[:, i] = finish
    return out


def grid_lockstep_scan_ref(floors: torch.Tensor, parts: torch.Tensor, conts: torch.Tensor,
                           dt: torch.Tensor, n_parts: int, n_conts: int) -> torch.Tensor:
    """floors (n,) float32, parts and conts (n,) int32, dt (S, n) float32.
    For each seed row, ``finish = max(floors[k], max(part_last[p], cont_last[c]))
    + dt[k]``, then ``part_last[p] = cont_last[c] = finish``.  Returns the
    finishes (S, n)."""
    S, n = dt.shape
    out = torch.empty_like(dt)
    part_last = torch.zeros((S, n_parts), dtype=torch.float32, device=dt.device)
    cont_last = torch.zeros((S, n_conts), dtype=torch.float32, device=dt.device)
    for k, (p, c) in enumerate(zip(parts.tolist(), conts.tolist())):
        start = torch.maximum(floors[k], torch.maximum(part_last[:, p], cont_last[:, c]))
        fin = start + dt[:, k]
        part_last[:, p] = fin
        cont_last[:, c] = fin
        out[:, k] = fin
    return out
