"""Plain PyTorch versions of the K-Means distance/assignment kernels.

Ports ``repro.kernels.kmeans_distance.ref``: ||x||^2 + ||c||^2 - 2 x c^T,
clamped at zero, in float32 from f32 or bf16 inputs (as the TPU kernel's
``_dist_tile`` computes).  The reference leaves the order of its sums to a
matmul; here the norms and dot products are summed over d in index order,
one rounded product and one rounded add per term — the arithmetic of the
CUDA kernels.  The kernels and these versions therefore agree bit for bit
in float32, so a near-tie between two centroids breaks the same way in both.
"""

from __future__ import annotations

import torch

__all__ = ["pairwise_sq_dists_ref", "assign_ref"]


def pairwise_sq_dists_ref(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """(n, d), (k, d) -> (n, k) float32 squared Euclidean distances."""
    x = x.float()
    c = c.float()
    xn = x[:, 0] * x[:, 0]                               # (n,)
    cn = c[:, 0] * c[:, 0]                               # (k,)
    dot = x[:, 0, None] * c[None, :, 0]                  # (n, k)
    for j in range(1, x.shape[1]):
        xn = xn + x[:, j] * x[:, j]
        cn = cn + c[:, j] * c[:, j]
        dot = dot + x[:, j, None] * c[None, :, j]
    return torch.clamp_min((xn[:, None] + cn[None, :]) - 2.0 * dot, 0.0)


def assign_ref(x: torch.Tensor, c: torch.Tensor):
    """(labels (n,) int32, min_sq_dist (n,) float32); the first index wins
    among equal distances."""
    d2 = pairwise_sq_dists_ref(x, c)
    best, labels = torch.min(d2, dim=1)
    return labels.to(torch.int32), best
