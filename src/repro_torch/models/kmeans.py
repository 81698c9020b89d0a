"""MiniBatch K-Means in PyTorch — the paper's representative streaming workload.

Ports ``repro.models.kmeans``.  Phase 1 (distances between all n points and
c centroids, O(n·c·d), reduced to each point's nearest centroid) runs on the
fused ``kmeans_distance`` assignment kernel (K2) for CUDA tensors and on its
plain version for CPU tensors; phase 2 is the
MiniBatch update (Sculley 2010): per-centroid counts give a decaying rate
``eta = m_batch / count``.

The update keeps the reference's one-hot matmul (order-deterministic) rather
than ``index_add_``/``scatter_add_``, whose CUDA atomics sum in a different
order on every run.  The matmul needs full float32: ``update`` raises on a
CUDA tensor while ``torch.backends.cuda.matmul.allow_tf32`` is set (off is
PyTorch's default), since TF32 keeps ~3 decimal digits, too few for the update.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.kernels.kmeans_distance import ops as kd_ops

__all__ = ["KMeansState", "init_state", "assign", "update", "minibatch_step",
           "inertia", "flops_estimate", "state_from_numpy", "state_to_numpy"]


class KMeansState(NamedTuple):
    centroids: torch.Tensor   # (c, d) float32
    counts: torch.Tensor      # (c,) float32 — cumulative assignment counts


def init_state(n_centroids: int, dim: int, *, generator: torch.Generator,
               device: str | torch.device = "cuda", scale: float = 1.0) -> KMeansState:
    """Centroids ~ scale * N(0, 1) drawn from ``generator`` (on its own
    device), then placed on ``device``; counts start at zero."""
    dev = resolve_device(device)
    centroids = scale * torch.randn((n_centroids, dim), generator=generator,
                                    device=generator.device, dtype=torch.float32)
    return KMeansState(centroids=centroids.to(dev),
                       counts=torch.zeros((n_centroids,), dtype=torch.float32,
                                          device=dev))


def state_from_numpy(centroids: np.ndarray, counts: np.ndarray, *,
                     device: str | torch.device = "cuda") -> KMeansState:
    """A state from numpy arrays (e.g. a JAX ``KMeansState`` via
    ``np.asarray``) — the model weights of this system."""
    dev = resolve_device(device)
    return KMeansState(
        centroids=torch.as_tensor(np.asarray(centroids, np.float32), device=dev),
        counts=torch.as_tensor(np.asarray(counts, np.float32), device=dev))


def state_to_numpy(state: KMeansState) -> tuple[np.ndarray, np.ndarray]:
    """(centroids, counts) as float32 numpy arrays."""
    return (state.centroids.detach().cpu().numpy(),
            state.counts.detach().cpu().numpy())


def assign(points: torch.Tensor, centroids: torch.Tensor):
    """(labels (n,) int32, sq_dist_to_assigned (n,) float32) from the fused
    assignment (kernel K2 on the card, ``assign_ref`` on the CPU).

    The reference takes argmin and min of the full (n, c) distance matrix;
    its kernel docstring (``repro/kernels/kmeans_distance/kernel.py``) says
    the fused kernel exists because the K-Means inner loop needs only the
    argmin.  K2 shares the distance arithmetic of the matrix's kernel and of
    the plain versions bit for bit and takes the smallest index on an exact
    tie, as ``argmin`` does, so its labels and distances are the matrix
    path's; int32 labels, as ``jnp.argmin`` gives.  The (n, c) matrix is no
    longer written on the main path."""
    return kd_ops.assign(points, centroids)


def update(state: KMeansState, points: torch.Tensor,
           labels: torch.Tensor) -> KMeansState:
    """MiniBatch update of ``state`` with ``points`` (n, d) assigned to
    ``labels`` (n,)."""
    if points.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("the MiniBatch update needs full float32 matmuls; "
                           "set torch.backends.cuda.matmul.allow_tf32 = False")
    c = state.centroids.shape[0]
    onehot = torch.nn.functional.one_hot(labels.long(), c).to(points.dtype)  # (n, c)
    batch_counts = onehot.sum(dim=0)                                         # (c,)
    batch_sums = torch.matmul(onehot.T, points)                              # (c, d)
    new_counts = state.counts + batch_counts
    # decaying per-centroid rate; centroids with no assignments unchanged
    eta = torch.where(new_counts > 0,
                      batch_counts / torch.clamp_min(new_counts, 1.0),
                      torch.zeros_like(new_counts))
    batch_means = batch_sums / torch.clamp_min(batch_counts, 1.0)[:, None]
    new_centroids = (1.0 - eta)[:, None] * state.centroids + eta[:, None] * batch_means
    return KMeansState(centroids=new_centroids, counts=new_counts)


def minibatch_step(state: KMeansState, points: torch.Tensor) -> KMeansState:
    """One MiniBatch K-Means update on a batch of points (n, d)."""
    labels, _ = assign(points, state.centroids)
    return update(state, points, labels)


def inertia(points: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """Mean squared distance to the assigned centroid (clustering quality).

    Takes ``best`` from ``assign`` (kernel K2 on the card): the reference's
    minimum of the same distances, without writing the (n, c) matrix."""
    _, best = assign(points, centroids)
    return best.mean()


def flops_estimate(n: int, c: int, d: int) -> float:
    """Analytic FLOPs of one minibatch step (distance phase dominates: 3ncd)."""
    distance = 3.0 * n * c * d
    update_ops = 2.0 * n * c + 2.0 * n * d + 6.0 * c * d
    return distance + update_ops
