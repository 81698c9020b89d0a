"""The real MiniBatch K-Means update as a simulated cell's ``fn``, for the
port's tests (``chip_smoke.py`` keeps its own at the paper's size).

Each message's points are rebuilt from its ``{"n_points", "seed"}`` payload;
the update logs the payloads in the order it saw them, so ``replay`` can run
the same updates through the plain assignment ``assign_ref``.
"""

import numpy as np
import torch

from repro_torch.kernels.kmeans_distance.ref import assign_ref
from repro_torch.models import kmeans

DIM, N_CLUSTERS = 9, 16
CENTERS = 3 * np.random.default_rng([0, DIM]).standard_normal((N_CLUSTERS, DIM))


def message_points(payload: dict) -> np.ndarray:
    """(n_points, DIM) float32 points around CENTERS, from the payload's seed."""
    rng = np.random.default_rng(payload["seed"])
    labels = rng.integers(0, N_CLUSTERS, payload["n_points"])
    noise = rng.standard_normal((payload["n_points"], DIM))
    return (CENTERS[labels] + noise).astype(np.float32)


class KMeansMessageUpdate:
    """Per message: the inertia under the model before the update, then
    ``minibatch_step`` (K2 twice on the card)."""

    def __init__(self, n_centroids: int, device, seed: int = 0) -> None:
        self.device = torch.device(device)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.initial = kmeans.init_state(n_centroids, DIM, generator=gen,
                                         device=self.device, scale=3.0)
        self.state = self.initial
        self.calls = 0
        self.payloads: list[dict] = []
        self.inertia: list[torch.Tensor] = []

    def _points(self, payload: dict) -> torch.Tensor:
        return torch.from_numpy(message_points(payload)).to(self.device)

    def __call__(self, msgs) -> None:
        self.calls += 1
        for m in msgs:
            pts = self._points(m.value)
            self.inertia.append(kmeans.inertia(pts, self.state.centroids))
            self.state = kmeans.minibatch_step(self.state, pts)
            self.payloads.append(m.value)

    def replay(self):
        """The model and each message's inertia from the logged payloads
        through ``assign_ref`` and the same update, on the same device."""
        state, inertia = self.initial, []
        for payload in self.payloads:
            pts = self._points(payload)
            labels, best = assign_ref(pts, state.centroids)
            inertia.append(best.mean())
            state = kmeans.update(state, pts, labels)
        return state, inertia
