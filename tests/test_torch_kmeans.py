"""The port's MiniBatch K-Means against the JAX package's, on the CPU.

Same numpy state and messages into both packages (the quickstart shape:
512 x 9 clustered points, 32 centroids).  Over 24 steps the two sum in
different orders in float32, so centroids are held within rtol/atol 1e-4;
counts are whole numbers and must be equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import kmeans as jkm
from repro_torch.models import kmeans as tkm

N_STEPS, POINTS, DIM, CENTROIDS = 24, 512, 9, 32


def _stream(seed=0):
    """Initial centroids and the quickstart's clustered messages."""
    rng = np.random.default_rng(seed)
    centroids = rng.standard_normal((CENTROIDS, DIM), dtype=np.float32)
    centers = rng.normal(size=(4, DIM)) * 3
    msgs = [(centers[rng.integers(0, 4, POINTS)]
             + rng.normal(size=(POINTS, DIM))).astype(np.float32)
            for _ in range(N_STEPS)]
    return centroids, msgs


def test_minibatch_steps_match_jax():
    centroids, msgs = _stream()
    counts = np.zeros(CENTROIDS, np.float32)
    jstate = jkm.KMeansState(jnp.asarray(centroids), jnp.asarray(counts))
    tstate = tkm.state_from_numpy(centroids, counts, device="cpu")
    t_inertia0 = float(tkm.inertia(torch.from_numpy(msgs[0]), tstate.centroids))
    j_inertia, t_inertia = [], []
    for pts in msgs:
        jstate = jkm.minibatch_step(jstate, jnp.asarray(pts))
        tstate = tkm.minibatch_step(tstate, torch.from_numpy(pts))
        j_inertia.append(float(jkm.inertia(jnp.asarray(pts), jstate.centroids)))
        t_inertia.append(float(tkm.inertia(torch.from_numpy(pts), tstate.centroids)))
    t_c, t_n = tkm.state_to_numpy(tstate)
    np.testing.assert_allclose(t_c, np.asarray(jstate.centroids), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(t_n, np.asarray(jstate.counts))
    np.testing.assert_allclose(t_inertia, j_inertia, rtol=1e-5, atol=1e-5)
    assert t_inertia[-1] < t_inertia0


def test_assign_matches_jax_model_assign():
    centroids, msgs = _stream(seed=1)
    j_labels, j_best = jkm.assign(jnp.asarray(msgs[0]), jnp.asarray(centroids))
    labels, best = tkm.assign(torch.from_numpy(msgs[0]), torch.from_numpy(centroids))
    np.testing.assert_allclose(best.numpy(), np.asarray(j_best), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(labels.numpy(), np.asarray(j_labels))


def test_main_path_never_writes_the_distance_matrix(monkeypatch):
    """assign, minibatch_step and inertia take the fused assignment (K2 on
    the card); the (n, k) matrix (K1) is not on the main path."""
    def refuse(*_):
        raise AssertionError("pairwise_sq_dists called on the main path")

    monkeypatch.setattr(tkm.kd_ops, "pairwise_sq_dists", refuse)
    centroids, msgs = _stream(seed=2)
    state = tkm.state_from_numpy(centroids, np.zeros(CENTROIDS, np.float32), device="cpu")
    pts = torch.from_numpy(msgs[0])
    labels, best = tkm.assign(pts, state.centroids)
    state = tkm.minibatch_step(state, pts)
    loss = tkm.inertia(pts, state.centroids)
    assert labels.shape == best.shape == (POINTS,) and torch.isfinite(loss)
    assert float(state.counts.sum()) == POINTS


def test_assign_returns_int32_labels_as_the_reference():
    centroids, msgs = _stream(seed=3)
    labels, best = tkm.assign(torch.from_numpy(msgs[0]), torch.from_numpy(centroids))
    j_labels, _ = jkm.assign(jnp.asarray(msgs[0]), jnp.asarray(centroids))
    assert labels.dtype == torch.int32 and np.asarray(j_labels).dtype == np.int32
    assert best.dtype == torch.float32


@pytest.mark.parametrize("n,c,d", [(16000, 1024, 9), (16000, 8192, 9), (512, 32, 9)])
def test_flops_estimate_matches_jax(n, c, d):
    assert tkm.flops_estimate(n, c, d) == jkm.flops_estimate(n, c, d)


def test_state_round_trip_and_init():
    gen = torch.Generator().manual_seed(3)
    state = tkm.init_state(CENTROIDS, DIM, generator=gen, device="cpu", scale=2.0)
    assert state.centroids.shape == (CENTROIDS, DIM)
    assert state.centroids.dtype == torch.float32
    assert torch.count_nonzero(state.counts) == 0
    again = tkm.init_state(CENTROIDS, DIM, generator=torch.Generator().manual_seed(3),
                           device="cpu", scale=2.0)
    torch.testing.assert_close(state.centroids, again.centroids, rtol=0, atol=0)
    c, n = tkm.state_to_numpy(state)
    back = tkm.state_from_numpy(c, n, device="cpu")
    torch.testing.assert_close(back.centroids, state.centroids, rtol=0, atol=0)


def test_update_leaves_unassigned_centroids():
    state = tkm.state_from_numpy(np.eye(3, dtype=np.float32),
                                 np.zeros(3, np.float32), device="cpu")
    pts = torch.tensor([[2.0, 0, 0], [4.0, 0, 0]])
    new = tkm.update(state, pts, torch.tensor([0, 0]))
    assert new.counts.tolist() == [2.0, 0.0, 0.0]
    torch.testing.assert_close(new.centroids[0], torch.tensor([3.0, 0, 0]))
    torch.testing.assert_close(new.centroids[1:], state.centroids[1:])


def test_entry_points_raise_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        tkm.init_state(4, 2, generator=torch.Generator())
    with pytest.raises(RuntimeError):
        tkm.state_from_numpy(np.zeros((4, 2)), np.zeros(4))
