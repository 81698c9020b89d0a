"""The hand-written CUDA kernels against their plain PyTorch versions, on the
card.  Every test here is ``cuda``-marked and skips without a card; this
file imports no JAX, so it also runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import mha_ref
from repro_torch.kernels.kmeans_distance import ops
from repro_torch.kernels.kmeans_distance.ref import assign_ref, pairwise_sq_dists_ref
from repro_torch.models import kmeans

pytestmark = pytest.mark.cuda
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}    # tests/test_kernels.py's


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda")


def _inputs(n, k, d, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.standard_normal((n, d), dtype=np.float32)).to(device, dtype),
            torch.from_numpy(rng.standard_normal((k, d), dtype=np.float32)).to(device, dtype))


@pytest.mark.parametrize("n,k,d", [(16000, 1024, 9), (8001, 1000, 130), (64, 16, 9),
                                   (1, 1, 1), (33, 65, 33)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_kernels_match_plain(device, n, k, d, dtype):
    tol = TOL[dtype]
    x, c = _inputs(n, k, d, dtype, device)
    before = dict(ops.LAUNCHES)
    got = ops.pairwise_sq_dists(x, c)
    labels, best = ops.assign(x, c)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["pairwise_sq_dists"] == before["pairwise_sq_dists"] + 1
    assert ops.LAUNCHES["assign"] == before["assign"] + 1
    want = pairwise_sq_dists_ref(x, c)
    torch.testing.assert_close(got, want, rtol=tol, atol=tol * d)
    _, ref_best = assign_ref(x, c)
    torch.testing.assert_close(best, ref_best, rtol=tol, atol=tol * d)
    picked = want.gather(1, labels.long()[:, None])[:, 0]
    torch.testing.assert_close(picked, ref_best, rtol=tol, atol=tol * d)


def test_f32_kernels_are_bit_equal_to_plain(device):
    x, c = _inputs(4096, 777, 9, torch.float32, device, seed=1)
    want = pairwise_sq_dists_ref(x, c)
    assert torch.equal(ops.pairwise_sq_dists(x, c), want)
    labels, best = ops.assign(x, c)
    ref_labels, ref_best = assign_ref(x, c)
    assert torch.equal(best, ref_best) and torch.equal(labels, ref_labels)


def test_assign_tie_takes_smallest_index(device):
    x = torch.zeros((3, 4), device=device)
    c = torch.tensor([[1.0, 0, 0, 0], [0, 1.0, 0, 0], [0, 0, 0, 1.0]], device=device)
    labels, best = ops.assign(x, c)
    assert labels.tolist() == [0, 0, 0] and best.tolist() == [1.0, 1.0, 1.0]


def test_wrappers_reject_what_the_kernels_do_not_take(device):
    x, c = _inputs(64, 16, 9, torch.float32, device)
    with pytest.raises(ValueError, match="contiguous"):
        ops.pairwise_sq_dists(x.T.contiguous().T, c)
    with pytest.raises(ValueError, match="empty"):
        ops.assign(x[:0], c)
    with pytest.raises(ValueError):
        ops.assign(x, c.cpu())


def test_minibatch_step_runs_on_the_card(device):
    rng = np.random.default_rng(2)
    state = kmeans.state_from_numpy(rng.standard_normal((64, 9), dtype=np.float32),
                                    np.zeros(64, np.float32), device=device)
    pts = torch.from_numpy(rng.standard_normal((1000, 9), dtype=np.float32)).to(device)
    before = dict(ops.LAUNCHES)
    state = kmeans.minibatch_step(state, pts)
    loss = kmeans.inertia(pts, state.centroids)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["pairwise_sq_dists"] == before["pairwise_sq_dists"] + 1
    assert ops.LAUNCHES["assign"] == before["assign"] + 1
    assert float(state.counts.sum()) == 1000 and torch.isfinite(loss)


def test_update_refuses_tf32(device, monkeypatch):
    state = kmeans.state_from_numpy(np.zeros((4, 9), np.float32), np.zeros(4, np.float32),
                                    device=device)
    pts = torch.zeros((8, 9), device=device)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    with pytest.raises(RuntimeError, match="allow_tf32"):
        kmeans.update(state, pts, torch.zeros(8, dtype=torch.int64, device=device))


# -- K3 flash_attention -------------------------------------------------------

FA_TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}    # tests/test_kernels.py:64's


def _qkv(bh, bkv, s, dh, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(device, dtype)
                 for shape in ((bh, s, dh), (bkv, s, dh), (bkv, s, dh)))


@pytest.mark.parametrize("bh,bkv,s,dh", [(56, 8, 1024, 64), (6, 3, 1000, 40),
                                         (4, 4, 128, 64), (8, 2, 256, 64),
                                         (2, 1, 64, 128), (14, 2, 48, 64),
                                         (3, 1, 1, 16), (2, 2, 65, 33)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_flash_attention_kernel_matches_plain(device, bh, bkv, s, dh, dtype):
    q, k, v = _qkv(bh, bkv, s, dh, dtype, device)
    before = fa_ops.LAUNCHES["flash_attention"]
    got = fa_ops.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert fa_ops.LAUNCHES["flash_attention"] == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    tol = FA_TOL[dtype]
    torch.testing.assert_close(got.float(), mha_ref(q, k, v).float(), rtol=tol, atol=tol)


def test_flash_attention_wrapper_rejects_what_the_kernel_does_not_take(device):
    q, k, v = _qkv(4, 2, 64, 64, torch.float32, device)
    with pytest.raises(ValueError, match="contiguous"):
        fa_ops.flash_attention(q.transpose(0, 1).contiguous().transpose(0, 1), k, v)
    with pytest.raises(ValueError, match="multiple"):
        fa_ops.flash_attention(q[:3], k, v)
    with pytest.raises(TypeError):
        fa_ops.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError):
        fa_ops.flash_attention(q, k.cpu(), v)


def test_attend_launches_the_kernel_once_per_layer(device):
    from repro_torch.configs.base import reduced
    from repro_torch.models import model as M

    cfg = reduced("qwen2-0.5b")
    params = M.init_params(cfg, torch.Generator(device=device).manual_seed(0), device)
    tokens = torch.randint(0, cfg.vocab_size, (2, 40), device=device)
    before = fa_ops.LAUNCHES["flash_attention"]
    logits = M.forward(params, cfg, tokens)
    torch.cuda.synchronize()
    assert fa_ops.LAUNCHES["flash_attention"] == before + cfg.n_layers
    assert logits.shape == (2, 40, cfg.vocab_size) and torch.isfinite(logits).all()
