"""The hand-written CUDA kernels against their plain PyTorch versions, on the
card.  Every test here is ``cuda``-marked and skips without a card; this
file imports no JAX, so it also runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.core import miniapp
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import lse_ref, mha_bwd_ref, mha_ref
from repro_torch.kernels.kmeans_distance import ops
from repro_torch.kernels.kmeans_distance.ref import assign_ref, pairwise_sq_dists_ref
from repro_torch.models import kmeans

from _kmeans_ties import planted_ties
from _sim_kmeans import KMeansMessageUpdate

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


@pytest.mark.parametrize("n,k,d", [(16000, 8192, 9), (16000, 1024, 9), (5000, 1031, 9),
                                   (3000, 1031, 20)])
def test_assign_ties_across_slices_take_the_smallest_index(device, n, k, d):
    width = ops.assign_slice_width(n, k, d, torch.float32,
                                   torch.cuda.current_device())
    assert -(-k // width) > 1, "the planted ties need more than one k-slice"
    x, c = (torch.from_numpy(a).to(device) for a in planted_ties(n, k, d, width))
    labels, best = ops.assign(x, c)
    ref_labels, ref_best = assign_ref(x, c)
    torch.cuda.synchronize()
    assert torch.equal(labels, ref_labels) and torch.equal(best, ref_best)
    assert (best[::3] == 0).all()
    # the smallest index among the row's minima
    d2 = pairwise_sq_dists_ref(x, c)
    first = (d2 == d2.min(dim=1, keepdim=True).values).int().argmax(dim=1)
    assert torch.equal(labels.long(), first)


@pytest.mark.parametrize("n,k,d", [(16000, 4099, 9), (777, 1031, 3), (2000, 4099, 20),
                                   (70, 4099, 16)])
def test_assign_at_k_off_the_slice_and_vector_widths(device, n, k, d):
    """k prime: no slice width, vector width or panel of 64 divides it."""
    x, c = _inputs(n, k, d, torch.float32, device, seed=5)
    labels, best = ops.assign(x, c)
    ref_labels, ref_best = assign_ref(x, c)
    torch.cuda.synchronize()
    assert torch.equal(labels, ref_labels) and torch.equal(best, ref_best)


@pytest.mark.parametrize("n,k,d", [(1000, 1025, 9), (1000, 1026, 9), (1000, 1027, 9),
                                   (129, 5, 16), (4_194_305, 5, 3)],
                         ids=["k=1mod4", "k=2mod4", "k=3mod4", "k=5,d=16", "n-past-old-grid"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_pairwise_ragged_vector_stores_and_long_n(device, n, k, d, dtype):
    """k not a multiple of 4 takes scalar stores at the edge; n past K1's
    old 65,535 x 64-row grid runs on the grid-stride design."""
    x, c = _inputs(n, k, d, dtype, device, seed=6)
    got = ops.pairwise_sq_dists(x, c)
    torch.cuda.synchronize()
    assert torch.equal(got, pairwise_sq_dists_ref(x, c))


def test_pairwise_takes_an_output_off_16_byte_alignment(device):
    """An output one float into its storage takes scalar stores."""
    x, c = _inputs(300, 256, 9, torch.float32, device, seed=7)
    lib = ops._kernels()
    out = torch.empty(300 * 256 + 1, device=device)[1:].view(300, 256)
    assert out.data_ptr() % 16
    err = lib.kd_pairwise_sq_dists(x.data_ptr(), c.data_ptr(), out.data_ptr(), 300, 256, 9,
                                   0, out.device.index,
                                   torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert err == 0 and torch.equal(out, pairwise_sq_dists_ref(x, c))


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
    # both take the fused assignment (K2); the (n, k) matrix (K1) is not written
    assert ops.LAUNCHES["pairwise_sq_dists"] == before["pairwise_sq_dists"]
    assert ops.LAUNCHES["assign"] == before["assign"] + 2
    assert float(state.counts.sum()) == 1000 and torch.isfinite(loss)


def test_simulated_cell_carries_the_card_update(device):
    """A serverless cell on the virtual clock whose per-message update runs
    on the card: K2 twice a message, K1 never, the virtual record of the
    same cell without the update, and the model of a replay through the
    plain versions, inertias included, bit for bit."""
    exp = miniapp.StreamExperiment(machine="serverless", partitions=2, points=512,
                                   centroids=64, n_messages=24, seed=3)
    update = KMeansMessageUpdate(64, device=device)
    before = dict(ops.LAUNCHES)
    carried = miniapp.run_experiment(exp, fn=update)
    torch.cuda.synchronize()
    assert update.calls == 24
    assert ops.LAUNCHES["assign"] - before["assign"] == 2 * update.calls
    assert ops.LAUNCHES["pairwise_sq_dists"] == before["pairwise_sq_dists"]
    plain = miniapp.run_experiment(exp)
    assert carried.record() == plain.record()
    assert (carried.des_events, carried.wall_virtual_s) == (plain.des_events,
                                                            plain.wall_virtual_s)
    replay, replay_inertia = update.replay()
    assert torch.equal(replay.centroids, update.state.centroids)
    assert torch.equal(replay.counts, update.state.counts)
    assert torch.equal(torch.stack(replay_inertia), torch.stack(update.inertia))


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
                                         (3, 1, 1, 16), (2, 2, 65, 33),
                                         # Qwen2.5-14B's, GLM-4-9B's and MusicGen's
                                         # prefill heads at S 256
                                         (160, 32, 256, 128), (128, 8, 256, 128),
                                         (96, 96, 256, 64)])
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


# chip_smoke.py's FA_TOLERANCE["bfloat16"]: one bf16 step of the value, since
# K3's bf16 kernel keeps f32 accuracy (exact bf16 products, f32 sums, P split
# hi/lo) and it and mha_ref each round to bf16 once
FA_BF16_TIGHT = {"rtol": 8e-3, "atol": 1e-4}


@pytest.mark.parametrize("qk_scale", [1.0, 8.0], ids=["unit", "scores-to-60"])
def test_flash_attention_bf16_keeps_f32_accuracy_at_the_serving_shape(device, qk_scale):
    """Qwen2-0.5B's prefill shape (BH 56, BKV 8, S 1,024, Dh 64).  With q and k
    scaled x8 the scores spread to tens (standard deviation 64), so the
    running max moves from tile to tile and the online softmax rescales the
    accumulator across tiles."""
    q, k, v = _qkv(56, 8, 1024, 64, torch.float32, device, seed=1)
    q, k, v = (q * qk_scale).bfloat16(), (k * qk_scale).bfloat16(), v.bfloat16()
    got = fa_ops.flash_attention(q, k, v)
    want = mha_ref(q, k, v)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), **FA_BF16_TIGHT)


def test_flash_attention_bf16_takes_rows_off_16_byte_alignment(device):
    """q one element into its storage: its rows are not 16-byte aligned, so
    the kernel stages with plain loads instead of cp.async."""
    q, k, v = _qkv(4, 2, 100, 64, torch.bfloat16, device, seed=2)
    shifted = torch.empty(q.numel() + 1, dtype=q.dtype, device=device)[1:].view(q.shape)
    shifted.copy_(q)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    got = fa_ops.flash_attention(shifted, k, v)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), mha_ref(q, k, v).float(), **FA_BF16_TIGHT)


def test_flash_attention_smem_bytes_by_dtype(device):
    """The f32 kernel stages f32 tiles with a one-float row pad; the bf16
    kernel five bf16 tiles of Dh rounded up to 16 (above 128: to 192 or
    256), plus 8.  Both stay under the card's 232,448 B opt-in limit at
    Dh 256."""
    assert fa_ops.smem_bytes(64, dtype=torch.float32) == (192 * 65 + 64 * 65) * 4
    assert fa_ops.smem_bytes(64, dtype=torch.bfloat16) == 320 * 72 * 2
    assert fa_ops.smem_bytes(40, dtype=torch.bfloat16) == 320 * 56 * 2
    assert fa_ops.smem_bytes(128, dtype=torch.bfloat16) == 320 * 136 * 2
    assert fa_ops.smem_bytes(144, dtype=torch.bfloat16) == 320 * 200 * 2
    assert fa_ops.smem_bytes(256, dtype=torch.bfloat16) == 320 * 264 * 2 == 168_960
    assert fa_ops.smem_bytes(256, dtype=torch.float32) == (192 * 257 + 64 * 65) * 4 == 214_016


# Dh above 128 (the bf16 kernel keeps q in shared memory there; RecurrentGemma's
# Dh 256 with its MQA group of 10) and local windows: one that cuts every kv
# tile (8), one of a tile (64), one that starts mid-tile (100), one longer than
# S (no key masked by it) and RecurrentGemma's 2,048 at S 4,096 (heads cut
# to 10 from its 40 prefill rows)
@pytest.mark.parametrize("bh,bkv,s,dh,window", [
    (4, 2, 130, 144, 0), (4, 1, 100, 200, 0), (10, 1, 256, 256, 0),
    (6, 3, 300, 64, 8), (6, 3, 300, 64, 64), (10, 1, 333, 256, 100),
    (4, 2, 100, 40, 500), (10, 1, 4096, 256, 2048), (3, 1, 1, 256, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_flash_attention_kernel_matches_plain_at_large_dh_and_windows(
        device, bh, bkv, s, dh, window, dtype):
    q, k, v = _qkv(bh, bkv, s, dh, dtype, device, seed=4)
    before = fa_ops.LAUNCHES["flash_attention"]
    got = fa_ops.flash_attention(q, k, v, window=window)
    want = mha_ref(q, k, v, window=window)
    torch.cuda.synchronize()
    assert fa_ops.LAUNCHES["flash_attention"] == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    tight = FA_BF16_TIGHT if dtype == torch.bfloat16 else {"rtol": 2e-5, "atol": 2e-5}
    torch.testing.assert_close(got.float(), want.float(), **tight)


def test_flash_attention_grid_limit_is_by_dtype(device):
    """The f32 kernel puts the q rows BH on grid.y (at most 65,535), the bf16
    kernel its 64-query tiles: bf16 takes BH 65,536, f32 refuses it."""
    q, k, v = _qkv(65_536, 8_192, 16, 8, torch.bfloat16, device, seed=3)
    got = fa_ops.flash_attention(q, k, v)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), mha_ref(q, k, v).float(), **FA_BF16_TIGHT)
    with pytest.raises(ValueError, match="BH=65536"):
        fa_ops.flash_attention(q.float(), k.float(), v.float())


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
    big = torch.zeros(2, 4, 257, device=device)
    with pytest.raises(ValueError, match="Dh=257"):
        fa_ops.flash_attention(big, big, big)
    with pytest.raises(ValueError, match="window"):
        fa_ops.flash_attention(q, k, v, window=-1)


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "granite-moe-3b-a800m",
                                  "qwen3-moe-235b-a22b"])
def test_hybrid_and_moe_forward_launch_the_kernel_once_per_attention_layer(device, arch):
    """The reduced configs on the card: K3 once per attention layer (the
    ``local_attn`` layers with their window), prefill + decode equal to the
    forward pass within the smoke tests' 2e-2."""
    from repro_torch.configs.base import reduced
    from repro_torch.models import model as M

    cfg = reduced(arch)
    params = M.init_params(cfg, torch.Generator(device=device).manual_seed(0), device)
    tokens = torch.randint(0, cfg.vocab_size, (2, 40), device=device)
    n_attn = sum(kind != "rglru" for kind in cfg.layer_kinds)
    before = fa_ops.LAUNCHES["flash_attention"]
    logits = M.forward(params, cfg, tokens)
    torch.cuda.synchronize()
    assert fa_ops.LAUNCHES["flash_attention"] == before + n_attn
    assert logits.shape == (2, 40, cfg.vocab_size) and torch.isfinite(logits).all()
    last, caches = M.prefill(params, cfg, tokens[:, :32], 40)
    torch.testing.assert_close(last, logits[:, 31], rtol=2e-2, atol=2e-2)
    for i in range(32, 36):
        step, caches = M.decode_step(params, cfg, tokens[:, i], caches, i)
        torch.testing.assert_close(step, logits[:, i], rtol=2e-2, atol=2e-2)


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


# -- K3's backward -----------------------------------------------------------

# f32: the forward's 2e-5 (tests/test_kernels.py:64) as rtol, and atol 2e-5
# of the largest entry, since dk and dv sum S·G products in another order
# than mha_bwd_ref.  bf16, derived as chip_smoke.py's FA_TOLERANCE: the
# kernel multiplies bf16 values exactly with f32 sums and enters P and dS as
# hi/lo bf16 pairs (~16 bits each), so it and mha_bwd_ref both compute in
# f32 up to summation order and round to bf16 once: one bf16 step (rtol
# 8e-3), and atol 1e-4 of the largest entry for their f32 differences near
# 0 (the f32 kernel's run ~4e-6 of it at S 1,024; the hi/lo split adds
# ~2**-16).  lse: f32 values up to ~10, the online max and sum against
# logsumexp: a few ulps, atol 1e-5.
FA_BWD_TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (8e-3, 1e-4)}


def _bwd_close(got, want, dtype):
    rtol, share = FA_BWD_TOL[dtype]
    want = want.float()
    torch.testing.assert_close(got.float(), want, rtol=rtol,
                               atol=share * float(want.abs().max()))


def _bwd_inputs(bh, bkv, s, dh, dtype, device, seed=0):
    q, k, v = _qkv(bh, bkv, s, dh, dtype, device, seed)
    rng = np.random.default_rng(seed + 100)
    do = torch.from_numpy(rng.standard_normal((bh, s, dh), dtype=np.float32)).to(device, dtype)
    return q, k, v, do


# (BH, BKV, S, Dh, window): Dh 16 without GQA; Qwen2-0.5B's training shape
# (G 7); a window of 100 at a ragged S (the last rows' windows start past
# whole 64-key tiles); ragged S and Dh; Dh 128 at G 5 (Qwen2.5-14B's group);
# Dh 128 with a window of 8 (most key tiles fully masked for most rows of a
# query tile) at a ragged S; MQA
BWD_SHAPES = [(4, 4, 128, 16, 0), (56, 8, 1024, 64, 0), (14, 2, 300, 64, 100),
              (6, 3, 1000, 40, 0), (20, 4, 256, 128, 0), (8, 4, 520, 128, 8),
              (7, 1, 200, 64, 0)]


@pytest.mark.parametrize("bh,bkv,s,dh,window", BWD_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_flash_attention_backward_matches_plain_and_repeats_bit_for_bit(
        device, bh, bkv, s, dh, window, dtype):
    q, k, v, do = _bwd_inputs(bh, bkv, s, dh, dtype, device)
    out, lse = fa_ops._forward(q, k, v, window, with_lse=True)
    assert torch.equal(out, fa_ops.flash_attention(q, k, v, window=window))   # lse costs nothing
    torch.testing.assert_close(lse, lse_ref(q, k, window=window), rtol=0, atol=1e-5)
    before = fa_ops.LAUNCHES["flash_attention_bwd"]
    got = fa_ops.flash_attention_bwd(q, k, v, out, do, lse, window)
    again = fa_ops.flash_attention_bwd(q, k, v, out, do, lse, window)
    want = mha_bwd_ref(q, k, v, out, do, lse, window=window)
    torch.cuda.synchronize()
    assert fa_ops.LAUNCHES["flash_attention_bwd"] == before + 2
    for g, a, w, x in zip(got, again, want, (q, k, v)):
        assert g.dtype == dtype and g.shape == x.shape and torch.isfinite(g).all()
        assert torch.equal(g, a)                  # no atomics: the same bits
        _bwd_close(g, w, dtype)


def test_flash_attention_trains_through_the_backward_kernel(device):
    """Through autograd: the forward writes lse once, the backward kernel
    runs once, and the gradients are the backward wrapper's; without grad,
    no lse is written."""
    q, k, v, do = _bwd_inputs(14, 2, 300, 64, torch.bfloat16, device, seed=3)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = dict(fa_ops.LAUNCHES)
    lse_before = fa_ops.LSE_WRITES["flash_attention"]
    got = torch.autograd.grad(fa_ops.flash_attention(*leaves, window=100), leaves, do)
    torch.cuda.synchronize()
    assert fa_ops.LAUNCHES["flash_attention"] == before["flash_attention"] + 1
    assert fa_ops.LAUNCHES["flash_attention_bwd"] == before["flash_attention_bwd"] + 1
    assert fa_ops.LSE_WRITES["flash_attention"] == lse_before + 1
    out, lse = fa_ops._forward(q, k, v, 100, with_lse=True)
    for g, w in zip(got, fa_ops.flash_attention_bwd(q, k, v, out, do, lse, 100)):
        assert torch.equal(g, w)
    lse_before = fa_ops.LSE_WRITES["flash_attention"]
    with torch.no_grad():
        fa_ops.flash_attention(*leaves, window=100)
    with torch.inference_mode():
        fa_ops.flash_attention(q, k, v, window=100)
    assert fa_ops.LSE_WRITES["flash_attention"] == lse_before


def test_flash_attention_refuses_a_gradient_above_dh_128(device):
    q, k, v = _qkv(4, 1, 64, 256, torch.bfloat16, device)
    q.requires_grad_(True)
    with pytest.raises(NotImplementedError, match="Dh=256"):
        fa_ops.flash_attention(q, k, v)
    with torch.no_grad():
        assert torch.isfinite(fa_ops.flash_attention(q, k, v)).all()   # serving still runs


def test_flash_attention_backward_smem_bytes(device):
    """(b) stages k, v, q and dO tiles and lse and D rows; (c) the four
    tiles; f32 also P and dS tiles (a one-float row pad).  Under the
    232,448 B opt-in limit at Dh 128."""
    assert fa_ops.bwd_smem_bytes(64, dtype=torch.bfloat16) == {
        "dkdv": 256 * 72 * 2 + 2 * 64 * 4, "dq": 256 * 72 * 2}
    assert fa_ops.bwd_smem_bytes(128, dtype=torch.float32) == {
        "dkdv": (256 * 129 + 2 * 64 * 65 + 128) * 4, "dq": (256 * 129 + 64 * 65) * 4}
    assert max(fa_ops.bwd_smem_bytes(128, dtype=torch.float32).values()) <= 232_448


def test_loss_gradients_on_the_card_match_the_cpu(device):
    """Reduced Qwen2-0.5B in float32: ``loss_fn``'s gradient through K3 and
    its backward kernel on the card against the plain versions on the CPU,
    each leaf within the CPU parity test's 1e-4 of its largest entry; K3
    forward and backward once per layer."""
    import copy
    import dataclasses

    from repro_torch.configs.base import reduced
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import model as M
    from repro_torch.training.train_loop import batch_to

    cfg = dataclasses.replace(reduced("qwen2-0.5b"), dtype="float32")
    cpu = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    cpu.requires_grad_(True)
    card = copy.deepcopy(cpu).to(device)
    batch = SyntheticLM(cfg.vocab_size, 100, 2, seed=1).batch_at(0)
    grads = []
    before = dict(fa_ops.LAUNCHES)
    for params, dev in ((cpu, "cpu"), (card, device)):
        leaves = list(params.parameters())
        loss = M.loss_fn(params, cfg, batch_to(batch, dev))
        grads.append([loss] + list(torch.autograd.grad(loss, leaves)))
    torch.cuda.synchronize()
    assert fa_ops.LAUNCHES["flash_attention"] == before["flash_attention"] + cfg.n_layers
    assert fa_ops.LAUNCHES["flash_attention_bwd"] == before["flash_attention_bwd"] + cfg.n_layers
    for want, got in zip(*grads):
        got = got.detach().cpu()
        assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max()) + 1e-6


# -- K4 ssd_scan -------------------------------------------------------------

SSD_TOL = 2e-4                                           # tests/test_kernels.py:96-99's


def _ssd_inputs(b, s, h, p, n, device, seed=0, with_h0=False):
    """Drawn as tests/test_kernels.py:87-92 draws them."""
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal((b, s, h, p), dtype=np.float32),
              np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32),
              -np.exp(0.5 * rng.standard_normal(h)).astype(np.float32),
              rng.standard_normal((b, s, n), dtype=np.float32),
              rng.standard_normal((b, s, n), dtype=np.float32)]
    if with_h0:
        arrays.append(rng.standard_normal((b, h, p, n), dtype=np.float32))
    return [torch.from_numpy(a).to(device) for a in arrays]


# (b, s, h, p, n, chunk, h0): the Mamba2-130M serving shape, a ragged S
# against the kernels' 64-position chunk, h0 given, P/N/H off the tiles;
# several 256-position spans with a ragged last span and h0, and several
# spans at MAX_STATE
@pytest.mark.parametrize("b,s,h,p,n,chunk,with_h0", [
    (4, 1024, 24, 64, 128, 256, False), (1, 100, 24, 64, 128, 256, False),
    (2, 256, 3, 64, 128, 256, True), (2, 100, 5, 20, 33, 100, True),
    (1, 1, 1, 1, 1, 1, False), (3, 192, 7, 48, 16, 64, False),
    (1, 130, 2, 16, 256, 130, True), (2, 700, 5, 64, 128, 700, True),
    (1, 1024, 2, 32, 256, 256, True)])
def test_ssd_scan_kernel_matches_plain(device, b, s, h, p, n, chunk, with_h0):
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan.ref import ssd_ref

    x, dt, A, Bm, Cm, *h0 = _ssd_inputs(b, s, h, p, n, device, with_h0=with_h0)
    h0 = h0[0] if h0 else None
    before = ssd_ops.LAUNCHES["ssd_scan"]
    y, hT = ssd_ops.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk, h0=h0)
    torch.cuda.synchronize()
    assert ssd_ops.LAUNCHES["ssd_scan"] == before + 1
    assert y.shape == x.shape and hT.shape == (b, h, p, n) and y.dtype == torch.float32
    want_y, want_h = ssd_ref(x, dt, A, Bm, Cm, h0)
    torch.testing.assert_close(y, want_y, rtol=SSD_TOL, atol=SSD_TOL)
    torch.testing.assert_close(hT, want_h, rtol=SSD_TOL, atol=SSD_TOL)


def test_ssd_scan_kernel_keeps_digits_where_heads_decay_fast(device):
    """A = -4 exp(0.5 normal): running sums of dt·A reach -1,000 within a
    chunk, where decays formed as differences of running sums lose digits;
    held against the float64 recurrence."""
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan.ref import ssd_ref

    x, dt, A, Bm, Cm = _ssd_inputs(4, 1024, 24, 64, 128, device, seed=3)
    A = 4 * A
    y, hT = ssd_ops.ssd_scan(x, dt, A, Bm, Cm, chunk=256)
    want_y, want_h = ssd_ref(*(t.double() for t in (x, dt, A, Bm, Cm)))
    torch.testing.assert_close(y.double(), want_y, rtol=SSD_TOL, atol=SSD_TOL)
    torch.testing.assert_close(hT.double(), want_h, rtol=SSD_TOL, atol=SSD_TOL)


def test_ssd_scan_takes_operands_off_16_byte_alignment(device):
    """x, B and C one element into their storage: not 16-byte aligned, so
    the kernels stage them (and the span states) with plain loads instead of
    cp.async."""
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan.ref import ssd_ref

    x, dt, A, Bm, Cm, h0 = _ssd_inputs(2, 600, 3, 64, 128, device, seed=4, with_h0=True)

    def shifted(t):
        out = torch.empty(t.numel() + 1, dtype=t.dtype, device=device)[1:].view(t.shape)
        out.copy_(t)
        return out

    xs, Bs, Cs = shifted(x), shifted(Bm), shifted(Cm)
    assert all(t.is_contiguous() and t.data_ptr() % 16 for t in (xs, Bs, Cs))
    y, hT = ssd_ops.ssd_scan(xs, dt, A, Bs, Cs, chunk=600, h0=h0)
    want_y, want_h = ssd_ref(x, dt, A, Bm, Cm, h0)
    torch.cuda.synchronize()
    torch.testing.assert_close(y, want_y, rtol=SSD_TOL, atol=SSD_TOL)
    torch.testing.assert_close(hT, want_h, rtol=SSD_TOL, atol=SSD_TOL)


@pytest.mark.parametrize("n", [16, 128, 256])
def test_ssd_scan_smem_bytes_reports_every_phase_within_the_limit(device, n):
    """One entry per CUDA kernel of a call, each within a block's 227 KB of
    dynamic shared memory; the state-passing phase uses none."""
    from repro_torch.kernels.ssd_scan import ops as ssd_ops

    smem = ssd_ops.smem_bytes(n)
    assert tuple(smem) == ssd_ops.PHASES == ("state", "pass", "out")
    assert smem["pass"] == 0
    assert all(0 <= v <= 227 * 1024 for v in smem.values())
    assert min(smem["state"], smem["out"]) > 0


def test_ssd_scan_wrapper_rejects_what_the_kernel_does_not_take(device):
    from repro_torch.kernels.ssd_scan import ops as ssd_ops

    x, dt, A, Bm, Cm = _ssd_inputs(2, 64, 3, 16, 8, device)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_ops.ssd_scan(x.transpose(1, 2).contiguous().transpose(1, 2), dt, A, Bm, Cm,
                         chunk=64)
    with pytest.raises(ValueError, match="operands on"):
        ssd_ops.ssd_scan(x, dt, A.cpu(), Bm, Cm, chunk=64)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ssd_ops.ssd_scan(x, dt, A, Bm, Cm, chunk=48)
    with pytest.raises(TypeError):
        ssd_ops.ssd_scan(x.bfloat16(), dt, A, Bm, Cm, chunk=64)


def test_ssd_scan_refuses_inputs_that_require_grad(device):
    """K4 has no backward: with a gradient asked for it raises rather than
    return outputs through which training would get no gradient."""
    from repro_torch.kernels.ssd_scan import ops as ssd_ops

    x, dt, A, Bm, Cm = _ssd_inputs(1, 64, 2, 8, 16, device)
    before = ssd_ops.LAUNCHES["ssd_scan"]
    for t in (x, A):
        t.requires_grad_(True)
        with pytest.raises(NotImplementedError, match="K4's backward"):
            ssd_ops.ssd_scan(x, dt, A, Bm, Cm, chunk=64)
        t.requires_grad_(False)
    assert ssd_ops.LAUNCHES["ssd_scan"] == before
    x.requires_grad_(True)
    with torch.no_grad():
        y, _ = ssd_ops.ssd_scan(x, dt, A, Bm, Cm, chunk=64)
    assert y.grad_fn is None and ssd_ops.LAUNCHES["ssd_scan"] == before + 1


def test_train_refuses_mamba2_on_the_card_before_any_update(device):
    """The launcher owns no refusal of its own: K4's wrapper raises in the
    first step's forward, so no update runs and no K4 launch is made."""
    from repro_torch.configs.base import reduced
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.launch.train import train

    before = ssd_ops.LAUNCHES["ssd_scan"]
    with pytest.raises(NotImplementedError, match="K4's backward"):
        train(reduced("mamba2-130m"), steps=1, batch=1, seq=32, device=device,
              log=lambda line: None)
    assert ssd_ops.LAUNCHES["ssd_scan"] == before


def test_mamba_forward_launches_the_kernel_once_per_layer(device):
    from repro_torch.configs.base import reduced
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.models import model as M

    cfg = reduced("mamba2-130m")
    params = M.init_params(cfg, torch.Generator(device=device).manual_seed(0), device)
    tokens = torch.randint(0, cfg.vocab_size, (2, 48), device=device)
    before = ssd_ops.LAUNCHES["ssd_scan"]
    logits = M.forward(params, cfg, tokens)
    torch.cuda.synchronize()
    assert ssd_ops.LAUNCHES["ssd_scan"] == before + cfg.n_layers
    assert logits.shape == (2, 48, cfg.vocab_size) and torch.isfinite(logits).all()


# -- the USL fit on the card (float64 batched Levenberg–Marquardt) -------------

USL_NS = np.array([1, 2, 4, 8, 16, 32, 64], dtype=np.float64)


def _usl_batch(seed, s):
    """``tests/test_usl.py::_synth_batch``'s draws, through the port's
    ``usl_throughput``."""
    from repro_torch.core.usl import usl_throughput

    rng = np.random.default_rng(seed)
    sigma, kappa = rng.uniform(0.0, 0.7, s), rng.uniform(0.0, 0.02, s)
    gamma = rng.uniform(0.2, 30.0, s)
    t = usl_throughput(USL_NS[None, :], sigma[:, None], kappa[:, None], gamma[:, None])
    return np.broadcast_to(USL_NS, (s, USL_NS.size)), t * rng.lognormal(0.0, 0.05, t.shape)


@pytest.mark.parametrize("bootstrap", [0, 64])
def test_usl_fit_on_the_card_matches_numpy(device, bootstrap):
    from repro_torch.core.usl import fit_usl_batch

    n, t = _usl_batch(0, 256)
    got = fit_usl_batch(n, t, backend="torch", device=device, bootstrap=bootstrap)
    want = fit_usl_batch(n, t, bootstrap=bootstrap)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.predict(USL_NS), w.predict(USL_NS), rtol=1e-6, atol=0)
        assert abs(g.sigma - w.sigma) <= 1e-6 and abs(g.kappa - w.kappa) <= 1e-7
        assert abs(g.gamma - w.gamma) <= 1e-6 * w.gamma
        if bootstrap:
            assert all(abs(a - b) <= 1e-6 for a, b in zip(g.sigma_ci, w.sigma_ci))
            assert all(abs(a - b) <= 1e-7 for a, b in zip(g.kappa_ci, w.kappa_ci))
            assert all(a == b or abs(a - b) <= 1e-6 * abs(b)
                       for a, b in zip(g.peak_n_ci, w.peak_n_ci))


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal where no CUDA card is present")


def test_usl_fit_on_cuda_without_a_card_raises(no_card):
    from repro_torch.core.usl import fit_usl_batch

    n, t = _usl_batch(1, 4)
    with pytest.raises(RuntimeError, match="cuda"):
        fit_usl_batch(n, t, backend="torch", device="cuda")


# -- lockstep seed scans ------------------------------------------------------------

LOCK_CELL = dict(machine="serverless", scaling_policy="static", static_partitions=1,
                 horizon_s=60.0, rate=dict(kind="step", base_hz=2.0, high_hz=4.0, t_step=30.0))
GRID_CELL = dict(machine="serverless", scaling_policy="usl", usl_sigma=0.0, usl_kappa=3.0e-4,
                 usl_gamma=1.94, horizon_s=90.0, max_partitions=16, slo_lag=32,
                 control_interval_s=2.0, stabilization_s=0.0, scale_down_hysteresis=0.08,
                 headroom=0.0, catchup_horizon_s=8.0, refit_interval_s=5.0, max_step_up=2,
                 drift_t_s=25.0, drift_factor=1.8, refit_half_life_s=25.0,
                 rate=dict(kind="step", base_hz=2.0, high_hz=10.0, t_step=15.0, t_end=70.0))
LOCKSTEP_TOL = 1e-5      # the chain's expf on the card against torch.exp


def _grid_inputs(s, n, n_parts, n_conts, device, seed=0):
    rng = np.random.default_rng(seed)
    floors = np.cumsum(rng.exponential(0.1, n)).astype(np.float32)
    parts = rng.integers(0, n_parts, n).astype(np.int32)
    conts = rng.integers(0, n_conts, n).astype(np.int32)
    dt = rng.uniform(0.05, 0.6, (s, n)).astype(np.float32)
    return [torch.from_numpy(a).to(device) for a in (floors, parts, conts, dt)]


@pytest.mark.parametrize("s,n", [(8, 1251), (1024, 1251), (33, 7), (1, 1)])
def test_lockstep_chain_kernel_matches_plain(device, s, n):
    from repro_torch.kernels.lockstep_scan import ops as ls_ops
    from repro_torch.kernels.lockstep_scan.ref import lockstep_scan_ref

    rng = np.random.default_rng(s + n)
    appends = torch.from_numpy(np.cumsum(rng.exponential(0.3, n)).astype(np.float32)).to(device)
    means = torch.from_numpy(rng.uniform(0.1, 0.5, n).astype(np.float32)).to(device)
    z = torch.from_numpy(rng.standard_normal((s, n)).astype(np.float32)).to(device)
    before = ls_ops.LAUNCHES["lockstep_scan"]
    got = ls_ops.lockstep_scan(appends, means, z, -0.0198, 0.1990)
    torch.cuda.synchronize()
    assert ls_ops.LAUNCHES["lockstep_scan"] == before + 1
    want = lockstep_scan_ref(appends, means, z, -0.0198, 0.1990)
    torch.testing.assert_close(got, want, rtol=LOCKSTEP_TOL, atol=0)


@pytest.mark.parametrize("s,n,n_parts,n_conts", [(8, 1251, 11, 12), (1024, 1251, 16, 40),
                                                 (40, 300, 4, 2000), (3, 5, 1, 1)])
def test_grid_lockstep_kernel_is_bit_equal_to_plain(device, s, n, n_parts, n_conts):
    from repro_torch.kernels.lockstep_scan import ops as ls_ops
    from repro_torch.kernels.lockstep_scan.ref import grid_lockstep_scan_ref

    floors, parts, conts, dt = _grid_inputs(s, n, n_parts, n_conts, device)
    before = ls_ops.LAUNCHES["grid_lockstep_scan"]
    got = ls_ops.grid_lockstep_scan(floors, parts, conts, dt, n_parts, n_conts)
    torch.cuda.synchronize()
    assert ls_ops.LAUNCHES["grid_lockstep_scan"] == before + 1
    # max and a correctly rounded add: the same float32 values in any order
    assert torch.equal(got, grid_lockstep_scan_ref(floors, parts, conts, dt, n_parts, n_conts))


def test_grid_lockstep_kernel_marks_an_index_out_of_range(device):
    from repro_torch.kernels.lockstep_scan import ops as ls_ops

    floors, parts, conts, dt = _grid_inputs(4, 50, 3, 3, device)
    parts[10] = 3
    got = ls_ops.grid_lockstep_scan(floors, parts, conts, dt, 3, 3)
    assert torch.isnan(got[:, 10]).all() and not torch.isnan(got[:, :10]).any()


def test_lockstep_entry_points_run_the_kernels_on_the_card(device):
    from repro_torch.core.miniapp import AdaptationExperiment
    from repro_torch.kernels.lockstep_scan import ops as ls_ops
    from repro_torch.sim import batched

    before = dict(ls_ops.LAUNCHES)
    seeds = list(range(16))
    exp = AdaptationExperiment(seed=0, **LOCK_CELL)
    got = batched.lockstep_completion_times(exp, seeds, device="cuda")
    want = batched.lockstep_completion_times(exp, seeds, device="cpu")
    np.testing.assert_allclose(got, want, rtol=LOCKSTEP_TOL, atol=0)
    grid = AdaptationExperiment(seed=0, **GRID_CELL)
    fins, ref_fin = batched.grid_lockstep_completion_times(grid, seeds, with_reference=True,
                                                           device="cuda")
    assert np.array_equal(fins, batched.grid_lockstep_completion_times(grid, seeds,
                                                                       device="cpu"))
    err = np.abs(fins[0].astype(np.float64) - ref_fin) / np.maximum(ref_fin, 1e-9)
    assert float(err.max()) <= batched.LOCKSTEP_RTOL
    assert ls_ops.LAUNCHES == {"lockstep_scan": before["lockstep_scan"] + 1,
                               "grid_lockstep_scan": before["grid_lockstep_scan"] + 1}
