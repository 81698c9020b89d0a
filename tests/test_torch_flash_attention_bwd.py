"""K3's gradient on the CPU: the plain backward ``mha_bwd_ref`` (the
explicit formulas from the saved log-sum-exp, which the CUDA backward kernel
is held to on the card) against autograd of the port's ``mha_ref`` and
against ``jax.grad`` of the JAX package's ``mha_ref``; and the
``torch.autograd.Function`` that carries the kernels, driven on CPU tensors
with its two launches replaced by their plain versions.

Inputs and the output's cotangent come from numpy with a seed.  Shapes
cover GQA groups 1, 2 and 7 (Qwen2-0.5B's), a window that masks whole
64-key tiles for some rows, and a ragged S.  Tolerance: float32, rtol 1e-5,
with atol 1e-5 of the largest gradient entry, since dk and dv sum S·G
products and their f32 summation order differs between the explicit
formulas and autograd's (or XLA's) chain.  The reference's ``mha_ref`` has
no window, so the window cases are held to the port's autograd only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ref import mha_ref as jax_mha_ref
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import lse_ref, mha_bwd_ref, mha_ref

RTOL, ATOL_SHARE = 1e-5, 1e-5
# (BH, BKV, S, Dh, window)
CASES = [(3, 3, 40, 16, 0), (4, 2, 64, 32, 0), (14, 2, 50, 16, 0), (7, 1, 67, 24, 0),
         (4, 2, 150, 16, 8), (14, 2, 130, 16, 70)]
IDS = ["g1", "g2", "g7", "g7-ragged", "window8", "g7-window70"]


def _inputs(bh, bkv, s, dh, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape, dtype=np.float32)
            for shape in ((bh, s, dh), (bkv, s, dh), (bkv, s, dh), (bh, s, dh))]


def _close(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL_SHARE * np.abs(want).max())


def _autograd(q, k, v, do, window):
    q, k, v = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out = mha_ref(q, k, v, window=window)
    return torch.autograd.grad(out, (q, k, v), torch.from_numpy(do))


def _explicit(q, k, v, do, window):
    q, k, v, do = (torch.from_numpy(a) for a in (q, k, v, do))
    out = mha_ref(q, k, v, window=window)
    return mha_bwd_ref(q, k, v, out, do, lse_ref(q, k, window=window), window=window)


@pytest.mark.parametrize("bh,bkv,s,dh,window", CASES, ids=IDS)
def test_mha_bwd_ref_matches_autograd_of_mha_ref(bh, bkv, s, dh, window):
    q, k, v, do = _inputs(bh, bkv, s, dh)
    for got, want in zip(_explicit(q, k, v, do, window), _autograd(q, k, v, do, window)):
        _close(got, want)


@pytest.mark.parametrize("bh,bkv,s,dh,window", [c for c in CASES if not c[-1]],
                         ids=[i for c, i in zip(CASES, IDS) if not c[-1]])
def test_mha_bwd_ref_matches_jax_grad_of_the_reference(bh, bkv, s, dh, window):
    q, k, v, do = _inputs(bh, bkv, s, dh, seed=1)
    _, vjp = jax.vjp(jax_mha_ref, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for got, want in zip(_explicit(q, k, v, do, 0), vjp(jnp.asarray(do))):
        _close(got, want)


def test_lse_ref_reproduces_the_softmax():
    q, k, v, _ = _inputs(14, 2, 90, 16)
    q, k, v = (torch.from_numpy(a) for a in (q, k, v))
    for window in (0, 20):
        lse = lse_ref(q, k, window=window)
        idx = torch.arange(90)
        mask = (idx[None] <= idx[:, None]) & (idx[None] > idx[:, None] - (window or 90))
        s = torch.bmm(q / 4.0, k.repeat_interleave(7, 0).transpose(1, 2))
        p = torch.where(mask, torch.exp(s - lse[..., None]), torch.zeros(()))
        out = torch.bmm(p, v.repeat_interleave(7, 0))
        torch.testing.assert_close(out, mha_ref(q, k, v, window=window), rtol=1e-5, atol=1e-6)


@pytest.fixture
def plain_launches(monkeypatch):
    """``_FlashAttention``'s two launches replaced by their plain versions,
    counted, so the Function runs on CPU tensors."""
    calls = {"forward": [], "backward": 0}

    def forward(q, k, v, window, with_lse):
        calls["forward"].append(with_lse)
        return mha_ref(q, k, v, window=window), lse_ref(q, k, window=window)

    def backward(q, k, v, out, dout, lse, window=0):
        calls["backward"] += 1
        assert dout.is_contiguous() and lse.dtype == torch.float32
        return mha_bwd_ref(q, k, v, out, dout, lse, window=window)

    monkeypatch.setattr(ops, "_forward", forward)
    monkeypatch.setattr(ops, "flash_attention_bwd", backward)
    return calls


@pytest.mark.parametrize("bh,bkv,s,dh,window", [CASES[2], CASES[5]], ids=["g7", "g7-window70"])
def test_autograd_function_carries_the_kernels_gradient(plain_launches, bh, bkv, s, dh, window):
    """The Function saves what its backward reads and hands back dq, dk, dv
    for q, k, v (the cotangent here arrives non-contiguous, as the model's
    head-major transpose gives it)."""
    q, k, v, do = _inputs(bh, bkv, s, dh, seed=2)
    want = _autograd(q, k, v, do, window)
    qt, kt, vt = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out = ops._FlashAttention.apply(qt, kt, vt, window)
    cot = torch.from_numpy(np.ascontiguousarray(do.transpose(1, 0, 2))).transpose(0, 1)
    assert not cot.is_contiguous()
    got = torch.autograd.grad(out, (qt, kt, vt), cot)
    assert plain_launches == {"forward": [True], "backward": 1}
    for g, w in zip(got, want):
        _close(g, w)


def test_wrapper_on_the_cpu_differentiates_the_plain_version():
    q, k, v, do = _inputs(14, 2, 50, 16, seed=3)
    qt, kt, vt = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    before = dict(ops.LAUNCHES)
    got = torch.autograd.grad(ops.flash_attention(qt, kt, vt), (qt, kt, vt),
                              torch.from_numpy(do))
    assert ops.LAUNCHES == before                  # no kernel on the CPU
    for g, w in zip(got, _autograd(q, k, v, do, 0)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
