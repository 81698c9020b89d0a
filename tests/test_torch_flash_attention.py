"""The port's flash-attention wrapper (K3) on CPU tensors, against the JAX
package's Pallas kernel run in interpret mode and against the plain versions.

On the CPU the wrapper runs its plain version ``mha_ref``; the CUDA kernel
is held against that same plain version on the card
(``tests/test_torch_kernels_cuda.py``).  Inputs come from numpy.  Shapes are
``tests/test_kernels.py``'s, plus Qwen2-0.5B's group size G = 7 and a ragged
S that the reference pads and the port does not.  Tolerances are
``tests/test_kernels.py``'s: 2e-5 in float32, 3e-2 in bfloat16 (the output
is rounded to bfloat16 in both packages, at different points).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as jax_ops
from repro.kernels.flash_attention.ref import mha_ref as jax_mha_ref
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import NEG_INF, mha_ref

from _tf32 import tf32_mm

SHAPES = [(4, 4, 128, 64), (8, 2, 256, 64), (2, 1, 64, 128), (6, 3, 96, 40),
          (14, 2, 48, 64), (6, 3, 100, 40)]
TOL = {"float32": 2e-5, "bfloat16": 3e-2}
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _qkv(bh, bkv, s, dh, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape, dtype=np.float32)
            for shape in ((bh, s, dh), (bkv, s, dh), (bkv, s, dh))]


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("bh,bkv,s,dh", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matches_jax_pallas_kernel_in_interpret_mode(bh, bkv, s, dh, dtype):
    jdt, tdt = DTYPES[dtype]
    arrays = _qkv(bh, bkv, s, dh)
    jq, jk, jv = (jnp.asarray(a, jdt) for a in arrays)
    want = jax_ops.flash_attention(jq, jk, jv, use_pallas=True, interpret=True,
                                   block_q=32, block_k=32)
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in arrays)
    before = ops.LAUNCHES["flash_attention"]
    got = ops.flash_attention(tq, tk, tv)
    assert got.dtype == tdt and got.shape == (bh, s, dh)
    assert ops.LAUNCHES["flash_attention"] == before       # no kernel on the CPU
    _close(got.float().numpy(), want, TOL[dtype])


@pytest.mark.parametrize("bh,bkv,s,dh", SHAPES)
def test_plain_version_matches_jax_mha_ref(bh, bkv, s, dh):
    arrays = _qkv(bh, bkv, s, dh, seed=1)
    want = jax_mha_ref(*(jnp.asarray(a) for a in arrays))
    got = mha_ref(*(torch.from_numpy(a) for a in arrays))
    _close(got.numpy(), want, TOL["float32"])
    want_full = jax_mha_ref(*(jnp.asarray(a) for a in arrays), causal=False)
    got_full = mha_ref(*(torch.from_numpy(a) for a in arrays), causal=False)
    _close(got_full.numpy(), want_full, TOL["float32"])


def test_wrapper_checks_what_the_kernel_takes():
    q, k, v = (torch.from_numpy(a) for a in _qkv(4, 2, 16, 8))
    with pytest.raises(ValueError, match="multiple"):
        ops.flash_attention(q[:3], k, v)
    with pytest.raises(ValueError, match="contiguous"):        # the same contract as on the card
        ops.flash_attention(q.transpose(0, 1).contiguous().transpose(0, 1), k, v)
    with pytest.raises(ValueError, match="disagree"):
        ops.flash_attention(q[:, :8], k, v)
    with pytest.raises(ValueError, match="Dh"):
        big = torch.zeros(2, 4, 257)
        ops.flash_attention(big, big, big)
    with pytest.raises(ValueError, match="window"):
        ops.flash_attention(q, k, v, window=-1)
    with pytest.raises(TypeError):
        ops.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(NotImplementedError, match="causal"):
        ops.flash_attention(q, k, v, causal=False)
    with pytest.raises(ValueError, match="no kernel"):
        ops.flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))


def test_smem_bytes_takes_only_the_kernels_dtypes():
    with pytest.raises(TypeError, match="float16"):
        ops.smem_bytes(64, dtype=torch.float16)


# chip_smoke.py's FA_TOLERANCE["bfloat16"], which the card's bf16 kernel meets
FA_BF16_TIGHT = {"rtol": 8e-3, "atol": 1e-4}


def _bf16_kernel_arithmetic(q, k, v, split_p):
    """The bf16 kernel's arithmetic on the CPU: f32 scores from the bf16
    inputs (their products are exact in f32), P = exp(S - row max) in f32,
    l summed from that P, and O from P's bf16 parts (hi and lo with
    ``split_p``, hi alone without) times V, summed in f32.  One row max in
    place of the kernel's running one: rescaling by exp(m_old - m_new)
    leaves P's relative rounding as it is."""
    bh, s, dh = q.shape
    g = bh // k.shape[0]
    kf, vf = (x.float().repeat_interleave(g, dim=0) for x in (k, v))
    scores = torch.bmm(q.float(), kf.transpose(1, 2)) * (1.0 / math.sqrt(dh))
    causal = torch.ones((s, s), dtype=torch.bool).tril()
    scores = torch.where(causal, scores, torch.full_like(scores, NEG_INF))
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    hi = p.bfloat16().float()
    o = torch.bmm(hi, vf)
    if split_p:
        o = o + torch.bmm((p - hi).bfloat16().float(), vf)
    return (o / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)).bfloat16()


def test_p_split_is_what_keeps_the_bf16_kernel_within_its_tolerance():
    """Why the bf16 kernel splits P into two bf16 parts for PV: with the
    split its arithmetic meets FA_BF16_TIGHT against ``mha_ref`` at every
    output; a single bf16 P (~2**-9 of each probability) misses it at a
    share of them, mostly outputs near 0, where only atol holds."""
    q, k, v = (torch.from_numpy(a).bfloat16() for a in _qkv(14, 2, 512, 64, seed=3))
    want = mha_ref(q, k, v).float()

    def misses(split_p):
        got = _bf16_kernel_arithmetic(q, k, v, split_p).float()
        bound = FA_BF16_TIGHT["atol"] + FA_BF16_TIGHT["rtol"] * want.abs()
        return int(((got - want).abs() > bound).sum())

    assert misses(split_p=True) == 0
    assert misses(split_p=False) > want.numel() // 100


# chip_smoke.py's FA_TOLERANCE["float32"] (tests/test_kernels.py:64's 2e-5),
# which the card's f32 kernel meets against mha_ref
FA_F32_TOL = {"rtol": 2e-5, "atol": 2e-5}


def _masked(scores, s, window):
    i = torch.arange(s)
    seen = (i[None, :] <= i[:, None]) & ((i[None, :] > i[:, None] - window) if window else True)
    return torch.where(seen, scores, torch.full_like(scores, NEG_INF))


def _f32_kernel_arithmetic(q, k, v, window, split):
    """The f32 kernel's arithmetic on the CPU: S = (q scale) K^T and O = P V
    with every product through ``tf32_mm`` (3xTF32 with ``split``, one TF32
    pass without), P = exp(S - row max) and l = sum P in f32, O / l.  One
    row max in place of the kernel's running one, as in
    ``_bf16_kernel_arithmetic``."""
    bh, s, dh = q.shape
    g = bh // k.shape[0]
    kf, vf = (x.repeat_interleave(g, dim=0) for x in (k, v))
    scores = _masked(tf32_mm(q * (1.0 / math.sqrt(dh)), kf.transpose(1, 2), split), s, window)
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    return tf32_mm(p, vf, split) / p.sum(dim=-1, keepdim=True)


def _attention_f64(q, k, v, window):
    bh, s, dh = q.shape
    g = bh // k.shape[0]
    kf, vf = (x.double().repeat_interleave(g, dim=0) for x in (k, v))
    scores = _masked(q.double() @ kf.transpose(1, 2) / math.sqrt(dh), s, window)
    return torch.softmax(scores, dim=-1) @ vf


@pytest.mark.parametrize("dh,window", [(64, 0), (128, 0), (256, 0), (64, 100)],
                         ids=["dh64", "dh128", "dh256", "dh64-window100"])
def test_tf32x3_keeps_the_f32_forward_within_its_tolerance(dh, window):
    """Why the f32 kernel runs each product as three TF32 products of hi/lo
    parts: that arithmetic meets FA_F32_TOL against float64 with room to
    spare (worst share of the tolerance <= 0.25), where one TF32 pass
    misses it."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(4, 2, 512, dh, seed=5))
    want = _attention_f64(q, k, v, window)

    def worst(split):
        got = _f32_kernel_arithmetic(q, k, v, window, split).double()
        return float(((got - want).abs()
                      / (FA_F32_TOL["atol"] + FA_F32_TOL["rtol"] * want.abs())).max())

    assert worst(split=True) <= 0.25
    assert worst(split=False) > 1.0


def test_cuda_request_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the missing-card path cannot be taken")
    from repro_torch.configs.base import reduced
    from repro_torch.models import model as M

    with pytest.raises(RuntimeError, match="cuda"):
        M.init_params(reduced("qwen2-0.5b"), torch.Generator().manual_seed(0), device="cuda")
