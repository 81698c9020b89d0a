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

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as jax_ops
from repro.kernels.flash_attention.ref import mha_ref as jax_mha_ref
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import mha_ref

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
        big = torch.zeros(2, 4, 130)
        ops.flash_attention(big, big, big)
    with pytest.raises(TypeError):
        ops.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(NotImplementedError, match="causal"):
        ops.flash_attention(q, k, v, causal=False)
    with pytest.raises(ValueError, match="no kernel"):
        ops.flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))


def test_cuda_request_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the missing-card path cannot be taken")
    from repro_torch.configs.base import reduced
    from repro_torch.models import model as M

    with pytest.raises(RuntimeError, match="cuda"):
        M.init_params(reduced("qwen2-0.5b"), torch.Generator().manual_seed(0), device="cuda")
