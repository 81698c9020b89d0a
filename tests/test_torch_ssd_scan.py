"""The port's SSD scan (K4's wrapper and plain versions) on CPU tensors,
against the JAX package's Pallas kernel run in interpret mode and against
its plain versions.

On the CPU the wrapper runs its plain version ``models.ssm.ssd_chunked``;
the CUDA kernel is held against ``ssd_ref`` on the card
(``tests/test_torch_kernels_cuda.py``).  Inputs come from numpy, drawn as
``tests/test_kernels.py`` draws them (x, B, C standard normal; dt the
softplus of a normal; A = -exp(0.5 normal)).  The tolerance is
``tests/test_kernels.py``'s 2e-4 (float32 sums in other orders).  Sequence
lengths are multiples of ``min(chunk, S)``, which the reference asserts.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan import ops as jax_ops
from repro.kernels.ssd_scan.ref import ssd_ref as jax_ssd_ref
from repro.models.ssm import ssd_chunked as jax_ssd_chunked
from repro_torch.kernels.ssd_scan import ops
from repro_torch.kernels.ssd_scan.ref import ssd_ref
from repro_torch.models.ssm import ssd_chunked, ssd_recurrent

TOL = 2e-4
# (b, s, h, p, n, chunk): tests/test_kernels.py's, S below the chunk, and
# Mamba2-130M's P and N at a short S
SHAPES = [(2, 64, 3, 16, 8, 16), (1, 128, 2, 32, 16, 32), (2, 96, 4, 8, 4, 32),
          (2, 40, 3, 16, 8, 64), (1, 64, 2, 64, 128, 32)]


def _inputs(b, s, h, p, n, seed=0, with_h0=False):
    rng = np.random.default_rng(seed)
    out = [rng.standard_normal((b, s, h, p), dtype=np.float32),
           np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32),
           -np.exp(0.5 * rng.standard_normal(h)).astype(np.float32),
           rng.standard_normal((b, s, n), dtype=np.float32),
           rng.standard_normal((b, s, n), dtype=np.float32)]
    if with_h0:
        out.append(rng.standard_normal((b, h, p, n), dtype=np.float32))
    return out


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=TOL, atol=TOL)


def _torch(arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("b,s,h,p,n,chunk", SHAPES)
def test_wrapper_matches_jax_pallas_kernel_in_interpret_mode(b, s, h, p, n, chunk):
    arrays = _inputs(b, s, h, p, n)
    want_y, want_h = jax_ops.ssd_scan(*(jnp.asarray(a) for a in arrays), chunk=chunk,
                                      use_pallas=True, interpret=True)
    before = ops.LAUNCHES["ssd_scan"]
    y, hT = ops.ssd_scan(*_torch(arrays), chunk=chunk)
    assert ops.LAUNCHES["ssd_scan"] == before            # no kernel on the CPU
    assert y.dtype == hT.dtype == torch.float32
    assert y.shape == (b, s, h, p) and hT.shape == (b, h, p, n)
    _close(y.numpy(), want_y)
    _close(hT.numpy(), want_h)


@pytest.mark.parametrize("with_h0", [False, True], ids=["zero_state", "h0"])
@pytest.mark.parametrize("b,s,h,p,n,chunk", SHAPES)
def test_plain_versions_match_jax(b, s, h, p, n, chunk, with_h0):
    arrays = _inputs(b, s, h, p, n, seed=1, with_h0=with_h0)
    x, dt, A, Bm, Cm, *h0 = arrays
    h0 = h0[0] if h0 else None
    jargs = [jnp.asarray(a) for a in (x, dt, A, Bm, Cm)]
    jh0 = None if h0 is None else jnp.asarray(h0)
    targs = _torch([x, dt, A, Bm, Cm])
    th0 = None if h0 is None else torch.from_numpy(h0)
    for got, want in ((ssd_ref(*targs, h0=th0), jax_ssd_ref(*jargs, h0=jh0)),
                      (ssd_chunked(*targs, chunk, h0=th0),
                       jax_ssd_chunked(*jargs, chunk, h0=jh0)),
                      (ops.ssd_scan(*targs, chunk=chunk, h0=th0),
                       jax_ssd_ref(*jargs, h0=jh0))):
        _close(got[0].numpy(), want[0])
        _close(got[1].numpy(), want[1])


def test_h0_threads_a_split_sequence():
    """The scan of the second half from the first half's state equals the
    scan of the whole."""
    x, dt, A, Bm, Cm = _torch(_inputs(2, 64, 3, 16, 8, seed=2))
    y1, h1 = ops.ssd_scan(x[:, :32].contiguous(), dt[:, :32].contiguous(), A,
                          Bm[:, :32].contiguous(), Cm[:, :32].contiguous(), chunk=16)
    y2, h2 = ops.ssd_scan(x[:, 32:].contiguous(), dt[:, 32:].contiguous(), A,
                          Bm[:, 32:].contiguous(), Cm[:, 32:].contiguous(), chunk=16, h0=h1)
    y, hT = ops.ssd_scan(x, dt, A, Bm, Cm, chunk=16)
    torch.testing.assert_close(torch.cat([y1, y2], dim=1), y, rtol=TOL, atol=TOL)
    torch.testing.assert_close(h2, hT, rtol=TOL, atol=TOL)


def test_recurrent_step_matches_the_scan():
    """``ssd_recurrent`` (decode) continues the scan by one position."""
    x, dt, A, Bm, Cm = _torch(_inputs(2, 17, 3, 16, 8, seed=3))
    _, h = ops.ssd_scan(x[:, :16].contiguous(), dt[:, :16].contiguous(), A,
                        Bm[:, :16].contiguous(), Cm[:, :16].contiguous(), chunk=16)
    y_step, h_step = ssd_recurrent(x[:, 16:], dt[:, 16:], A, Bm[:, 16:], Cm[:, 16:], h)
    y_ref, h_ref = ssd_ref(x, dt, A, Bm, Cm)
    torch.testing.assert_close(y_step[:, 0], y_ref[:, 16], rtol=TOL, atol=TOL)
    torch.testing.assert_close(h_step, h_ref, rtol=TOL, atol=TOL)


def test_float64_oracle_agrees_with_float32():
    arrays = _inputs(1, 48, 2, 8, 4, seed=4)
    y32, h32 = ssd_ref(*_torch(arrays))
    y64, h64 = ssd_ref(*(torch.from_numpy(a).double() for a in arrays))
    assert y64.dtype == h64.dtype == torch.float64
    torch.testing.assert_close(y32.double(), y64, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(h32.double(), h64, rtol=1e-5, atol=1e-5)


def test_wrapper_checks_what_the_kernel_takes():
    x, dt, A, Bm, Cm, h0 = _torch(_inputs(2, 32, 3, 16, 8, with_h0=True))
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ops.ssd_scan(x[:, :20].contiguous(), dt[:, :20].contiguous(), A,
                     Bm[:, :20].contiguous(), Cm[:, :20].contiguous(), chunk=16)
    with pytest.raises(ValueError, match="contiguous"):    # the same contract as on the card
        ops.ssd_scan(x.transpose(1, 2).contiguous().transpose(1, 2), dt, A, Bm, Cm, chunk=16)
    with pytest.raises(ValueError, match="shape"):
        ops.ssd_scan(x, dt, A, Bm[:, :, :4], Cm, chunk=16)
    with pytest.raises(ValueError, match="shape"):
        ops.ssd_scan(x, dt, A, Bm, Cm, chunk=16, h0=h0[:, :2])
    with pytest.raises(TypeError):
        ops.ssd_scan(x.double(), dt, A, Bm, Cm, chunk=16)
    with pytest.raises(ValueError, match="exceeds"):
        big = torch.zeros(2, 32, ops.MAX_STATE + 1)
        ops.ssd_scan(x, dt, A, big, big, chunk=16)
    with pytest.raises(ValueError, match="no kernel"):
        ops.ssd_scan(*(t.to("meta") for t in (x, dt, A, Bm, Cm)), chunk=16)
    with pytest.raises(ValueError, match="empty"):
        ops.ssd_scan(x[:, :0], dt[:, :0], A, Bm[:, :0], Cm[:, :0], chunk=16)
