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

The backward: the plain ``ssd_bwd_ref`` (explicit chunked formulas in the
backward kernels' phases, which the CUDA kernels are held to on the card)
against ``jax.vjp`` of the JAX package's ``ssd_chunked``, against autograd
of the port's ``ssd_chunked``, and against float64 autograd of ``ssd_ref``;
then the ``torch.autograd.Function`` that carries the kernels, driven on
CPU tensors with its two launches replaced by their plain versions.
Inputs and cotangents come from numpy with a seed.  Tolerance: float32,
rtol 1e-4 with atol 1e-4 of each gradient's largest entry, since dB, dC
and dA sum over heads and positions in another order than XLA's (or
autograd's) chain; against float64, ``TOL`` scaled the same way.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels.ssd_scan import ops as jax_ops
from repro.kernels.ssd_scan.ref import ssd_ref as jax_ssd_ref
from repro.models.ssm import ssd_chunked as jax_ssd_chunked
from repro_torch.kernels.ssd_scan import ops
from repro_torch.kernels.ssd_scan.ref import span_states_ref, ssd_bwd_ref, ssd_ref
from repro_torch.models.ssm import ssd_chunked, ssd_recurrent

from _tf32 import tf32_mm as _tf32_mm

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


def _kernel_arithmetic(x, dt, A, Bm, Cm, h0, split):
    """K4's four phases on the CPU, every product through ``_tf32_mm``:
    C Bᵀ once per chunk; each span's local state as one product over the
    span, weighted by exp of suffix sums; the state passed across spans; then
    per chunk y = (C Bᵀ ⊙ L)(dt·x) + exp(cum) C hᵀ and the state update for
    all but a span's last chunk.  Decays come from segment sums (cumulative
    sums of the masked a), never from differences of running sums."""
    b, s, h, p = x.shape
    n, q, span = Bm.shape[-1], ops.Q, ops.SPAN
    nc = -(-s // q)
    pad = nc * q - s
    xs = F.pad(x, (0, 0, 0, 0, 0, pad)).reshape(b, nc, q, h, p).permute(0, 3, 1, 2, 4)
    dts = F.pad(dt, (0, 0, 0, pad)).reshape(b, nc, q, h).permute(0, 3, 1, 2)
    Bs = F.pad(Bm, (0, 0, 0, pad)).reshape(b, nc, q, n)
    Cs = F.pad(Cm, (0, 0, 0, pad)).reshape(b, nc, q, n)
    a = dts * A[None, :, None, None]                               # (b, h, nc, q)
    lower = torch.ones(q, q, dtype=torch.bool).tril()
    strict = lower & ~torch.eye(q, dtype=torch.bool)
    seg = torch.cumsum(torch.where(strict, a[..., :, None], 0.0), dim=-2)   # [i][j]
    cum = torch.cumsum(a, dim=-1)
    sfx = seg[..., -1, :]                                          # sum_{t > j} a_t
    xdt = xs * dts[..., None]
    cb = torch.where(lower, _tf32_mm(Cs, Bs.transpose(-1, -2), split), 0.0)
    M = torch.where(lower, cb[:, None] * torch.exp(seg), 0.0)
    spans = [range(k * span, min(nc, (k + 1) * span)) for k in range(-(-nc // span))]

    local, logdec = [], []
    for chunks in spans:
        c0, c1 = chunks.start, chunks.stop
        later = torch.flip(torch.cumsum(torch.flip(cum[..., c0:c1, -1], [-1]), -1), [-1])
        later = torch.cat([later[..., 1:], torch.zeros_like(later[..., :1])], -1)
        coef = dts[..., c0:c1, :] * torch.exp(sfx[..., c0:c1, :] + later[..., None])
        xw = (xs[:, :, c0:c1] * coef[..., None]).reshape(b, h, -1, p)
        local.append(_tf32_mm(xw.transpose(-1, -2), Bs[:, None, c0:c1].reshape(b, 1, -1, n),
                              split))
        logdec.append(cum[..., c0:c1, -1].sum(-1))
    hh = torch.zeros(b, h, p, n) if h0 is None else h0
    h_in = []
    for k in range(len(spans)):
        h_in.append(hh)
        hh = torch.exp(logdec[k])[..., None, None] * hh + local[k]
    h_final = hh
    ys = []
    for k, chunks in enumerate(spans):
        hh = h_in[k]
        for c in chunks:
            carry = _tf32_mm(Cs[:, None, c], hh.transpose(-1, -2), split)
            ys.append(carry * torch.exp(cum[..., c, :, None]) + _tf32_mm(M[:, :, c], xdt[:, :, c],
                                                                          split))
            if c + 1 < chunks.stop:
                w = torch.exp(sfx[..., c, :])
                hh = torch.exp(cum[..., c, -1])[..., None, None] * hh + _tf32_mm(
                    (xdt[:, :, c] * w[..., None]).transpose(-1, -2), Bs[:, None, c], split)
    y = torch.stack(ys, dim=2).permute(0, 2, 3, 1, 4).reshape(b, nc * q, h, p)[:, :s]
    return y, h_final


def test_tf32_split_is_what_keeps_the_kernel_within_its_tolerance():
    """Why K4 splits every product operand hi/lo: its arithmetic, emulated
    on the CPU at a reduced shape that crosses spans with a ragged last
    chunk, with h0 and fast-decaying heads (A x 4), meets TOL against the
    float64 recurrence at every output with the split; one TF32 pass misses
    it at more than a tenth of them."""
    x, dt, A, Bm, Cm, h0 = _torch(_inputs(1, 300, 3, 64, 128, seed=3, with_h0=True))
    A = 4 * A
    y64, h64 = ssd_ref(*(t.double() for t in (x, dt, A, Bm, Cm)), h0=h0.double())

    def outside(split):
        y, hT = _kernel_arithmetic(x, dt, A, Bm, Cm, h0, split)
        return (int(((y.double() - y64).abs() > TOL + TOL * y64.abs()).sum()),
                int(((hT.double() - h64).abs() > TOL + TOL * h64.abs()).sum()))

    assert outside(split=True) == (0, 0)
    assert outside(split=False)[0] > y64.numel() // 10


# -- the backward ----------------------------------------------------------------

BWD_RTOL = BWD_ATOL_SHARE = 1e-4
# (b, s, h, p, n, chunk, h0, dh, A scale): a ragged last 64-position chunk
# with h0 and dh; one whole chunk; 11 chunks (three spans, the last ragged,
# and a ragged last chunk) with h0; dh alone; heads decaying fast (A x 4)
# with h0 and dh; Mamba2-130M's P and N
BWD_CASES = [(2, 100, 3, 16, 8, 50, True, True, 1.0), (1, 64, 2, 8, 4, 64, False, False, 1.0),
             (1, 700, 2, 8, 5, 100, True, False, 1.0), (2, 96, 3, 16, 8, 32, False, True, 1.0),
             (1, 300, 3, 16, 8, 60, True, True, 4.0), (1, 128, 2, 64, 128, 64, False, True, 1.0)]
BWD_IDS = ["h0-dh-ragged-chunk", "one-chunk", "spans-h0", "dh", "fast-decay", "p64-n128"]
GRADS = ("dx", "ddt", "dA", "dB", "dC", "dh0")


def _bwd_inputs(b, s, h, p, n, with_h0, with_dh, scale, seed=5):
    """x, dt, A, Bm, Cm, h0 or None, dy, dh or None: numpy float32."""
    x, dt, A, Bm, Cm, *h0 = _inputs(b, s, h, p, n, seed=seed, with_h0=with_h0)
    rng = np.random.default_rng(seed + 100)
    dy = rng.standard_normal((b, s, h, p), dtype=np.float32)
    dh = rng.standard_normal((b, h, p, n), dtype=np.float32) if with_dh else None
    return x, dt, (scale * A).astype(np.float32), Bm, Cm, (h0[0] if h0 else None), dy, dh


def _bwd_close(got, want, rtol=BWD_RTOL, share=BWD_ATOL_SHARE):
    for name, g, w in zip(GRADS, got, want):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        np.testing.assert_allclose(g, w, rtol=rtol, atol=share * np.abs(w).max(), err_msg=name)


def _plain_bwd(x, dt, A, Bm, Cm, h0, dy, dh):
    """``ssd_bwd_ref`` from the span states of ``span_states_ref``; dh0 is
    returned only where there was an h0."""
    args = [torch.from_numpy(a) for a in (x, dt, A, Bm, Cm)]
    th0 = None if h0 is None else torch.from_numpy(h0)
    states = span_states_ref(*args, th0)
    got = ssd_bwd_ref(*args, torch.from_numpy(dy), states,
                      None if dh is None else torch.from_numpy(dh))
    return [t.numpy() for t in got[:5]] + ([got[5].numpy()] if h0 is not None else [])


def _autograd(fn, x, dt, A, Bm, Cm, h0, dy, dh, dtype=torch.float32):
    """Gradients of <y, dy> + <h_final, dh> through ``fn`` by autograd."""
    ins = [torch.from_numpy(a).to(dtype).requires_grad_(True) for a in (x, dt, A, Bm, Cm)]
    if h0 is not None:
        ins.append(torch.from_numpy(h0).to(dtype).requires_grad_(True))
    y, hT = fn(*ins[:5], None if h0 is None else ins[5])
    loss = (y * torch.from_numpy(dy).to(dtype)).sum()
    if dh is not None:
        loss = loss + (hT * torch.from_numpy(dh).to(dtype)).sum()
    return [g.numpy() for g in torch.autograd.grad(loss, ins)]


@pytest.mark.parametrize("b,s,h,p,n,chunk,with_h0,with_dh,scale", BWD_CASES, ids=BWD_IDS)
def test_ssd_bwd_ref_matches_jax_vjp_of_ssd_chunked(b, s, h, p, n, chunk, with_h0, with_dh,
                                                    scale):
    x, dt, A, Bm, Cm, h0, dy, dh = _bwd_inputs(b, s, h, p, n, with_h0, with_dh, scale)
    args = [jnp.asarray(a) for a in (x, dt, A, Bm, Cm)] + (
        [jnp.asarray(h0)] if with_h0 else [])
    out, vjp = jax.vjp(lambda *a: jax_ssd_chunked(*a[:5], chunk, *a[5:]), *args)
    want = vjp((jnp.asarray(dy), jnp.zeros_like(out[1]) if dh is None else jnp.asarray(dh)))
    _bwd_close(_plain_bwd(x, dt, A, Bm, Cm, h0, dy, dh), want)


@pytest.mark.parametrize("b,s,h,p,n,chunk,with_h0,with_dh,scale", BWD_CASES, ids=BWD_IDS)
def test_ssd_bwd_ref_matches_autograd_of_ssd_chunked(b, s, h, p, n, chunk, with_h0, with_dh,
                                                     scale):
    inputs = _bwd_inputs(b, s, h, p, n, with_h0, with_dh, scale)
    want = _autograd(lambda *a: ssd_chunked(*a[:5], chunk, h0=a[5]), *inputs)
    _bwd_close(_plain_bwd(*inputs), want)


@pytest.mark.parametrize("b,s,h,p,n,chunk,with_h0,with_dh,scale", BWD_CASES, ids=BWD_IDS)
def test_ssd_bwd_ref_is_within_tolerance_of_float64(b, s, h, p, n, chunk, with_h0, with_dh,
                                                    scale):
    inputs = _bwd_inputs(b, s, h, p, n, with_h0, with_dh, scale)
    want = _autograd(lambda *a: ssd_ref(*a[:5], h0=a[5]), *inputs, dtype=torch.float64)
    _bwd_close(_plain_bwd(*inputs), want, rtol=TOL, share=TOL)


def _bwd_kernel_arithmetic(x, dt, A, Bm, Cm, dy, states, dh, split, group):
    """K4's backward kernels on the CPU, every product through ``_tf32_mm``
    with the kernels' operand weighting (dt, ec, w applied to an operand
    before its split; L's mask after DX, as L ⊙ DX and M ⊙ DX): the carry
    kernel's adjoint walked back from dh, R_{c-1} = D R_c + (ec ⊙ dy)ᵀ C, its
    state walks through each span, (w dt ⊙ x)ᵀ B, and C Bᵀ once a chunk;
    then the chunk kernel per head, DX = dy (dt x)ᵀ, g B = (w ⊙ B) Rᵀ + Mᵀ dy,
    (w dt ⊙ x) R and (ec ⊙ dy) h_in (and their row dots v and u), and per
    group of ``group`` heads dC += LDsum B and dB += LDsumᵀ C.  da is the
    inner product itself; decays are segment sums.  (dx, ddt, dA, dB, dC,
    dh0), float32."""
    b, s, h, p = x.shape
    n, q, span = Bm.shape[-1], ops.Q, ops.SPAN
    nc = -(-s // q)
    pad = nc * q - s
    xs = F.pad(x, (0, 0, 0, 0, 0, pad)).reshape(b, nc, q, h, p).permute(0, 3, 1, 2, 4)
    dys = F.pad(dy, (0, 0, 0, 0, 0, pad)).reshape(b, nc, q, h, p).permute(0, 3, 1, 2, 4)
    dts = F.pad(dt, (0, 0, 0, pad)).reshape(b, nc, q, h).permute(0, 3, 1, 2)
    Bs = F.pad(Bm, (0, 0, 0, pad)).reshape(b, nc, q, n)
    Cs = F.pad(Cm, (0, 0, 0, pad)).reshape(b, nc, q, n)
    a = dts * A[None, :, None, None]                               # (b, h, nc, q)
    lower = torch.ones(q, q, dtype=torch.bool).tril()
    strict = lower & ~torch.eye(q, dtype=torch.bool)
    seg = torch.cumsum(torch.where(strict, a[..., :, None], 0.0), dim=-2)   # [j][k]
    L = torch.where(lower, torch.exp(seg), 0.0)
    cum = torch.cumsum(a, dim=-1)
    ec, w, D = torch.exp(cum), torch.exp(seg[..., -1, :]), torch.exp(cum[..., -1])
    # carry: the adjoint walked back from dh, the states forward through each span, C B^T
    g = torch.zeros(b, h, p, n) if dh is None else dh.clone()
    R = [None] * nc
    for c in reversed(range(nc)):
        R[c] = g
        local = _tf32_mm((dys[:, :, c] * ec[..., c, :, None]).transpose(-1, -2),
                         Cs[:, None, c], split)
        g = D[..., c, None, None] * g + local
    dh0 = g
    st = states.reshape(b, h, -1, p, n)
    hin = []
    for c in range(nc):
        if c % span == 0:
            hin.append(st[:, :, c // span])
        else:
            xw = xs[:, :, c - 1] * (w[..., c - 1, :] * dts[..., c - 1, :])[..., None]
            hin.append(D[..., c - 1, None, None] * hin[-1]
                       + _tf32_mm(xw.transpose(-1, -2), Bs[:, None, c - 1], split))
    cbt = torch.where(lower, _tf32_mm(Cs, Bs.transpose(-1, -2), split), 0.0)   # [j][k] = C_j . B_k
    # chunk: per head, then per group of heads
    dx, ddt, dA = torch.zeros(b, h, nc, q, p), torch.zeros(b, h, nc, q), torch.zeros(h)
    dB, dC = torch.zeros(b, nc, q, n), torch.zeros(b, nc, q, n)
    for c in range(nc):
        for g0 in range(0, h, group):
            dCg, dBg, LDsum = torch.zeros(b, q, n), torch.zeros(b, q, n), torch.zeros(b, q, q)
            for hh in range(g0, min(h, g0 + group)):
                Lh, wh, eh, dth = L[:, hh, c], w[:, hh, c], ec[:, hh, c], dts[:, hh, c]
                M = Lh * cbt[:, c]
                DX = _tf32_mm(dys[:, hh, c], (xs[:, hh, c] * dth[..., None]).transpose(-1, -2),
                              split)
                LDsum = LDsum + Lh * DX
                K = M * DX
                before = F.pad(torch.cumsum(K, dim=-1)[..., :-1], (1, 0))
                da1 = (before * lower).sum(-2)
                Rc, Hc = R[c][:, hh], hin[c][:, hh]
                gB = (_tf32_mm(Bs[:, c] * wh[..., None], Rc.transpose(-1, -2), split)
                      + _tf32_mm(M.transpose(-1, -2), dys[:, hh, c], split))
                dx[:, hh, c] = dth[..., None] * gB
                t1 = (xs[:, hh, c] * gB).sum(-1)
                XR = _tf32_mm(xs[:, hh, c] * (wh * dth)[..., None], Rc, split)
                v = (XR * Bs[:, c]).sum(-1)
                YH = _tf32_mm(dys[:, hh, c] * eh[..., None], Hc, split)
                u = (YH * Cs[:, c]).sum(-1)
                dBg, dCg = dBg + XR, dCg + YH
                E = D[:, hh, c] * (Rc * Hc).sum((-1, -2))
                da = (da1 + torch.flip(torch.cumsum(torch.flip(u, [-1]), -1), [-1])
                      + F.pad(torch.cumsum(v, -1)[..., :-1], (1, 0)) + E[:, None])
                ddt[:, hh, c] = t1 + A[hh] * da
                dA[hh] += (dth * da).sum()
            dC[:, c] += dCg + _tf32_mm(LDsum, Bs[:, c], split)
            dB[:, c] += dBg + _tf32_mm(LDsum.transpose(-1, -2), Cs[:, c], split)

    def unchunk(t):                  # (b, h, nc, q, ...) -> (b, s, h, ...)
        return t.reshape(b, h, nc * q, *t.shape[4:])[:, :, :s].movedim(1, 2)

    return (unchunk(dx), unchunk(ddt), dA, dB.reshape(b, nc * q, n)[:, :s],
            dC.reshape(b, nc * q, n)[:, :s], dh0)


def test_tf32_split_keeps_the_backward_within_its_tolerance():
    """Why K4's backward splits every product operand hi/lo, as its forward
    does: its arithmetic, emulated on the CPU (``_bwd_kernel_arithmetic``) at
    Mamba2-130M's P and N on a shape that crosses spans with a ragged last
    chunk and span, with h0, dh and fast-decaying heads (A x 4), meets TOL
    (scaled by each gradient's largest entry, as the card's check does)
    against float64 autograd of ``ssd_ref`` at every entry with the split
    (worst 0.003 of the limit); one TF32 pass misses it for every gradient,
    at more than a hundredth of dx's entries (worst ~4.6 times the limit)."""
    x, dt, A, Bm, Cm, h0, dy, dh = (torch.from_numpy(a) for a in
                                    _bwd_inputs(1, 300, 3, 64, 128, True, True, 4.0, seed=3))
    states = span_states_ref(x, dt, A, Bm, Cm, h0)
    ins = [t.double().requires_grad_(True) for t in (x, dt, A, Bm, Cm, h0)]
    y64, h64 = ssd_ref(*ins[:5], h0=ins[5])
    want = torch.autograd.grad((y64 * dy.double()).sum() + (h64 * dh.double()).sum(), ins)

    def outside(split):
        got = _bwd_kernel_arithmetic(x, dt, A, Bm, Cm, dy, states, dh, split, group=3)
        return {name: int(((g.double() - w).abs() > TOL * w.abs().max() + TOL * w.abs()).sum())
                for name, g, w in zip(GRADS, got, want)}

    assert outside(split=True) == dict.fromkeys(GRADS, 0)
    one_pass = outside(split=False)
    assert all(one_pass.values()), one_pass
    assert one_pass["dx"] > x.numel() // 100, one_pass


def test_span_states_ref_is_the_state_entering_each_span():
    x, dt, A, Bm, Cm, h0 = _torch(_inputs(2, 600, 3, 8, 4, seed=6, with_h0=True))
    states = span_states_ref(x, dt, A, Bm, Cm, h0)
    span = ops.SPAN * ops.Q
    assert states.shape == (2 * 3, 3, 8, 4)
    torch.testing.assert_close(states[:, 0], h0.reshape(6, 8, 4), rtol=0, atol=0)
    for k in (1, 2):
        _, hk = ssd_ref(x[:, :k * span], dt[:, :k * span], A, Bm[:, :k * span],
                        Cm[:, :k * span], h0)
        torch.testing.assert_close(states[:, k], hk.reshape(6, 8, 4), rtol=1e-5, atol=1e-5)


@pytest.fixture
def plain_launches(monkeypatch):
    """``_SSDScan``'s two launches replaced by their plain versions, counted,
    so the Function runs on CPU tensors."""
    calls = {"forward": [], "backward": []}

    def forward(x, dt, A, Bm, Cm, h0, keep_states):
        calls["forward"].append(keep_states)
        y, h = ssd_chunked(x, dt, A, Bm, Cm, x.shape[1], h0)
        return y, h, span_states_ref(x, dt, A, Bm, Cm, h0)

    def backward(x, dt, A, Bm, Cm, dy, states, dh=None):
        calls["backward"].append((dy.is_contiguous(), states, dh is None))
        return ssd_bwd_ref(x, dt, A, Bm, Cm, dy, states, dh)

    monkeypatch.setattr(ops, "_forward", forward)
    monkeypatch.setattr(ops, "ssd_scan_bwd", backward)
    return calls


@pytest.mark.parametrize("used", ["y", "h_final", "both"])
@pytest.mark.parametrize("with_h0", [False, True], ids=["zero_state", "h0"])
def test_autograd_function_carries_the_kernels_gradient(plain_launches, used, with_h0):
    """The Function keeps the forward's span states for its backward, takes
    None for the cotangent of an output that is not used, and hands back
    the gradients of x, dt, A, Bm, Cm and h0 (None without an h0, which
    autograd would refuse otherwise)."""
    x, dt, A, Bm, Cm, h0, dy, dh = _bwd_inputs(2, 300, 3, 16, 8, with_h0, True, 1.0, seed=7)
    dy = dy if used != "h_final" else np.zeros_like(dy)
    dh = dh if used != "y" else None
    want = _autograd(lambda *a: ssd_chunked(*a[:5], 300, h0=a[5]), x, dt, A, Bm, Cm, h0, dy, dh)
    ins = [torch.from_numpy(a).requires_grad_(True) for a in (x, dt, A, Bm, Cm)]
    th0 = None if h0 is None else torch.from_numpy(h0).requires_grad_(True)
    y, hT = ops._SSDScan.apply(*ins, th0)
    loss = 0.0
    if used != "h_final":
        loss = loss + (y * torch.from_numpy(dy)).sum()
    if used != "y":
        loss = loss + (hT * torch.from_numpy(dh)).sum()
    got = torch.autograd.grad(loss, ins + ([th0] if th0 is not None else []))
    assert plain_launches["forward"] == [True] and len(plain_launches["backward"]) == 1
    contiguous, states, no_dh = plain_launches["backward"][0]
    assert contiguous and no_dh == (used == "y")
    torch.testing.assert_close(states, span_states_ref(*ins, th0).detach(), rtol=0, atol=0)
    _bwd_close([g.numpy() for g in got], want)


def test_wrapper_on_the_cpu_differentiates_the_plain_version():
    x, dt, A, Bm, Cm, h0, dy, dh = _bwd_inputs(2, 96, 3, 16, 8, True, True, 1.0, seed=8)
    before = dict(ops.LAUNCHES)
    got = _autograd(lambda *a: ops.ssd_scan(*a[:5], chunk=32, h0=a[5]), x, dt, A, Bm, Cm, h0,
                    dy, dh)
    assert ops.LAUNCHES == before                  # no kernel on the CPU
    want = _autograd(lambda *a: ssd_chunked(*a[:5], 32, h0=a[5]), x, dt, A, Bm, Cm, h0, dy, dh)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
