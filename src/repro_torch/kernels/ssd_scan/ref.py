"""Plain PyTorch versions of the SSD kernels: the forward's naive O(S)
recurrence, and the backward in the kernels' own decomposition.

``ssd_ref`` ports ``repro.kernels.ssd_scan.ref.ssd_ref``.  It computes in
the inputs' floating type if it is float64 (so the card can hold K4 against
a float64 oracle), else in float32; one step per position, so it is an
oracle, not a yardstick of speed.

``span_states_ref`` and ``ssd_bwd_ref`` are the plain versions of the
training path, for which the reference has no kernel (XLA differentiates
its ``ssd_chunked``): the state entering each span of ``SPAN`` chunks of
``Q`` positions, as K4's forward leaves it in its scratch and keeps it for
the backward, and the gradient of ``ssd_scan`` by explicit chunked
formulas, those the backward kernels (``csrc/ssd_scan_bwd.cu``) compute.
The kernels group them otherwise: they walk the adjoint across the chunks
in one pass (the recursion of phases 1-2 below, each chunk's local adjoint
added as it is reached), and they sum dB and dC over groups of heads, with
LD B and LDᵀ C taken once a group on the group's summed LD; the same sums
in another order, so the two agree to float32 rounding.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_scan.ops import Q, SPAN

__all__ = ["ssd_ref", "span_states_ref", "ssd_bwd_ref"]


def ssd_ref(x, dt, A, Bm, Cm, h0=None):
    """Sequential state-space recurrence (Mamba-2 §3, eq. 1-2).

    x  (B, S, H, P); dt (B, S, H); A (H,) negative; Bm, Cm (B, S, N).
    h_t = exp(dt_t A) h_{t-1} + dt_t x_t ⊗ B_t ;  y_t = C_t · h_t
    Returns y (B, S, H, P) and final h (B, H, P, N), float32 (float64 for
    float64 inputs).
    """
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    ft = torch.float64 if x.dtype == torch.float64 else torch.float32
    x, dt, A, Bm, Cm = (t.to(ft) for t in (x, dt, A, Bm, Cm))
    h = (torch.zeros((Bsz, H, P, N), dtype=ft, device=x.device) if h0 is None
         else h0.to(ft))
    ys = []
    for t in range(S):
        a = torch.exp(dt[:, t] * A[None])                          # (B, H)
        h = h * a[..., None, None] + torch.einsum(
            "bhp,bn->bhpn", x[:, t] * dt[:, t, :, None], Bm[:, t])
        ys.append(torch.einsum("bn,bhpn->bhp", Cm[:, t], h))
    return torch.stack(ys, dim=1), h


def span_states_ref(x, dt, A, Bm, Cm, h0=None):
    """The state entering each span of SPAN x Q positions, (B·H, n_spans,
    P, N), by the recurrence: what K4's forward leaves in its ``states``
    scratch (float64 for float64 inputs, else float32)."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    ft = torch.float64 if x.dtype == torch.float64 else torch.float32
    h = (torch.zeros((Bsz, H, P, N), dtype=ft, device=x.device) if h0 is None
         else h0.to(ft))
    out = []
    for s0 in range(0, S, SPAN * Q):
        out.append(h)
        s1 = s0 + SPAN * Q
        _, h = ssd_ref(x[:, s0:s1], dt[:, s0:s1], A, Bm[:, s0:s1], Cm[:, s0:s1], h)
    return torch.stack(out, dim=2).reshape(Bsz * H, len(out), P, N)


def _chunked(t, nc):
    """``t`` with its sequence axis (1) zero-padded to nc·Q and split into
    (nc, Q)."""
    t = F.pad(t, (0, 0) * (t.dim() - 2) + (0, nc * Q - t.shape[1]))
    return t.reshape(t.shape[0], nc, Q, *t.shape[2:])


def ssd_bwd_ref(x, dt, A, Bm, Cm, dy, states, dh=None):
    """Gradient of ``ssd_scan`` by explicit chunked formulas.

    x (B, S, H, P), dt (B, S, H), A (H,), Bm and Cm (B, S, N); dy (B, S, H,
    P) the cotangent of y; ``states`` (B·H, n_spans, P, N) the span states
    (``span_states_ref``, from h0 if there was one; K4's forward keeps
    them); dh (B, H, P, N) the cotangent of the final state or None (zero).
    Returns (dx, ddt, dA, dB, dC, dh0), float32 (float64 for float64
    inputs), as ``ops.ssd_scan_bwd`` does.

    With a_t = dt_t A <= 0 the forward is h_t = exp(a_t) h_{t-1} + dt_t x_t
    ⊗ B_t, y_t = h_t C_t.  The state's adjoint g_t = dy_t ⊗ C_t +
    exp(a_{t+1}) g_{t+1}, from g_S = dh + dy_S ⊗ C_S, gives dx_t = dt_t g_t
    B_t, dB_t = Σ_{h,p} dt_t x_t[p] g_t[p], dC_t = Σ_{h,p} dy_t[p] h_t[p],
    da_t = <g_t, exp(a_t) h_{t-1}>, ddt_t = <x_t, g_t B_t> + A da_t, dA =
    Σ dt_t da_t and dh0 = exp(a_1) g_1.  In chunks of Q positions (the last
    zero-padded: dt = 0 there decays nothing and adds nothing), as the
    kernels go:

    1. each chunk's local adjoint Σ_t exp(cum_t) dy_t ⊗ C_t (cum the running
       sum of a from the chunk's start) and its summed a;
    2. a reverse pass over the chunks from dh: R_c, the adjoint entering
       chunk c from its right, R_{c-1} = exp(Σ a over c) R_c + local_c, and
       dh0 = exp(Σ a over chunk 0) R_0 + local_0;
    3. each chunk's entering state h_in, from its span's saved state forward
       through the span's earlier chunks;
    4. per chunk, in the dual quadratic form, with L[j, k] = exp(Σ_{k<s<=j}
       a_s) for j >= k, M = L ⊙ C Bᵀ, LD = L ⊙ dy (dt x)ᵀ, K = M ⊙ dy (dt x)ᵀ,
       w_k = exp(Σ_{s>k} a_s) and D = exp(Σ a): g B = Mᵀ dy + w ⊙ B Rᵀ, so
       dx = dt ⊙ g B and ddt's first term <x, g B>; dC = exp(cum) ⊙ dy h_in
       + LD B and dB = LDᵀ C + w ⊙ (dt x) R, this head's parts (summed over
       heads at the end); and da_i as the inner product itself,
       Σ_{j>=i>k} K[j, k] + Σ_{j>=i} u_j + Σ_{k<i} v_k + D <R, h_in>, with
       u_j = exp(cum_j) (dy h_in)_j · C_j and v_k = w_k ((dt x) R)_k · B_k.

    No difference of large terms stands in for da where heads decay fast,
    and every decay is a segment sum of a, never exp(cum_i - cum_j).
    """
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    ft = torch.float64 if x.dtype == torch.float64 else torch.float32
    x, dt, A, Bm, Cm, dy, states = (t.to(ft) for t in (x, dt, A, Bm, Cm, dy, states))
    nc = -(-S // Q)
    # head-major chunks (B, H, nc, Q, ...); B and C (B, nc, Q, N)
    xs = _chunked(x, nc).permute(0, 3, 1, 2, 4)
    dys = _chunked(dy, nc).permute(0, 3, 1, 2, 4)
    dts = _chunked(dt, nc).permute(0, 3, 1, 2)
    Bs, Cs = _chunked(Bm, nc), _chunked(Cm, nc)
    a = dts * A[None, :, None, None]                                  # (B, H, nc, Q)
    idx = torch.arange(Q, device=x.device)
    lower = idx[:, None] >= idx[None, :]                              # [j][k]: j >= k
    strict = idx[:, None] > idx[None, :]
    cum = torch.cumsum(a, dim=-1)                                     # Σ_{s<=i} a_s
    sfx = torch.flip(torch.cumsum(torch.flip(a, [-1]), -1), [-1])     # Σ_{s>=i} a_s
    sfx = F.pad(sfx[..., 1:], (0, 1))                                 # Σ_{s>i} a_s
    seg = torch.cumsum(torch.where(strict, a[..., :, None], 0.0), dim=-2)   # Σ_{k<s<=j}
    L = torch.where(lower, torch.exp(seg), 0.0)                       # (B, H, nc, Q, Q)
    ec, w, D = torch.exp(cum), torch.exp(sfx), torch.exp(cum[..., -1])
    dtx = xs * dts[..., None]

    # 1-2: local adjoints, then the reverse pass over the chunks
    local = torch.einsum("bhcq,bhcqp,bcqn->bhcpn", ec, dys, Cs)
    R = [None] * nc
    g = (torch.zeros((Bsz, H, P, N), dtype=ft, device=x.device) if dh is None
         else dh.to(ft))
    for c in reversed(range(nc)):
        R[c] = g
        g = D[..., c, None, None] * g + local[:, :, c]
    dh0, R = g, torch.stack(R, dim=2)                                 # R (B, H, nc, P, N)

    # 3: the chunks' entering states from the span states
    st = states.reshape(Bsz, H, -1, P, N)
    upd = torch.einsum("bhcq,bhcqp,bcqn->bhcpn", w, dtx, Bs)
    hin = []
    for c in range(nc):
        hin.append(st[:, :, c // SPAN] if c % SPAN == 0 else
                   D[..., c - 1, None, None] * hin[-1] + upd[:, :, c - 1])
    hin = torch.stack(hin, dim=2)

    # 4: per chunk
    dyx = torch.einsum("bhcjp,bhckp->bhcjk", dys, dtx)
    M = L * torch.einsum("bcjn,bckn->bcjk", Cs, Bs)[:, None]
    LD, K = L * dyx, M * dyx
    gB = (torch.einsum("bhcjk,bhcjp->bhckp", M, dys)
          + w[..., None] * torch.einsum("bckn,bhcpn->bhckp", Bs, R))
    YH = torch.einsum("bhcjp,bhcpn->bhcjn", dys, hin)
    XR = torch.einsum("bhckp,bhcpn->bhckn", dtx, R)
    dC = ec[..., None] * YH + torch.einsum("bhcjk,bckn->bhcjn", LD, Bs)
    dB = torch.einsum("bhcjk,bcjn->bhckn", LD, Cs) + w[..., None] * XR
    u = ec * (YH * Cs[:, None]).sum(-1)
    v = w * (XR * Bs[:, None]).sum(-1)
    E = D * (R * hin).sum((-1, -2))
    before = F.pad(torch.cumsum(K, dim=-1)[..., :-1], (1, 0))         # [j][i]: Σ_{k<i} K[j, k]
    da = ((before * lower).sum(-2)                                    # Σ_{j>=i>k} K[j, k]
          + torch.flip(torch.cumsum(torch.flip(u, [-1]), -1), [-1])   # Σ_{j>=i} u_j
          + F.pad(torch.cumsum(v, -1)[..., :-1], (1, 0))              # Σ_{k<i} v_k
          + E[..., None])
    ddt = (xs * gB).sum(-1) + A[None, :, None, None] * da
    dA = (dts * da).sum((0, 2, 3))

    def unchunk(t):                  # (B, H, nc, Q, ...) -> (B, S, H, ...)
        t = t.reshape(Bsz, H, nc * Q, *t.shape[4:])[:, :, :S]
        return t.movedim(1, 2).contiguous()

    return (unchunk(dts[..., None] * gB), unchunk(ddt), dA, unchunk(dB).sum(2),
            unchunk(dC).sum(2), dh0)
