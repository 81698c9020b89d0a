"""Mamba-2 (SSD — state-space duality) block.  [arXiv:2405.21060]

Ports ``repro.models.ssm`` for one device.  Chunked SSD: the sequence is cut
into chunks; within a chunk the recurrence is computed in its dual
quadratic "attention" form, and across chunks a small recurrence on the
(H, P, N) states links them.  Decode is the plain recurrence, O(1) in
sequence length.

Block layout (Mamba-2 defaults): in-proj -> causal depthwise conv(4) on
(x, B, C) -> SSD -> gated RMSNorm -> out-proj.  Scalar A per head;
ngroups = 1.  The prefill's SSD goes through ``kernels.ssd_scan.ops.ssd_scan``
(kernel K4 for CUDA tensors, ``ssd_chunked`` for CPU tensors); decode stays
plain torch, as the reference has no kernel there.  ``A_log``, ``D`` and
``dt_bias`` are float32 in every model dtype, as in the reference.  The
reference's sharding specs and ``constrain`` calls are dropped: this is
one device.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_scan.ops import chunk_length, ssd_scan
from repro_torch.models.layers import dense_init, param_dict

__all__ = ["ssm_init", "ssm_specs", "apply_ssm", "ssm_cache_init", "ssm_cache_specs",
           "ssm_decode_step", "ssd_chunked", "ssd_recurrent"]


def _dims(cfg):
    d_inner = cfg.ssm_expand * cfg.d_model
    n_heads = d_inner // cfg.ssm_head_dim
    return d_inner, n_heads, cfg.ssm_state


def ssm_init(gen, cfg, dtype, device):
    """The reference's distributions (not its bits), drawn from ``gen``."""
    d = cfg.d_model
    di, nh, ns = _dims(cfg)
    conv_ch = di + 2 * ns                     # x, B, C all pass the conv
    f32 = dict(dtype=torch.float32, device=device)
    p = {
        "in_z": dense_init(gen, (d, di), d, dtype, device),
        "in_x": dense_init(gen, (d, di), d, dtype, device),
        "in_B": dense_init(gen, (d, ns), d, dtype, device),
        "in_C": dense_init(gen, (d, ns), d, dtype, device),
        "in_dt": dense_init(gen, (d, nh), d, dtype, device),
        "conv_w": dense_init(gen, (cfg.ssm_conv, conv_ch), cfg.ssm_conv, dtype, device),
    }
    u = torch.rand((nh,), generator=gen, device=gen.device, dtype=torch.float32)
    dt = torch.exp(u * (math.log(0.1) - math.log(0.001)) + math.log(0.001)).to(device)
    p.update({
        "conv_b": torch.zeros((conv_ch,), dtype=dtype, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nh, **f32)),
        "D": torch.ones((nh,), **f32),
        "dt_bias": torch.log(torch.expm1(dt)),    # softplus^-1(dt)
        "norm_scale": torch.ones((di,), dtype=dtype, device=device),
        "out": dense_init(gen, (di, d), di, dtype, device),
    })
    return param_dict(p)


def ssm_specs(cfg):
    return {"in_z": (None, "ssm_inner"), "in_x": (None, "ssm_inner"),
            "in_B": (None, None), "in_C": (None, None),
            "in_dt": (None, None), "conv_w": (None, None), "conv_b": (None,),
            "A_log": (None,), "D": (None,), "dt_bias": (None,),
            "norm_scale": ("ssm_inner",), "out": ("ssm_inner", None)}


def _causal_conv(xbc, conv_w, conv_b, conv_state=None):
    """Depthwise causal conv over time.  xbc (B, S, CH); conv_w (W, CH).
    With ``conv_state`` (B, W-1, CH) the history is prepended (decode).
    The reference's shifted sum of W products, in xbc's dtype and order."""
    W = conv_w.shape[0]
    if conv_state is None:
        pad = torch.zeros((xbc.shape[0], W - 1, xbc.shape[2]), dtype=xbc.dtype,
                          device=xbc.device)
    else:
        pad = conv_state.to(xbc.dtype)
    full = torch.cat([pad, xbc], dim=1)                              # (B, S+W-1, CH)
    S = xbc.shape[1]
    out = sum(full[:, i:i + S] * conv_w[i][None, None] for i in range(W))
    return F.silu(out + conv_b[None, None]), full[:, -(W - 1):]


def _segsum(a):
    """a (..., L) -> (..., L, L) lower-tri cumulative sums: sum_{i<s<=j} a_s."""
    L = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]                       # (..., j, i)
    mask = torch.ones((L, L), dtype=torch.bool, device=a.device).tril()
    return torch.where(mask, diff, torch.full_like(diff, -math.inf))


def ssd_chunked(x, dt, A, Bm, Cm, chunk, h0=None):
    """SSD in chunked dual form.

    x  (B, S, H, P) inputs per head
    dt (B, S, H)    softplus'd step sizes
    A  (H,)         negative scalars
    Bm, Cm (B, S, N) shared across heads (ngroups=1)
    h0 (B, H, P, N) optional initial state
    Returns y (B, S, H, P) and final state (B, H, P, N).
    """
    Bsz, S, H, Pd = x.shape
    N = Bm.shape[-1]
    Q = chunk_length(S, chunk)
    nc = S // Q
    xb = x.reshape(Bsz, nc, Q, H, Pd)
    dtb = dt.reshape(Bsz, nc, Q, H)
    Bb = Bm.reshape(Bsz, nc, Q, N)
    Cb = Cm.reshape(Bsz, nc, Q, N)
    a = dtb * A[None, None, None]                                    # (B,nc,Q,H) <= 0
    a = torch.movedim(a, -1, 1)                                      # (B,H,nc,Q)
    a_cum = torch.cumsum(a, dim=-1)
    L = torch.exp(_segsum(a))                                        # (B,H,nc,Q,Q)
    xdt = xb * dtb[..., None]                                        # dt-weighted input
    # intra-chunk (dual quadratic form)
    y_diag = torch.einsum("bcln,bcsn,bhcls,bcshp->bclhp", Cb, Bb, L, xdt)
    # chunk-final states
    decay_states = torch.exp(a_cum[..., -1:] - a_cum)                # (B,H,nc,Q)
    states = torch.einsum("bcln,bhcl,bclhp->bchpn", Bb, decay_states, xdt)
    first = torch.zeros_like(states[:, :1]) if h0 is None else h0[:, None].to(states.dtype)
    states = torch.cat([first, states], dim=1)                       # (B,nc+1,H,P,N)
    # inter-chunk recurrence (over nc+1 states)
    chunk_decay = a_cum[..., -1]                                     # (B,H,nc)
    pad = F.pad(chunk_decay, (1, 0))
    dec = torch.exp(_segsum(pad))                                    # (B,H,nc+1,nc+1)
    dec = torch.where(torch.isfinite(dec), dec, torch.zeros_like(dec))
    new_states = torch.einsum("bhzc,bchpn->bzhpn", dec, states)      # (B,nc+1,H,P,N)
    prev_states, final_state = new_states[:, :-1], new_states[:, -1]
    # inter-chunk contribution to outputs
    state_decay = torch.exp(a_cum)                                   # (B,H,nc,Q)
    y_off = torch.einsum("bcln,bchpn,bhcl->bclhp", Cb, prev_states, state_decay)
    y = (y_diag + y_off).reshape(Bsz, S, H, Pd)
    return y, final_state


def ssd_recurrent(x, dt, A, Bm, Cm, h0):
    """Single-step recurrence (decode).  x (B,1,H,P) ... h0 (B,H,P,N)."""
    a = torch.exp(dt[:, 0] * A[None])                                # (B,H)
    xdt = x[:, 0] * dt[:, 0, :, None]                                # (B,H,P)
    h = a[..., None, None] * h0 + torch.einsum("bhp,bn->bhpn", xdt, Bm[:, 0])
    y = torch.einsum("bn,bhpn->bhp", Cm[:, 0], h)
    return y[:, None], h


def _gated_norm(y, z, scale, eps):
    yf = y.float() * F.silu(z.float())
    ms = torch.mean(yf * yf, dim=-1, keepdim=True)
    return yf * torch.rsqrt(ms + eps) * scale.float()


def _proj_all(p, x):
    z = x @ p["in_z"]
    xi = x @ p["in_x"]
    Bm = x @ p["in_B"]
    Cm = x @ p["in_C"]
    dt = F.softplus((x @ p["in_dt"]).float() + p["dt_bias"][None, None])
    return z, xi, Bm, Cm, dt


def _conv_split(p, cfg, x, conv_state):
    """In-projections and the causal conv: (z, xi, Bm, Cm, dt, new conv
    state), xi/Bm/Cm as views of the conv's output."""
    di, _, ns = _dims(cfg)
    z, xi, Bm, Cm, dt = _proj_all(p, x)
    xbc = torch.cat([xi, Bm, Cm], dim=-1)
    xbc, new_conv = _causal_conv(xbc, p["conv_w"], p["conv_b"], conv_state)
    xi, Bm, Cm = torch.split(xbc, [di, ns, ns], dim=-1)
    return z, xi, Bm, Cm, dt, new_conv


def _out(p, cfg, y, xh, z, dtype):
    """Skip term D·x, gated RMSNorm and the out-projection."""
    B, S = y.shape[:2]
    y = (y + xh * p["D"][None, None, :, None]).reshape(B, S, -1)
    return _gated_norm(y, z, p["norm_scale"], cfg.norm_eps).to(dtype) @ p["out"]


def apply_ssm(p, cfg, x, return_state=False):
    """Full-sequence Mamba-2 block from a zero state.  x (B, S, d) ->
    (B, S, d); with ``return_state`` also (final SSD state (B, H, P, N) f32,
    conv state)."""
    B, S, _ = x.shape
    _, nh, _ = _dims(cfg)
    z, xi, Bm, Cm, dt, new_conv = _conv_split(p, cfg, x, None)
    A = -torch.exp(p["A_log"])
    # the kernel takes contiguous f32 operands in the model layout
    xh = xi.float().reshape(B, S, nh, cfg.ssm_head_dim).contiguous()
    y, hT = ssd_scan(xh, dt, A, Bm.float().contiguous(), Cm.float().contiguous(),
                     chunk=cfg.ssm_chunk)
    out = _out(p, cfg, y, xh, z, x.dtype)
    if return_state:
        return out, (hT, new_conv)
    return out


# -- decode ------------------------------------------------------------------

def ssm_cache_init(cfg, batch, dtype=torch.float32, *, device):
    """Empty decode state: ``h`` (B, H, P, N) float32 and ``conv``
    (B, W-1, CH) in ``dtype``."""
    di, nh, ns = _dims(cfg)
    conv_ch = di + 2 * ns
    return {"h": torch.zeros((batch, nh, cfg.ssm_head_dim, ns), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_ch), dtype=dtype,
                                device=device)}


def ssm_cache_specs(cfg):
    return {"h": ("batch", None, None, None), "conv": ("batch", None, None)}


def ssm_decode_step(p, cfg, x, cache):
    """x (B, 1, d); cache {h, conv} -> (out (B, 1, d), cache), the cache
    updated in place."""
    B = x.shape[0]
    _, nh, _ = _dims(cfg)
    z, xi, Bm, Cm, dt, new_conv = _conv_split(p, cfg, x, cache["conv"])
    A = -torch.exp(p["A_log"])
    xh = xi.float().reshape(B, 1, nh, cfg.ssm_head_dim)
    y, h = ssd_recurrent(xh, dt, A, Bm.float(), Cm.float(), cache["h"])
    cache["h"].copy_(h)
    cache["conv"].copy_(new_conv)
    return _out(p, cfg, y, xh, z, x.dtype), cache
