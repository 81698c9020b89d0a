"""RG-LRU recurrent block (Griffin / RecurrentGemma).  [arXiv:2402.19427]

Ports ``repro.models.rglru`` for one device.

Block: u -> (x = W_x u, gate = gelu(W_y u)) ; causal depthwise conv(4) on x;
RG-LRU gated linear recurrence; out = (lru ⊙ gate) @ W_out.

RG-LRU per channel:
    r_t = sigmoid(W_a x_t + b_a)            recurrence gate
    i_t = sigmoid(W_i x_t + b_i)            input gate
    a_t = exp(c · r_t · (-softplus(Λ)))     with c = 8
    h_t = a_t ⊙ h_{t-1} + sqrt(1 - a_t²) ⊙ (i_t ⊙ x_t)

The linear recurrence h_t = a_t h_{t-1} + b_t runs over the sequence as a
log-depth scan in plain torch (``_scan``: Hillis–Steele doubling with the
reference's combine, ceil(log2 S) steps of whole-tensor operations, in place
of the reference's ``jax.lax.associative_scan``; the same terms summed in
another order).  Decode is the single-step recurrence with a (B, W) f32
hidden state and the conv history in the model dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init, param_dict

__all__ = ["rglru_init", "rglru_specs", "apply_rglru", "rglru_cache_init",
           "rglru_cache_specs", "rglru_decode_step"]

_C = 8.0  # Griffin's fixed recurrence sharpness


def _width(cfg):
    return cfg.lru_width or cfg.d_model


def rglru_init(gen, cfg, dtype, device):
    """The reference's distributions (not its bits); ``b_a``, ``b_i`` and
    ``lam`` are float32 in every model dtype."""
    d, w = cfg.d_model, _width(cfg)
    f32 = torch.float32
    # Λ init so a^c spans ~(0.9, 0.999) as in the paper
    u = torch.rand((w,), generator=gen, device=gen.device, dtype=f32)
    u = 0.9 ** 2 + u * (0.999 ** 2 - 0.9 ** 2)
    lam = torch.log(torch.expm1(-torch.log(u) / _C))    # softplus^-1(-log u / c)
    conv_w = torch.randn((4, w), generator=gen, device=gen.device, dtype=f32) / 2.0
    return param_dict({
        "w_x": dense_init(gen, (d, w), d, dtype, device),
        "w_gate": dense_init(gen, (d, w), d, dtype, device),
        "conv_w": conv_w.to(device=device, dtype=dtype),
        "conv_b": torch.zeros((w,), dtype=dtype, device=device),
        "w_a": dense_init(gen, (w, w), w, dtype, device),
        "b_a": torch.zeros((w,), dtype=f32, device=device),
        "w_i": dense_init(gen, (w, w), w, dtype, device),
        "b_i": torch.zeros((w,), dtype=f32, device=device),
        "lam": lam.to(device),
        "w_out": dense_init(gen, (w, d), w, dtype, device),
    })


def rglru_specs(cfg):
    return {"w_x": (None, "lru"), "w_gate": (None, "lru"),
            "conv_w": (None, "lru"), "conv_b": ("lru",),
            "w_a": (None, "lru"), "b_a": ("lru",),
            "w_i": (None, "lru"), "b_i": ("lru",),
            "lam": ("lru",), "w_out": ("lru", None)}


def _conv(x, conv_w, conv_b, state=None):
    """Causal depthwise conv over S: x (B, S, w) with the W - 1 previous
    inputs ``state`` (zeros without one).  Returns (out, the last W - 1
    inputs, the padding included when S < W - 1)."""
    W = conv_w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], W - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    else:
        pad = state.to(x.dtype)
    full = torch.cat([pad, x], dim=1)
    S = x.shape[1]
    out = full[:, 0:S] * conv_w[0]
    for i in range(1, W):
        out = out + full[:, i:i + S] * conv_w[i]
    return out + conv_b, full[:, -(W - 1):]


def _gates(p, x):
    """x (..., w) -> a, gated input b, both float32."""
    xf = x.float()
    r = torch.sigmoid(xf @ p["w_a"].float() + p["b_a"])
    i = torch.sigmoid(xf @ p["w_i"].float() + p["b_i"])
    log_a = -_C * r * F.softplus(p["lam"])              # ≤ 0
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * xf)
    return a, b


def _scan(a, b):
    """h_t = a_t h_{t-1} + b_t over dim 1 from h_0 = 0: Hillis–Steele
    doubling.  After the step of offset ``o`` element t holds the
    composition of elements t - 2o + 1 .. t, combined as the reference's
    ``(a1·a2, a2·b1 + b2)`` with the earlier part first."""
    S = a.shape[1]
    o = 1
    while o < S:
        b = torch.cat([b[:, :o], a[:, o:] * b[:, :-o] + b[:, o:]], dim=1)
        if 2 * o < S:                   # the last step needs no new a
            a = torch.cat([a[:, :o], a[:, o:] * a[:, :-o]], dim=1)
        o *= 2
    return b


def _gelu(t):
    return F.gelu(t, approximate="tanh")                # jax.nn.gelu's default


def apply_rglru(p, cfg, u, h0=None, conv_state=None, return_state=False):
    """u (B, S, d) -> (B, S, d); with ``return_state`` also (h (B, w) f32 at
    the last position, the conv history (B, 3, w))."""
    x = u @ p["w_x"]
    gate = _gelu((u @ p["w_gate"]).float())
    x, new_conv = _conv(x, p["conv_w"], p["conv_b"], conv_state)
    a, b = _gates(p, x)
    if h0 is not None:
        # fold the initial state into the first step: h_1 = a_1 h0 + b_1
        b = torch.cat([b[:, :1] + a[:, :1] * h0[:, None], b[:, 1:]], dim=1)
    h = _scan(a, b)
    out = (h * gate).to(u.dtype) @ p["w_out"]
    if return_state:
        return out, (h[:, -1], new_conv)
    return out


def rglru_cache_init(cfg, batch, dtype=torch.float32, *, device):
    w = _width(cfg)
    return {"h": torch.zeros((batch, w), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, 3, w), dtype=dtype, device=device)}


def rglru_cache_specs(cfg):
    return {"h": ("batch", "lru"), "conv": ("batch", None, "lru")}


def rglru_decode_step(p, cfg, u, cache):
    """u (B, 1, d) -> (out (B, 1, d), cache) with the cache updated in place."""
    x = u @ p["w_x"]
    gate = _gelu((u @ p["w_gate"]).float())
    x, new_conv = _conv(x, p["conv_w"], p["conv_b"], cache["conv"])
    a, b = _gates(p, x)
    h = a[:, 0] * cache["h"] + b[:, 0]
    out = (h[:, None] * gate).to(u.dtype) @ p["w_out"]
    cache["h"].copy_(h)
    cache["conv"].copy_(new_conv)
    return out, cache
