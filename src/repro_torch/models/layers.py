"""Shared neural-net layers: parameter initialisers and plain tensor applies.

Ports ``repro.models.layers``.  Parameters keep the reference's layouts
(dense weights ``(in, out)``, embedding ``(V, d)``) and live in
``nn.ParameterDict``s, so ``p["scale"]`` reads as in the reference and a
weight converts from the JAX package by a copy, with no transpose.  The
reference's sharding ``constrain`` calls are dropped: this is one device.
Initialisers draw from an explicit ``torch.Generator``: the same
distributions as the reference, not its bits.  ``norm_specs``,
``mlp_specs`` and ``embedding_specs`` return the reference's trees of
logical sharding axes (tuples) for the norm, MLP and embedding parameters:
plain data for the rule tables of the multi-device slice.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["dense_init", "embed_init", "norm_init", "norm_specs", "apply_norm",
           "rope_frequencies", "apply_rope", "sinusoidal_pos_emb", "mlp_init", "mlp_specs",
           "apply_mlp", "embedding_init", "embedding_specs", "embed_tokens", "logits_head",
           "param_dict"]


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------

def param_dict(tensors: dict[str, torch.Tensor]) -> nn.ParameterDict:
    """Parameters, frozen by default: serving needs no gradient.  The
    training entry points (``training.train_loop``, ``launch.train``) call
    ``requires_grad_(True)`` on the whole tree."""
    return nn.ParameterDict({k: nn.Parameter(t, requires_grad=False)
                             for k, t in tensors.items()})


def _normal(gen: torch.Generator, shape, std: float, dtype, device) -> torch.Tensor:
    """N(0, std^2) drawn in float32 on the generator's device, then cast and
    placed on ``device``; on the ``meta`` device, shape and dtype only (no
    draw, nothing allocated: ``launch.steps.build_train``'s abstract shapes)."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    t = torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32)
    return (t * std).to(device=device, dtype=dtype)


def dense_init(gen, shape, in_axis_size, dtype, device):
    return _normal(gen, shape, 1.0 / math.sqrt(in_axis_size), dtype, device)


def embed_init(gen, shape, dtype, device):
    return _normal(gen, shape, 0.02, dtype, device)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def norm_init(d, norm_type, dtype, device):
    p = {"scale": torch.ones((d,), dtype=dtype, device=device)}
    if norm_type == "layer":
        p["bias"] = torch.zeros((d,), dtype=dtype, device=device)
    return param_dict(p)


def norm_specs(norm_type):
    p = {"scale": ("embed",)}
    if norm_type == "layer":
        p["bias"] = ("embed",)
    return p


def apply_norm(p, x, norm_type, eps):
    xf = x.float()
    if norm_type == "rms":
        ms = torch.mean(xf * xf, dim=-1, keepdim=True)
        out = xf * torch.rsqrt(ms + eps) * p["scale"].float()
    elif norm_type == "layer":
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
        out = (xf - mu) * torch.rsqrt(var + eps) * p["scale"].float() + p["bias"].float()
    else:
        raise ValueError(norm_type)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# positional embeddings
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exponents)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, Dh); positions: broadcastable to (..., S).  The
    split-halves convention: the first Dh/2 lanes rotate against the last."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)            # (Dh/2,)
    angles = positions[..., None].float() * freqs                     # (..., S, Dh/2)
    cos = torch.cos(angles)[..., None, :]                             # (..., S, 1, Dh/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoidal_pos_emb(positions: torch.Tensor, d_model: int) -> torch.Tensor:
    """positions (...,) -> (..., d_model) float32 fixed sinusoidal embedding,
    ``[sin | cos]`` of the position times d_model/2 frequencies."""
    half = d_model // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32, device=positions.device)
                      / half)
    angles = positions[..., None].float() * freqs
    return torch.cat([torch.sin(angles), torch.cos(angles)], dim=-1)


# ---------------------------------------------------------------------------
# MLP (SwiGLU / GeGLU / GELU)
# ---------------------------------------------------------------------------

def mlp_init(gen, cfg, dtype, device):
    d, f = cfg.d_model, cfg.d_ff
    if cfg.mlp_type in ("swiglu", "geglu"):
        return param_dict({"w_gate": dense_init(gen, (d, f), d, dtype, device),
                           "w_up": dense_init(gen, (d, f), d, dtype, device),
                           "w_down": dense_init(gen, (f, d), f, dtype, device)})
    return param_dict({"w_up": dense_init(gen, (d, f), d, dtype, device),
                       "w_down": dense_init(gen, (f, d), f, dtype, device)})


def mlp_specs(cfg):
    if cfg.mlp_type in ("swiglu", "geglu"):
        return {"w_gate": (None, "ff"), "w_up": (None, "ff"), "w_down": ("ff", None)}
    return {"w_up": (None, "ff"), "w_down": ("ff", None)}


def apply_mlp(p, cfg, x):
    if cfg.mlp_type in ("swiglu", "geglu"):
        # jax.nn.gelu's default is the tanh approximation
        act = F.silu if cfg.mlp_type == "swiglu" else (
            lambda t: F.gelu(t, approximate="tanh"))
        h = act(x @ p["w_gate"]) * (x @ p["w_up"])
    else:
        h = F.gelu(x @ p["w_up"], approximate="tanh")
    return h @ p["w_down"]


# ---------------------------------------------------------------------------
# token embedding + output head
# ---------------------------------------------------------------------------

def embedding_init(gen, cfg, dtype, device):
    """The token table (Vp, d) and, untied, the head (d, Vp): ``vocab_p``
    rows and columns, the mesh-padding ones never read by a token and
    masked out of the logits."""
    p = {"tokens": embed_init(gen, (cfg.vocab_p, cfg.d_model), dtype, device)}
    if not cfg.tie_embeddings:
        p["head"] = dense_init(gen, (cfg.d_model, cfg.vocab_p), cfg.d_model, dtype, device)
    return param_dict(p)


def embedding_specs(cfg):
    # a tied table stays vocab-sharded (the logits product dominates); an
    # untied input table shards d_model instead, so its gather is local
    if cfg.tie_embeddings:
        return {"tokens": ("vocab", "embed")}
    return {"tokens": (None, "embed_tbl"), "head": ("embed", "vocab")}


def embed_tokens(p, tokens):
    return p["tokens"][tokens]


def logits_head(p, cfg, x):
    """x (..., d) -> float32 logits (..., Vp): the tied embedding (or the
    untied head), an optional soft cap, then the mesh-padding columns set
    to -1e30 in f32, so the softmax gives them exactly 0 (and they get zero
    gradients)."""
    if cfg.tie_embeddings:
        logits = x @ p["tokens"].T
    else:
        logits = x @ p["head"]
    if cfg.logits_soft_cap > 0:
        cap = cfg.logits_soft_cap
        logits = cap * torch.tanh(logits.float() / cap)
    logits = logits.float()
    if cfg.vocab_p != cfg.vocab_size:
        pad = torch.arange(cfg.vocab_p, device=logits.device) >= cfg.vocab_size
        logits = logits.masked_fill(pad, -1e30)
    return logits
