"""GQA attention: prefill through the flash-attention kernel, and decode.

Ports ``repro.models.attention`` for one device.  Layouts are the
reference's head-major ones: weights ``wq (d, H, Dh)``, ``wk``/``wv``
``(d, KV, Dh)``, ``wo (H, Dh, d)``; activations ``(B, S, H, Dh)``.

Execution paths sharing one set of weights:

* ``attend``      — prefill: causal GQA attention over positions 0..S-1 by
  ``kernels.flash_attention.flash_attention``: kernel K3 for CUDA tensors,
  its plain version ``mha_ref`` for CPU tensors.  It computes what the
  reference's ``attend_full`` and ``attend_chunked`` compute for a prompt
  (the reference reaches neither its Pallas kernel nor anything like it
  from the model; here the kernel *is* the prefill's attention).
* ``attend_full`` — the plain model-level version: materialises (S, S)
  scores with repeated KV, masked by position.
* ``decode_step`` — one token against the cache, in plain torch as in the
  reference (no kernel there either).

Local attention (``window > 0``) is not in this slice: it raises
``NotImplementedError`` (ROADMAP queue 1, the ``rglru``/``local_attn``
slice).  Mesh-padding heads (the reference's ``_head_mask``) come with the
multi-device slice.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.layers import apply_rope, dense_init, param_dict

__all__ = ["NEG_INF", "attention_init", "attend", "attend_full", "init_cache",
           "decode_step", "prefill_into_cache"]

NEG_INF = -1e30
_LOCAL = ("local attention (window > 0) is not ported yet: ROADMAP queue 1, "
          "the rglru/local_attn slice")


def _no_window(window: int) -> None:
    if window:
        raise NotImplementedError(_LOCAL)


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

def attention_init(gen, cfg, dtype, device):
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "wq": dense_init(gen, (d, h, dh), d, dtype, device),
        "wk": dense_init(gen, (d, kv, dh), d, dtype, device),
        "wv": dense_init(gen, (d, kv, dh), d, dtype, device),
        "wo": dense_init(gen, (h, dh, d), h * dh, dtype, device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((h, dh), dtype=dtype, device=device)
        p["bk"] = torch.zeros((kv, dh), dtype=dtype, device=device)
        p["bv"] = torch.zeros((kv, dh), dtype=dtype, device=device)
    return param_dict(p)


def _project_qkv(p, cfg, x, positions):
    """x (B, S, d) -> q (B, S, H, Dh); k, v (B, S, KV, Dh), biased and rotated."""
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if cfg.pos_emb == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _repeat_kv(t, cfg):
    """(B, S, KV, Dh) -> (B, S, H, Dh)."""
    g = cfg.n_heads // cfg.n_kv_heads
    if g == 1:
        return t
    return torch.repeat_interleave(t, g, dim=2)


def _out_proj(p, ctx, x_dtype):
    """ctx (B, S, H, Dh) -> (B, S, d)."""
    return torch.einsum("bshk,hkd->bsd", ctx.to(x_dtype), p["wo"])


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------

def attend(p, cfg, x, positions, window: int = 0):
    """Causal attention of a prompt: x (B, S, d) at positions 0..S-1 (the
    kernel masks by index; ``positions`` feed the rotary embedding).
    Returns (out (B, S, d), (k, v) each (B, S, KV, Dh))."""
    _no_window(window)
    B, S, _ = x.shape
    H, KV, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v = _project_qkv(p, cfg, x, positions)
    qr = q.transpose(1, 2).contiguous().view(B * H, S, Dh)            # row b*H + h
    kr = k.transpose(1, 2).contiguous().view(B * KV, S, Dh)           # row b*KV + h//G
    vr = v.transpose(1, 2).contiguous().view(B * KV, S, Dh)
    ctx = flash_attention(qr, kr, vr).view(B, H, S, Dh).transpose(1, 2)
    return _out_proj(p, ctx, x.dtype), (k, v)


def attend_full(p, cfg, x, positions, window: int = 0):
    """Plain model-level version of ``attend``: (S, S) scores, masked by
    position, fp32 softmax."""
    _no_window(window)
    q, k, v = _project_qkv(p, cfg, x, positions)
    kh = _repeat_kv(k, cfg).float()
    vh = _repeat_kv(v, cfg).float()
    scale = 1.0 / math.sqrt(cfg.head_dim)
    scores = torch.einsum("bqhk,bshk->bhqs", q.float() * scale, kh)
    mask = positions[..., None, :] <= positions[..., :, None]         # kpos <= qpos
    mask = mask[:, None] if mask.dim() == 3 else mask
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bhqs,bshk->bqhk", probs, vh)
    return _out_proj(p, ctx, x.dtype), (k, v)


# ---------------------------------------------------------------------------
# decode path (single new token against a cache)
# ---------------------------------------------------------------------------

def init_cache(cfg, batch, max_seq, window: int = 0, dtype=torch.bfloat16, *,
               device):
    _no_window(window)
    kv, dh = cfg.n_kv_heads, cfg.head_dim
    return {"k": torch.zeros((batch, max_seq, kv, dh), dtype=dtype, device=device),
            "v": torch.zeros((batch, max_seq, kv, dh), dtype=dtype, device=device)}


def decode_step(p, cfg, x, cache, pos: int, window: int = 0):
    """x (B, 1, d); ``pos`` the token's position (a Python int).  Writes
    the token's K/V into ``cache`` IN PLACE at slot ``pos`` and attends
    over slots 0..pos.  Returns (out (B, 1, d), cache)."""
    _no_window(window)
    B = x.shape[0]
    H, KV, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    positions = torch.full((B, 1), pos, dtype=torch.int64, device=x.device)
    q, k_new, v_new = _project_qkv(p, cfg, x, positions)
    cache["k"][:, pos] = k_new[:, 0].to(cache["k"].dtype)
    cache["v"][:, pos] = v_new[:, 0].to(cache["v"].dtype)
    # slots past pos hold no token yet; leaving them out equals the
    # reference's -1e30 mask on them (their softmax weight is exactly 0)
    k = cache["k"][:, :pos + 1].float()                               # (B, T, KV, Dh)
    v = cache["v"][:, :pos + 1].float()
    scale = 1.0 / math.sqrt(Dh)
    qg = (q.float() * scale).reshape(B, KV, H // KV, Dh)              # head h -> kv h // G
    s = torch.einsum("bkgd,btkd->bkgt", qg, k)
    probs = torch.softmax(s, dim=-1)
    ctx = torch.einsum("bkgt,btkd->bkgd", probs, v).reshape(B, 1, H, Dh)
    return _out_proj(p, ctx, x.dtype), cache


def prefill_into_cache(p, cfg, x, positions, cache, window: int = 0):
    """``attend`` a prompt AND write its K/V into slots 0..S-1 of the decode
    cache, in place."""
    out, (k, v) = attend(p, cfg, x, positions, window)
    S = k.shape[1]
    cache["k"][:, :S] = k.to(cache["k"].dtype)
    cache["v"][:, :S] = v.to(cache["v"].dtype)
    return out, cache
