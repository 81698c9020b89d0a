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

Local attention (``window > 0``, the ``local_attn`` block): query ``qpos``
sees key ``kpos`` iff ``qpos - window < kpos <= qpos``, in K3 as in the
plain versions, and the decode cache is a ring of ``min(window, max_seq)``
slots in which position ``p`` lives at slot ``p % S``.

Mesh padding (``configs.base.pad_for_mesh``): weights and caches hold
``heads_p`` query and ``kv_heads_p`` KV heads, query head h reads KV head
h // (heads_p // kv_heads_p), and the padded heads' outputs are zeroed
before the output projection (``_head_mask``, as the reference masks them
after its attention), so they add nothing and get zero gradients.  The
padded heads still run through K3 and its backward: idle work on the
padded share, as in the reference.  ``attention_specs`` and ``cache_specs``
give the reference's logical sharding axes of each tree.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.layers import apply_rope, dense_init, param_dict

__all__ = ["NEG_INF", "attention_init", "attention_specs", "attend", "attend_full",
           "init_cache", "cache_specs", "decode_step", "prefill_into_cache"]

NEG_INF = -1e30

# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

def attention_init(gen, cfg, dtype, device):
    d, h, kv, dh = cfg.d_model, cfg.heads_p, cfg.kv_heads_p, cfg.head_dim
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


def attention_specs(cfg):
    p = {"wq": (None, "heads", None), "wk": (None, "kv_heads", None),
         "wv": (None, "kv_heads", None), "wo": ("heads", None, None)}
    if cfg.qkv_bias:
        p["bq"] = ("heads", None)
        p["bk"] = ("kv_heads", None)
        p["bv"] = ("kv_heads", None)
    return p


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
    """(B, S, KVp, Dh) -> (B, S, Hp, Dh)."""
    g = cfg.heads_p // cfg.kv_heads_p
    if g == 1:
        return t
    return torch.repeat_interleave(t, g, dim=2)


def _head_mask(cfg, dtype, device):
    """1 for real heads, 0 for mesh-padding heads (Hp,); None unpadded."""
    if cfg.heads_p == cfg.n_heads:
        return None
    return (torch.arange(cfg.heads_p, device=device) < cfg.n_heads).to(dtype)


def _out_proj(p, cfg, ctx, x_dtype):
    """ctx (B, S, Hp, Dh) -> (B, S, d), the padded heads masked out."""
    mask = _head_mask(cfg, ctx.dtype, ctx.device)
    if mask is not None:
        ctx = ctx * mask[:, None]
    return torch.einsum("bshk,hkd->bsd", ctx.to(x_dtype), p["wo"])


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------

def attend(p, cfg, x, positions, window: int = 0):
    """Causal attention of a prompt: x (B, S, d) at positions 0..S-1 (the
    kernel masks by index; ``positions`` feed the rotary embedding), local
    with ``window`` > 0.  Returns (out (B, S, d), (k, v) each (B, S, KVp, Dh)).
    Padded heads go through K3 and are masked after it."""
    B, S, _ = x.shape
    H, KV, Dh = cfg.heads_p, cfg.kv_heads_p, cfg.head_dim
    q, k, v = _project_qkv(p, cfg, x, positions)
    qr = q.transpose(1, 2).contiguous().view(B * H, S, Dh)            # row b*H + h
    kr = k.transpose(1, 2).contiguous().view(B * KV, S, Dh)           # row b*KV + h//G
    vr = v.transpose(1, 2).contiguous().view(B * KV, S, Dh)
    ctx = flash_attention(qr, kr, vr, window=window).view(B, H, S, Dh).transpose(1, 2)
    return _out_proj(p, cfg, ctx, x.dtype), (k, v)


def attend_full(p, cfg, x, positions, window: int = 0):
    """Plain model-level version of ``attend``: (S, S) scores, masked by
    position, fp32 softmax."""
    q, k, v = _project_qkv(p, cfg, x, positions)
    kh = _repeat_kv(k, cfg).float()
    vh = _repeat_kv(v, cfg).float()
    scale = 1.0 / math.sqrt(cfg.head_dim)
    scores = torch.einsum("bqhk,bshk->bhqs", q.float() * scale, kh)
    qpos, kpos = positions[..., :, None], positions[..., None, :]
    mask = kpos <= qpos
    if window:
        mask = mask & (kpos > qpos - window)
    mask = mask[:, None] if mask.dim() == 3 else mask
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bhqs,bshk->bqhk", probs, vh)
    return _out_proj(p, cfg, ctx, x.dtype), (k, v)


# ---------------------------------------------------------------------------
# decode path (single new token against a cache)
# ---------------------------------------------------------------------------

def init_cache(cfg, batch, max_seq, window: int = 0, dtype=torch.bfloat16, *,
               device):
    """K/V of ``max_seq`` slots, or a ring of ``min(window, max_seq)``."""
    S = min(window, max_seq) if window else max_seq
    kv, dh = cfg.kv_heads_p, cfg.head_dim
    return {"k": torch.zeros((batch, S, kv, dh), dtype=dtype, device=device),
            "v": torch.zeros((batch, S, kv, dh), dtype=dtype, device=device)}


def cache_specs(window: int = 0):
    # a ring (local attention) is small: its slots stay unsharded; a full
    # cache shards its sequence over the model axis (split-KV decode)
    seq_axis = None if window else "kv_seq"
    return {"k": ("batch", seq_axis, "kv_heads", None),
            "v": ("batch", seq_axis, "kv_heads", None)}


def decode_step(p, cfg, x, cache, pos: int, window: int = 0):
    """x (B, 1, d); ``pos`` the token's position (a Python int).  Writes
    the token's K/V into ``cache`` IN PLACE at slot ``pos`` (``pos % S`` in
    a ring) and attends over the slots that hold a position.  Returns
    (out (B, 1, d), cache)."""
    B = x.shape[0]
    H, KV, Dh = cfg.heads_p, cfg.kv_heads_p, cfg.head_dim
    positions = torch.full((B, 1), pos, dtype=torch.int64, device=x.device)
    q, k_new, v_new = _project_qkv(p, cfg, x, positions)
    S = cache["k"].shape[1]
    slot = pos % S if window else pos
    cache["k"][:, slot] = k_new[:, 0].to(cache["k"].dtype)
    cache["v"][:, slot] = v_new[:, 0].to(cache["v"].dtype)
    # slots 0..pos hold positions 0..pos until a ring has wrapped, then
    # every slot does (the reference's validity age <= min(pos, S - 1)).
    # Slots holding no position are left out, which equals the reference's
    # -1e30 mask on them (their softmax weight is exactly 0).
    T = min(pos + 1, S)
    k = cache["k"][:, :T].float()                                     # (B, T, KV, Dh)
    v = cache["v"][:, :T].float()
    scale = 1.0 / math.sqrt(Dh)
    qg = (q.float() * scale).reshape(B, KV, H // KV, Dh)              # head h -> kv h // G
    s = torch.einsum("bkgd,btkd->bkgt", qg, k)
    probs = torch.softmax(s, dim=-1)
    ctx = torch.einsum("bkgt,btkd->bkgd", probs, v).reshape(B, 1, H, Dh)
    return _out_proj(p, cfg, ctx, x.dtype), cache


def prefill_into_cache(p, cfg, x, positions, cache, window: int = 0):
    """``attend`` a prompt AND write its K/V into the decode cache, in
    place: into slots 0..S-1, or, for a ring no longer than the prompt, its
    last ``S_cache`` positions, each at slot ``position % S_cache``."""
    out, (k, v) = attend(p, cfg, x, positions, window)
    S_new, S_cache = k.shape[1], cache["k"].shape[1]
    if window and S_new >= S_cache:
        roll = S_new % S_cache
        cache["k"].copy_(torch.roll(k[:, S_new - S_cache:], roll, dims=1))
        cache["v"].copy_(torch.roll(v[:, S_new - S_cache:], roll, dims=1))
    else:
        cache["k"][:, :S_new] = k.to(cache["k"].dtype)
        cache["v"][:, :S_new] = v.to(cache["v"].dtype)
    return out, cache
