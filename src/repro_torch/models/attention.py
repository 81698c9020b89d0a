"""GQA attention: prefill through the flash-attention kernel, and decode.

Ports ``repro.models.attention``.  Layouts are the
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

Under a mesh (``distributed.sharding`` rules active) q, k and v are
constrained at the reference's places (q on ``act_heads``, k and v on
``act_kv``, the output on ``act_seq``), and the attention core runs on
local shards (``local_region``): K3 takes ``data_ptr()``s, and its
``(B·H, S, Dh)`` views flatten batch and heads, which only a plain tensor
may do.  Local query head j of a rank holding heads h0.. is global head
h0 + j and reads KV head (h0 + j) // G.  Where the rank's heads read its
KV heads in runs of one length (whole groups, part of one group, or G 3
cut into 2 heads a rank: runs of 1), those KV heads are one slice and K3
runs at that run length as its G; otherwise (G 3 cut into 4 heads a rank:
runs of 3 and 1) each local head gets its own copy of its KV head and K3
runs at G 1.  The decode cache is gathered over its sequence shards,
written and read locally, and written back to its placements.
"""

from __future__ import annotations

import math

import torch
from torch.distributed.tensor import DTensor

from repro_torch.distributed.sharding import (constrain, like, local_region, replicated,
                                              shard_range)
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.layers import apply_rope, dense_init, param_dict, tp_input

__all__ = ["NEG_INF", "attention_init", "attention_specs", "attend", "attend_full",
           "init_cache", "cache_specs", "decode_step", "prefill_into_cache"]

NEG_INF = -1e30

_Q = ("batch", None, "act_heads", None)
_KV = ("batch", None, "act_kv", None)
_CACHE = ("batch", None, "kv_heads", None)         # a cache gathered over its sequence

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
    x = tp_input(x)
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q, k, v = constrain(q, _Q), constrain(k, _KV), constrain(v, _KV)
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
    out = torch.einsum("bshk,hkd->bsd", ctx.to(x_dtype), p["wo"])
    return constrain(out, ("batch", "act_seq", None))


def _local_kv(cfg, q, k):
    """How this rank's query heads read its KV heads: None where neither is
    sharded on heads (the kernel's own G), else the local KV head of each
    local query head, as a slice (start, length) when they come in runs of
    one length, or as a list (one KV head a query head)."""
    H, KV = cfg.heads_p, cfg.kv_heads_p
    h0, hl = shard_range(q, 2) if isinstance(q, DTensor) else (0, H)
    k0, kl = shard_range(k, 2) if isinstance(k, DTensor) else (0, KV)
    if hl == H and kl == KV:
        return None
    idx = [(h0 + j) // (H // KV) - k0 for j in range(hl)]
    if not all(0 <= i < kl for i in idx):
        raise ValueError(f"query heads {h0}..{h0 + hl - 1} need KV heads outside this "
                         f"rank's {k0}..{k0 + kl - 1}")
    n = len(set(idx))
    if hl % n == 0 and idx == [idx[0] + j // (hl // n) for j in range(hl)]:
        return (idx[0], n)
    return idx


def _select_kv(t, sel, dim):
    """The KV heads ``sel`` (``_local_kv``) of local ``t`` along ``dim``."""
    if sel is None:
        return t
    if isinstance(sel, tuple):
        return t.narrow(dim, sel[0], sel[1])
    # one copy a query head, by slices: the backward sums them in order
    return torch.cat([t.narrow(dim, i, 1) for i in sel], dim=dim)


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------

def attend(p, cfg, x, positions, window: int = 0):
    """Causal attention of a prompt: x (B, S, d) at positions 0..S-1 (the
    kernel masks by index; ``positions`` feed the rotary embedding), local
    with ``window`` > 0.  Returns (out (B, S, d), (k, v) each (B, S, KVp, Dh)).
    Padded heads go through K3 and are masked after it."""
    q, k, v = _project_qkv(p, cfg, x, positions)
    q, k, v = constrain(q, _Q), constrain(k, _KV), constrain(v, _KV)   # as the region takes them
    sel = _local_kv(cfg, q, k)

    def core(q, k, v):
        k, v = _select_kv(k, sel, 2), _select_kv(v, sel, 2)
        B, S, H, Dh = q.shape
        KV = k.shape[2]
        qr = q.transpose(1, 2).contiguous().view(B * H, S, Dh)        # row b*H + h
        kr = k.transpose(1, 2).contiguous().view(B * KV, S, Dh)       # row b*KV + h//G
        vr = v.transpose(1, 2).contiguous().view(B * KV, S, Dh)
        return flash_attention(qr, kr, vr, window=window).view(B, H, S, Dh).transpose(1, 2)

    ctx = local_region(core, (q, k, v), (_Q, _KV, _KV), _Q)
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
    positions = torch.full((B, 1), pos, dtype=torch.int64, device=x.device)
    q, k_new, v_new = _project_qkv(p, cfg, x, positions)
    kc, vc = replicated(cache["k"], (1,)), replicated(cache["v"], (1,))
    sel = _local_kv(cfg, q, kc)

    def core(q, k_new, v_new, kc, vc):
        S = kc.shape[1]
        slot = pos % S if window else pos
        kc[:, slot] = k_new[:, 0].to(kc.dtype)
        vc[:, slot] = v_new[:, 0].to(vc.dtype)
        # slots 0..pos hold positions 0..pos until a ring has wrapped, then
        # every slot does (the reference's validity age <= min(pos, S - 1)).
        # Slots holding no position are left out, which equals the
        # reference's -1e30 mask on them (their softmax weight is exactly 0).
        T = min(pos + 1, S)
        k = _select_kv(kc[:, :T], sel, 2).float()                     # (B, T, KV, Dh)
        v = _select_kv(vc[:, :T], sel, 2).float()
        Bl, _, H, Dh = q.shape
        KV = k.shape[2]
        qg = (q.float() * (1.0 / math.sqrt(Dh))).reshape(Bl, KV, H // KV, Dh)  # h -> h // G
        s = torch.einsum("bkgd,btkd->bkgt", qg, k)
        probs = torch.softmax(s, dim=-1)
        return torch.einsum("bkgt,btkd->bkgd", probs, v).reshape(Bl, 1, H, Dh)

    ctx = local_region(core, (q, k_new, v_new, kc, vc), (_Q, _KV, _KV, _CACHE, _CACHE), _Q)
    for name, t in (("k", kc), ("v", vc)):
        if t is not cache[name]:                 # a gathered copy: back to the shards
            cache[name].copy_(like(t, cache[name]))
    return _out_proj(p, cfg, ctx, x.dtype), cache


def prefill_into_cache(p, cfg, x, positions, cache, window: int = 0):
    """``attend`` a prompt AND write its K/V into the decode cache, in
    place: into slots 0..S-1, or, for a ring no longer than the prompt, its
    last ``S_cache`` positions, each at slot ``position % S_cache``."""
    out, (k, v) = attend(p, cfg, x, positions, window)
    S_new, S_cache = k.shape[1], cache["k"].shape[1]
    for name, new in (("k", k), ("v", v)):
        c = cache[name]
        if window and S_new >= S_cache:
            # the last S_cache positions rolled by S_new % S_cache slots, as
            # two slices (torch 2.11's DTensor has no strategy for roll)
            tail, shift = new[:, S_new - S_cache:], S_new % S_cache
            new = torch.cat([tail[:, S_cache - shift:], tail[:, :S_cache - shift]], dim=1)
        if new.shape[1] == S_cache:
            c.copy_(like(new.to(c.dtype), c))
        elif isinstance(c, DTensor):             # a prefix of a sharded cache
            full = replicated(c, (1,))
            full.to_local()[:, :S_new] = like(new.to(c.dtype), full).to_local()
            c.copy_(like(full, c))
        else:
            c[:, :S_new] = new.to(c.dtype)
    return out, cache
