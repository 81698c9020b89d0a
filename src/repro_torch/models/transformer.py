"""Block composition and the layer stack.

Ports ``repro.models.transformer`` for every family.  A config's layer
sequence is ``block_pattern × n_groups + tail_pattern``; the
port keeps it as an ``nn.ModuleList`` of per-layer blocks in that order, run
by a Python loop: nothing is scanned and nothing is rematerialised (the
reference's ``lax.scan`` and remat exist for XLA's compile time and
training memory).

Block kinds: ``attn`` (norm -> GQA attention -> residual -> norm -> MLP ->
residual), ``local_attn`` (the same with ``window = cfg.local_window``),
``moe`` (the same with the expert layer as its MLP, in prefill and decode),
``ssm`` (norm -> Mamba-2 block -> one residual) and ``rglru`` (norm ->
RG-LRU block -> residual -> norm -> MLP -> residual).  Another kind raises
``ValueError``.

Caches are a list with one dict per layer, ``{"k", "v"}`` for the
attention kinds (a ring of ``min(local_window, cache_len)`` slots for
``local_attn``) and ``{"h", "conv"}`` for ``ssm`` and ``rglru``, updated
in place.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import apply_mlp, apply_norm, mlp_init, norm_init

__all__ = ["Block", "block_init", "apply_block", "block_cache_init", "decode_block",
           "stack_init", "apply_stack", "stack_cache_init", "decode_stack"]

_ATTN_KINDS = ("attn", "local_attn", "moe")
_KINDS = _ATTN_KINDS + ("ssm", "rglru")


def _check_kind(kind: str) -> None:
    if kind not in _KINDS:
        raise ValueError(f"unknown block kind {kind!r}; known: {_KINDS}")


def _window(cfg, kind: str) -> int:
    return cfg.local_window if kind == "local_attn" else 0


def _ffn(p, cfg, kind, h):
    return (moe_mod.apply_moe(p["ffn"], cfg, h) if kind == "moe"
            else apply_mlp(p["ffn"], cfg, h))


class Block(nn.ModuleDict):
    """One layer's parameter groups (``norm1``, ``attn``, ``norm2``,
    ``ffn`` for the attention kinds; ``norm1``, ``ssm`` for ``ssm``;
    ``norm1``, ``rec``, ``norm2``, ``ffn`` for ``rglru``), read as
    ``p["attn"]["wq"]``; ``kind`` names the block kind."""

    def __init__(self, kind: str, groups: dict[str, nn.Module]) -> None:
        _check_kind(kind)
        super().__init__(groups)
        self.kind = kind


# ---------------------------------------------------------------------------
# single block
# ---------------------------------------------------------------------------

def block_init(gen, cfg, kind, dtype, device) -> Block:
    _check_kind(kind)
    norm1 = norm_init(cfg.d_model, cfg.norm_type, dtype, device)
    if kind == "ssm":
        return Block(kind, {"norm1": norm1,
                            "ssm": ssm_mod.ssm_init(gen, cfg, dtype, device)})
    if kind == "rglru":
        return Block(kind, {
            "norm1": norm1,
            "rec": rglru_mod.rglru_init(gen, cfg, dtype, device),
            "norm2": norm_init(cfg.d_model, cfg.norm_type, dtype, device),
            "ffn": mlp_init(gen, cfg, dtype, device),
        })
    return Block(kind, {
        "norm1": norm1,
        "attn": attn_mod.attention_init(gen, cfg, dtype, device),
        "norm2": norm_init(cfg.d_model, cfg.norm_type, dtype, device),
        "ffn": (moe_mod.moe_init(gen, cfg, dtype, device) if kind == "moe"
                else mlp_init(gen, cfg, dtype, device)),
    })


def apply_block(p, cfg, kind, x, positions, cache=None):
    """Prefill/forward of one block.  Returns (x, cache_or_None); with a
    cache, the prompt's K/V (attention kinds) or final state and conv
    history (``ssm``, ``rglru``) are written into it in place."""
    _check_kind(kind)
    h = apply_norm(p["norm1"], x, cfg.norm_type, cfg.norm_eps)
    if kind in ("ssm", "rglru"):
        apply = ssm_mod.apply_ssm if kind == "ssm" else rglru_mod.apply_rglru
        group = p["ssm"] if kind == "ssm" else p["rec"]
        if cache is None:
            r = apply(group, cfg, h)
        else:
            r, (hT, conv) = apply(group, cfg, h, return_state=True)
            cache["h"].copy_(hT)
            cache["conv"].copy_(conv)
        x = x + r
        if kind == "ssm":
            return x, cache
        h = apply_norm(p["norm2"], x, cfg.norm_type, cfg.norm_eps)
        return x + apply_mlp(p["ffn"], cfg, h), cache
    window = _window(cfg, kind)
    if cache is not None:
        a, cache = attn_mod.prefill_into_cache(p["attn"], cfg, h, positions, cache, window)
    else:
        a, _ = attn_mod.attend(p["attn"], cfg, h, positions, window)
    x = x + a
    h = apply_norm(p["norm2"], x, cfg.norm_type, cfg.norm_eps)
    x = x + _ffn(p, cfg, kind, h)
    return x, cache


def block_cache_init(cfg, kind, batch, cache_len, dtype=torch.bfloat16, *, device):
    _check_kind(kind)
    if kind == "ssm":
        return ssm_mod.ssm_cache_init(cfg, batch, dtype, device=device)
    if kind == "rglru":
        return rglru_mod.rglru_cache_init(cfg, batch, dtype, device=device)
    return attn_mod.init_cache(cfg, batch, cache_len, _window(cfg, kind), dtype,
                               device=device)


def decode_block(p, cfg, kind, x, cache, pos: int):
    """One-token decode.  x (B, 1, d); returns (x, cache) with the cache
    updated in place."""
    _check_kind(kind)
    h = apply_norm(p["norm1"], x, cfg.norm_type, cfg.norm_eps)
    if kind == "ssm":
        s, cache = ssm_mod.ssm_decode_step(p["ssm"], cfg, h, cache)
        return x + s, cache
    if kind == "rglru":
        a, cache = rglru_mod.rglru_decode_step(p["rec"], cfg, h, cache)
    else:
        a, cache = attn_mod.decode_step(p["attn"], cfg, h, cache, pos, _window(cfg, kind))
    x = x + a
    h = apply_norm(p["norm2"], x, cfg.norm_type, cfg.norm_eps)
    x = x + _ffn(p, cfg, kind, h)
    return x, cache


# ---------------------------------------------------------------------------
# the stack, in layer order
# ---------------------------------------------------------------------------

def stack_init(gen, cfg, dtype, device) -> nn.ModuleList:
    return nn.ModuleList(block_init(gen, cfg, kind, dtype, device)
                         for kind in cfg.layer_kinds)


def apply_stack(stack, cfg, x, positions, caches=None):
    """Forward through all layers.  With ``caches`` (prefill) each layer's
    cache is filled in place and the list is returned."""
    for i, block in enumerate(stack):
        x, _ = apply_block(block, cfg, block.kind, x, positions,
                           None if caches is None else caches[i])
    return x, caches


def stack_cache_init(cfg, batch, cache_len, dtype=torch.bfloat16, *, device):
    return [block_cache_init(cfg, kind, batch, cache_len, dtype, device=device)
            for kind in cfg.layer_kinds]


def decode_stack(stack, cfg, x, caches, pos: int):
    for block, cache in zip(stack, caches):
        x, _ = decode_block(block, cfg, block.kind, x, cache, pos)
    return x, caches
