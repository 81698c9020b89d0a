"""Block composition and the layer stack.

Ports ``repro.models.transformer`` for the dense and SSM families.  A
config's layer sequence is ``block_pattern × n_groups + tail_pattern``; the
port keeps it as an ``nn.ModuleList`` of per-layer blocks in that order, run
by a Python loop: nothing is scanned and nothing is rematerialised (the
reference's ``lax.scan`` and remat exist for XLA's compile time and
training memory).

Block kinds: ``attn`` (norm -> GQA attention -> residual -> norm -> MLP ->
residual) and ``ssm`` (norm -> Mamba-2 block -> one residual).  The
reference's ``moe``, ``rglru`` and ``local_attn`` raise
``NotImplementedError`` naming their ROADMAP queue-1 slice.

Caches are a list with one dict per layer, ``{"k", "v"}`` for ``attn`` and
``{"h", "conv"}`` for ``ssm``, updated in place.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import attention as attn_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import apply_mlp, apply_norm, mlp_init, norm_init

__all__ = ["Block", "block_init", "apply_block", "block_cache_init", "decode_block",
           "stack_init", "apply_stack", "stack_cache_init", "decode_stack"]

_NOT_PORTED = {
    "rglru": "the rglru/local_attn slice",
    "local_attn": "the rglru/local_attn slice",
    "moe": "the moe slice",
}


def _check_kind(kind: str) -> None:
    if kind in ("attn", "ssm"):
        return
    if kind in _NOT_PORTED:
        raise NotImplementedError(f"block kind {kind!r} is not ported yet: ROADMAP "
                                  f"queue 1, {_NOT_PORTED[kind]}")
    raise ValueError(kind)


class Block(nn.ModuleDict):
    """One layer's parameter groups (``norm1``, ``attn``, ``norm2``,
    ``ffn`` for ``attn``; ``norm1``, ``ssm`` for ``ssm``), read as
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
    return Block(kind, {
        "norm1": norm1,
        "attn": attn_mod.attention_init(gen, cfg, dtype, device),
        "norm2": norm_init(cfg.d_model, cfg.norm_type, dtype, device),
        "ffn": mlp_init(gen, cfg, dtype, device),
    })


def apply_block(p, cfg, kind, x, positions, cache=None):
    """Prefill/forward of one block.  Returns (x, cache_or_None); with a
    cache, the prompt's K/V (``attn``) or final state and conv history
    (``ssm``) are written into it in place."""
    _check_kind(kind)
    h = apply_norm(p["norm1"], x, cfg.norm_type, cfg.norm_eps)
    if kind == "ssm":
        if cache is None:
            return x + ssm_mod.apply_ssm(p["ssm"], cfg, h), None
        s, (hT, conv) = ssm_mod.apply_ssm(p["ssm"], cfg, h, return_state=True)
        cache["h"].copy_(hT)
        cache["conv"].copy_(conv)
        return x + s, cache
    if cache is not None:
        a, cache = attn_mod.prefill_into_cache(p["attn"], cfg, h, positions, cache)
    else:
        a, _ = attn_mod.attend(p["attn"], cfg, h, positions)
    x = x + a
    h = apply_norm(p["norm2"], x, cfg.norm_type, cfg.norm_eps)
    x = x + apply_mlp(p["ffn"], cfg, h)
    return x, cache


def block_cache_init(cfg, kind, batch, cache_len, dtype=torch.bfloat16, *, device):
    _check_kind(kind)
    if kind == "ssm":
        return ssm_mod.ssm_cache_init(cfg, batch, dtype, device=device)
    return attn_mod.init_cache(cfg, batch, cache_len, 0, dtype, device=device)


def decode_block(p, cfg, kind, x, cache, pos: int):
    """One-token decode.  x (B, 1, d); returns (x, cache) with the cache
    updated in place."""
    _check_kind(kind)
    h = apply_norm(p["norm1"], x, cfg.norm_type, cfg.norm_eps)
    if kind == "ssm":
        s, cache = ssm_mod.ssm_decode_step(p["ssm"], cfg, h, cache)
        return x + s, cache
    a, cache = attn_mod.decode_step(p["attn"], cfg, h, cache, pos)
    x = x + a
    h = apply_norm(p["norm2"], x, cfg.norm_type, cfg.norm_eps)
    x = x + apply_mlp(p["ffn"], cfg, h)
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
