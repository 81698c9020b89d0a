"""Block composition and the layer stack.

Ports ``repro.models.transformer`` for every family.  A config's layer
sequence is ``block_pattern × n_groups + tail_pattern``; the
port keeps it as an ``nn.ModuleList`` of per-layer blocks in that order, run
by a Python loop: nothing is scanned (the reference's ``lax.scan`` exists
for XLA's compile time).

Rematerialisation follows ``cfg.remat`` as the reference's ``_remat`` does:
with grad enabled and no caches, each group of ``len(block_pattern)``
consecutive layers runs under a non-reentrant
``torch.utils.checkpoint.checkpoint``, so its forward runs again in the
backward; the tail's layers run unwrapped.  ``"none"`` keeps every
activation; ``"dots"`` keeps the outputs of the products with no batch
dimension (``_keep_products``: the projections and the MLP, as
``checkpoint_dots_with_no_batch_dims`` does) and recomputes the rest,
attention and the SSD scan included; any other value (``"full"``, the
default) keeps only each group's input.  A recomputed forward gives the
same bits, so the policy changes memory and time, never a number.  Under
``torch.no_grad`` / ``inference_mode`` and in prefill nothing is wrapped.

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

The ``*_specs`` helpers return the reference's logical-axis trees
unchanged: ``stack_specs`` and ``stack_cache_specs`` give ``{"groups":
{"b{i}_{kind}": ...}, "tail": [...]}`` with a leading unsharded layer axis
on every ``groups`` spec (the reference stacks a group's layers along it).
Layer ``g · len(block_pattern) + i`` of the port's list takes the spec of
``groups["b{i}_{kind}"]`` with that leading axis dropped; tail layer ``i``
takes ``tail[i]``.
"""

from __future__ import annotations

from functools import partial

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (apply_mlp, apply_norm, mlp_init, mlp_specs,
                                       norm_init, norm_specs)

__all__ = ["Block", "block_init", "block_specs", "apply_block", "block_cache_init",
           "block_cache_specs", "decode_block", "stack_init", "stack_specs", "apply_stack",
           "stack_cache_init", "stack_cache_specs", "decode_stack"]

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


def block_specs(cfg, kind):
    _check_kind(kind)
    p = {"norm1": norm_specs(cfg.norm_type)}
    if kind == "ssm":
        p["ssm"] = ssm_mod.ssm_specs(cfg)
        return p
    if kind == "rglru":
        p["rec"] = rglru_mod.rglru_specs(cfg)
    else:
        p["attn"] = attn_mod.attention_specs(cfg)
    p["norm2"] = norm_specs(cfg.norm_type)
    p["ffn"] = moe_mod.moe_specs(cfg) if kind == "moe" else mlp_specs(cfg)
    return p


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


def block_cache_specs(cfg, kind):
    _check_kind(kind)
    if kind == "ssm":
        return ssm_mod.ssm_cache_specs(cfg)
    if kind == "rglru":
        return rglru_mod.rglru_cache_specs(cfg)
    return attn_mod.cache_specs(_window(cfg, kind))


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


def _stacked(spec):
    """A group's spec tree with the leading (unsharded) layer axis added."""
    if isinstance(spec, dict):
        return {k: _stacked(v) for k, v in spec.items()}
    return (None,) + tuple(spec)


def _group_specs(cfg, specs_of):
    groups = {f"b{i}_{kind}": _stacked(specs_of(cfg, kind))
              for i, kind in enumerate(cfg.block_pattern)}
    return {"groups": groups, "tail": [specs_of(cfg, kind) for kind in cfg.tail_pattern]}


def stack_specs(cfg):
    return _group_specs(cfg, block_specs)


_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _keep_products(ctx, op, *args, **kwargs):
    """``"dots"``: keep what ``mm`` and ``addmm`` return (``x @ w``), and a
    ``bmm`` over one batch entry (``einsum``'s form of a product with no
    batch dimension: the attention projections); recompute the rest."""
    if op in _PRODUCTS or (op is torch.ops.aten.bmm.default and args[0].shape[0] == 1):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(cfg, fn):
    """``fn`` under ``cfg.remat``: as it is (``"none"``), checkpointed
    keeping the products (``"dots"``), or checkpointed whole."""
    if cfg.remat == "none":
        return fn
    if cfg.remat == "dots":
        return partial(checkpoint, fn, use_reentrant=False,
                       context_fn=partial(create_selective_checkpoint_contexts, _keep_products))
    return partial(checkpoint, fn, use_reentrant=False)


def _apply_layers(blocks, cfg, x, positions):
    for block in blocks:
        x, _ = apply_block(block, cfg, block.kind, x, positions)
    return x


def apply_stack(stack, cfg, x, positions, caches=None):
    """Forward through all layers.  With ``caches`` (prefill) each layer's
    cache is filled in place and the list is returned.  Otherwise, with
    grad enabled, each ``block_pattern`` group runs under ``_remat``."""
    if caches is not None:
        for block, cache in zip(stack, caches):
            x, _ = apply_block(block, cfg, block.kind, x, positions, cache)
        return x, caches
    layers = list(stack)
    size = len(cfg.block_pattern)
    body = cfg.n_groups * size
    group = _remat(cfg, _apply_layers) if torch.is_grad_enabled() else _apply_layers
    for g in range(0, body, size):
        x = group(layers[g:g + size], cfg, x, positions)
    return _apply_layers(layers[body:], cfg, x, positions), None


def stack_cache_init(cfg, batch, cache_len, dtype=torch.bfloat16, *, device):
    return [block_cache_init(cfg, kind, batch, cache_len, dtype, device=device)
            for kind in cfg.layer_kinds]


def stack_cache_specs(cfg):
    return _group_specs(cfg, block_cache_specs)


def decode_stack(stack, cfg, x, caches, pos: int):
    for block, cache in zip(stack, caches):
        x, _ = decode_block(block, cfg, block.kind, x, cache, pos)
    return x, caches
