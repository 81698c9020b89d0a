"""Language-model API for serving: init, forward, prefill, decode, generate.

Ports ``repro.models.model`` for the dense family on one device.  The
parameters are an ``nn.ModuleDict`` laid out as the reference's tree
(``params["embedding"]["tokens"]``, ``params["final_norm"]["scale"]``),
except that ``params["stack"]`` is an ``nn.ModuleList`` of per-layer
blocks in layer order instead of groups stacked along a leading axis.
``params_from_numpy`` converts the reference's parameters (as numpy
arrays) into this layout by copies alone, so both packages can run the
same weights.

Modality frontends, sinusoidal positions, ``loss_fn`` and training are
not in this slice (ROADMAP queue 1).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.models import transformer as tf
from repro_torch.models.layers import (apply_norm, embed_tokens, embedding_init,
                                       logits_head, norm_init, param_dict)

__all__ = ["init_params", "params_from_numpy", "forward", "cache_init", "prefill",
           "decode_step", "decode_greedy", "greedy_generate"]


def _dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _check_supported(cfg) -> None:
    if cfg.frontend is not None or cfg.pos_emb == "sinusoidal":
        raise NotImplementedError(
            f"{cfg.name}: modality frontends and sinusoidal positions are not "
            f"ported yet (ROADMAP queue 1)")


def init_params(cfg, generator: torch.Generator, device="cuda") -> nn.ModuleDict:
    """Random weights with the reference's distributions (not its bits),
    drawn from ``generator`` on its own device and placed on ``device``."""
    _check_supported(cfg)
    dev = resolve_device(device)
    dtype = _dtype(cfg)
    return nn.ModuleDict({
        "embedding": embedding_init(generator, cfg, dtype, dev),
        "stack": tf.stack_init(generator, cfg, dtype, dev),
        "final_norm": norm_init(cfg.d_model, cfg.norm_type, dtype, dev),
    })


def params_from_numpy(cfg, tree, device="cuda") -> nn.ModuleDict:
    """The port's parameters from the reference's tree of numpy arrays,
    ``jax.tree.map(np.asarray, repro.models.model.init_params(key, cfg))``.
    ``stack.groups`` (leading ``n_groups`` axis) is unstacked into one block
    per layer, then the tail; values are cast to ``cfg.dtype`` (exact for a
    tree in that dtype)."""
    _check_supported(cfg)
    dev = resolve_device(device)
    dtype = _dtype(cfg)

    def tensors(group, index=None):
        return param_dict({
            name: torch.from_numpy(np.array(a if index is None else a[index],
                                            np.float32)).to(device=dev, dtype=dtype)
            for name, a in group.items()})

    def block(kind, p, index=None):
        return tf.Block(kind, {name: tensors(group, index) for name, group in p.items()})

    groups = tree["stack"]["groups"]
    layers = [block(kind, groups[f"b{i}_{kind}"], g)
              for g in range(cfg.n_groups) for i, kind in enumerate(cfg.block_pattern)]
    layers += [block(kind, tree["stack"]["tail"][i])
               for i, kind in enumerate(cfg.tail_pattern)]
    return nn.ModuleDict({
        "embedding": tensors(tree["embedding"]),
        "stack": nn.ModuleList(layers),
        "final_norm": tensors(tree["final_norm"]),
    })


def _positions(batch: int, start: int, length: int, device) -> torch.Tensor:
    pos = torch.arange(start, start + length, dtype=torch.int64, device=device)
    return pos[None].expand(batch, length)


def forward(params, cfg, tokens: torch.Tensor) -> torch.Tensor:
    """tokens (B, S) -> logits (B, S, V) float32."""
    B, S = tokens.shape
    positions = _positions(B, 0, S, tokens.device)
    x = embed_tokens(params["embedding"], tokens).to(_dtype(cfg))
    x, _ = tf.apply_stack(params["stack"], cfg, x, positions)
    x = apply_norm(params["final_norm"], x, cfg.norm_type, cfg.norm_eps)
    return logits_head(params["embedding"], cfg, x)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def cache_init(cfg, batch, cache_len, dtype=None, device="cuda"):
    """Empty per-layer K/V caches of ``cache_len`` slots on ``device``."""
    return tf.stack_cache_init(cfg, batch, cache_len, dtype or _dtype(cfg),
                               device=resolve_device(device))


def prefill(params, cfg, tokens: torch.Tensor, cache_len: int | None = None):
    """Process a prompt, returning (last-position logits (B, V) fp32, the
    per-layer caches filled with its K/V)."""
    B, S = tokens.shape
    positions = _positions(B, 0, S, tokens.device)
    x = embed_tokens(params["embedding"], tokens).to(_dtype(cfg))
    caches = cache_init(cfg, B, cache_len or S, device=tokens.device)
    x, caches = tf.apply_stack(params["stack"], cfg, x, positions, caches)
    x = apply_norm(params["final_norm"], x, cfg.norm_type, cfg.norm_eps)
    logits = logits_head(params["embedding"], cfg, x[:, -1:])
    return logits[:, 0], caches


def decode_step(params, cfg, token: torch.Tensor, caches, pos: int):
    """token (B,); ``pos`` the position of this token.  Returns (logits
    (B, V) fp32, caches) with the caches updated in place."""
    x = embed_tokens(params["embedding"], token[:, None]).to(_dtype(cfg))
    x, caches = tf.decode_stack(params["stack"], cfg, x, caches, pos)
    x = apply_norm(params["final_norm"], x, cfg.norm_type, cfg.norm_eps)
    return logits_head(params["embedding"], cfg, x)[:, 0], caches


def decode_greedy(params, cfg, first: torch.Tensor, caches, pos: int, n_new: int):
    """Greedy tokens (B, n_new) starting with ``first`` (B,) at position
    ``pos``: n_new - 1 decode steps (the reference's last step computes a
    token it drops)."""
    if n_new < 1:
        raise ValueError(f"n_new={n_new}: generate at least one token")
    toks = [first]
    for i in range(n_new - 1):
        logits, caches = decode_step(params, cfg, toks[-1], caches, pos + i)
        toks.append(torch.argmax(logits, dim=-1))
    return torch.stack(toks, dim=1)


def greedy_generate(params, cfg, prompt: torch.Tensor, n_new: int,
                    cache_len: int | None = None) -> torch.Tensor:
    """prompt (B, S) -> greedy continuation (B, n_new)."""
    S = prompt.shape[1]
    logits, caches = prefill(params, cfg, prompt, cache_len or (S + n_new))
    return decode_greedy(params, cfg, torch.argmax(logits, dim=-1), caches, S, n_new)
