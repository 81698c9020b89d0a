"""Language-model API: init, forward, loss, prefill, decode, generate.

Ports ``repro.models.model`` for every family (dense, frontend, SSM,
hybrid and MoE) on one device.
The parameters are an ``nn.ModuleDict`` laid out as the reference's tree
(``params["embedding"]["tokens"]``, ``params["final_norm"]["scale"]``),
except that ``params["stack"]`` is an ``nn.ModuleList`` of per-layer
blocks in layer order instead of groups stacked along a leading axis.
``params_from_numpy`` converts the reference's parameters (as numpy
arrays) into this layout by copies alone, so both packages can run the
same weights.

Modality frontends are stubs, as in the reference: ``forward`` and
``prefill`` take ``embeds`` (B, P, d), precomputed frame or patch
embeddings that replace the token embeddings of the first P <= S
positions of a config with a ``frontend``.  Sinusoidal positions are added
to the input embeddings in prefill and decode.

``param_specs`` and ``cache_specs`` return the reference's trees of
logical sharding axes (plain data, resolved by the rule tables of the
multi-device slice).  They follow the reference's stacked layout: the spec
of the port's layer ``g · len(block_pattern) + i`` is
``["stack"]["groups"]["b{i}_{kind}"]`` with its leading (layer) axis
dropped, and tail layer ``i``'s is ``["stack"]["tail"][i]``.

Mesh padding: a config from ``configs.base.pad_for_mesh`` draws its
parameters at the padded sizes (``heads_p``, ``kv_heads_p``, ``vocab_p``,
``experts_p``), and ``params_from_numpy`` takes the reference's padded
tree as it is.

``loss_fn`` is the training objective (reference ``model.py:76``):
next-token NLL, the frontend's prefix positions masked out, differentiable
through every layer; on the card its attention runs kernel K3 forward and
backward (``kernels.flash_attention.ops``).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.models import transformer as tf
from repro_torch.models.layers import (apply_norm, embed_tokens, embedding_init,
                                       embedding_specs, logits_head, norm_init, norm_specs,
                                       param_dict, sinusoidal_pos_emb)

__all__ = ["init_params", "param_specs", "params_from_numpy", "forward", "loss_fn",
           "cache_init", "cache_specs", "prefill", "decode_step", "decode_greedy",
           "greedy_generate"]


def _dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def init_params(cfg, generator: torch.Generator, device="cuda") -> nn.ModuleDict:
    """Random weights with the reference's distributions (not its bits),
    drawn from ``generator`` on its own device and placed on ``device``."""
    dev = resolve_device(device)
    dtype = _dtype(cfg)
    return nn.ModuleDict({
        "embedding": embedding_init(generator, cfg, dtype, dev),
        "stack": tf.stack_init(generator, cfg, dtype, dev),
        "final_norm": norm_init(cfg.d_model, cfg.norm_type, dtype, dev),
    })


def param_specs(cfg) -> dict:
    return {"embedding": embedding_specs(cfg), "stack": tf.stack_specs(cfg),
            "final_norm": norm_specs(cfg.norm_type)}


def params_from_numpy(cfg, tree, device="cuda") -> nn.ModuleDict:
    """The port's parameters from the reference's tree of numpy arrays,
    ``jax.tree.map(np.asarray, repro.models.model.init_params(key, cfg))``.
    ``stack.groups`` (leading ``n_groups`` axis) is unstacked into one block
    per layer, then the tail.  An array the tree holds in float32 stays
    float32 (the SSM's ``A_log``, ``D`` and ``dt_bias``, the RG-LRU's
    ``b_a``, ``b_i`` and ``lam``, and the MoE router, in every model dtype);
    the rest are cast to ``cfg.dtype`` (exact for a tree in that dtype)."""
    dev = resolve_device(device)
    dtype = _dtype(cfg)

    def tensor(a):
        keep = a.dtype == np.float32
        return torch.from_numpy(np.array(a, np.float32)).to(
            device=dev, dtype=torch.float32 if keep else dtype)

    def tensors(group, index=None):
        return param_dict({name: tensor(a if index is None else a[index])
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


def _embed_inputs(params, cfg, tokens, embeds, positions):
    """Token embeddings in the model dtype; with a frontend and ``embeds``
    (B, P, d), positions 0..P-1 take ``embeds`` instead; then the
    sinusoidal position embedding, where the config has one."""
    x = embed_tokens(params["embedding"], tokens).to(_dtype(cfg))
    if cfg.frontend is not None and embeds is not None:
        if embeds.shape[1] > x.shape[1]:
            raise ValueError(f"embeds cover {embeds.shape[1]} positions, more than "
                             f"the prompt's {x.shape[1]}")
        x[:, :embeds.shape[1]] = embeds.to(x.dtype)
    if cfg.pos_emb == "sinusoidal":
        x = x + sinusoidal_pos_emb(positions, cfg.d_model).to(x.dtype)
    return x


def forward(params, cfg, tokens: torch.Tensor, embeds: torch.Tensor | None = None
            ) -> torch.Tensor:
    """tokens (B, S) -> logits (B, S, V) float32."""
    B, S = tokens.shape
    positions = _positions(B, 0, S, tokens.device)
    x = _embed_inputs(params, cfg, tokens, embeds, positions)
    x, _ = tf.apply_stack(params["stack"], cfg, x, positions)
    x = apply_norm(params["final_norm"], x, cfg.norm_type, cfg.norm_eps)
    return logits_head(params["embedding"], cfg, x)


def _nll(logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Summed masked NLL of f32 logits (..., V) at int labels (...).  The
    gold logit is a ``gather`` of one label a position, whose backward
    writes each position's own slot (no colliding indices)."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return ((logz - gold) * mask).sum()


def _xent(logits, labels, mask):
    """logits (B, S, V) fp32, labels (B, S) int, mask (B, S) -> mean nll."""
    return _nll(logits, labels, mask) / torch.clamp(mask.sum(), min=1.0)


def loss_fn(params, cfg, batch) -> torch.Tensor:
    """batch: {"tokens": (B, S) int, optional "embeds": (B, n_prefix, d)}.
    Next-token prediction; frontend-prefix positions are masked out.  With
    ``cfg.loss_chunk`` dividing S - 1 (and below it) the vocab projection
    runs over (B, loss_chunk, V) blocks in a loop, summing NLL and mask in
    the reference's scan order; under autograd each block's logits are
    still kept for the backward."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    positions = _positions(B, 0, S, tokens.device)
    x = _embed_inputs(params, cfg, tokens, batch.get("embeds"), positions)
    x, _ = tf.apply_stack(params["stack"], cfg, x, positions)
    x = apply_norm(params["final_norm"], x, cfg.norm_type, cfg.norm_eps)
    labels = tokens[:, 1:]
    mask = (positions[:, 1:] >= cfg.n_prefix).float()
    h = x[:, :-1]
    C = cfg.loss_chunk
    if C and (S - 1) % C == 0 and S - 1 > C:
        nll = msum = torch.zeros((), dtype=torch.float32, device=tokens.device)
        for c in range(0, S - 1, C):
            logits = logits_head(params["embedding"], cfg, h[:, c:c + C])
            nll = nll + _nll(logits, labels[:, c:c + C], mask[:, c:c + C])
            msum = msum + mask[:, c:c + C].sum()
        return nll / torch.clamp(msum, min=1.0)
    return _xent(logits_head(params["embedding"], cfg, h), labels, mask)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def cache_init(cfg, batch, cache_len, dtype=None, device="cuda"):
    """Empty per-layer K/V caches of ``cache_len`` slots on ``device``."""
    return tf.stack_cache_init(cfg, batch, cache_len, dtype or _dtype(cfg),
                               device=resolve_device(device))


def cache_specs(cfg) -> dict:
    return tf.stack_cache_specs(cfg)


def prefill(params, cfg, tokens: torch.Tensor, cache_len: int | None = None,
            embeds: torch.Tensor | None = None):
    """Process a prompt, returning (last-position logits (B, V) fp32, the
    per-layer caches filled with its K/V)."""
    B, S = tokens.shape
    positions = _positions(B, 0, S, tokens.device)
    x = _embed_inputs(params, cfg, tokens, embeds, positions)
    caches = cache_init(cfg, B, cache_len or S, device=tokens.device)
    x, caches = tf.apply_stack(params["stack"], cfg, x, positions, caches)
    x = apply_norm(params["final_norm"], x, cfg.norm_type, cfg.norm_eps)
    logits = logits_head(params["embedding"], cfg, x[:, -1:])
    return logits[:, 0], caches


def decode_step(params, cfg, token: torch.Tensor, caches, pos: int):
    """token (B,); ``pos`` the position of this token.  Returns (logits
    (B, V) fp32, caches) with the caches updated in place."""
    x = embed_tokens(params["embedding"], token[:, None]).to(_dtype(cfg))
    if cfg.pos_emb == "sinusoidal":
        x = x + sinusoidal_pos_emb(_positions(x.shape[0], pos, 1, x.device),
                                   cfg.d_model).to(x.dtype)
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
