"""The unpadded model inside a mesh-padded one, and the padded model's pad slots.

``pad_for_mesh`` pads a config's query heads, KV heads, vocab and experts;
the padded model's parameters hold the unpadded model's in their first
slots, and the rest (the pad slots) are inert.  ``unpadded`` cuts a padded
model's parameters back to the unpadded model of the same function, and
``pad_slots`` names every pad entry, whose gradient must be exactly 0.

One case needs more than a cut.  Without ``pad_kv`` a GQA config's padded
heads share the same KV heads, so the group size G grows from
``n_heads // n_kv_heads`` to ``heads_p // kv_heads_p`` and real query head h
reads KV head h // G_padded (the reference's rule).  The unpadded model of
that function has one KV head a query head (``n_kv_heads = n_heads``), each
KV head h holding the padded model's KV head h // G_padded.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["regroups", "unpadded_config", "unpadded", "pad_slots"]


def regroups(cfg) -> bool:
    """True where padding moved a real query head to another KV head."""
    g, gp = cfg.n_heads // cfg.n_kv_heads, cfg.heads_p // cfg.kv_heads_p
    return any(h // g != h // gp for h in range(cfg.n_heads))


def unpadded_config(cfg):
    """The unpadded config computing what padded ``cfg`` computes."""
    base = dataclasses.replace(cfg, n_heads_padded=0, n_kv_heads_padded=0, vocab_padded=0,
                               n_experts_padded=0)
    return dataclasses.replace(base, n_kv_heads=cfg.n_heads) if regroups(cfg) else base


def _kv_index(cfg) -> torch.Tensor:
    """The padded KV head each KV head of ``unpadded_config`` copies."""
    if regroups(cfg):
        return torch.arange(cfg.n_heads) // (cfg.heads_p // cfg.kv_heads_p)
    return torch.arange(cfg.n_kv_heads)


def _cut(name: str, t: torch.Tensor, cfg) -> torch.Tensor:
    """The unpadded part of the padded parameter ``name`` (a port name,
    ``stack.3.attn.wq``); parameters with no padded axis as they are."""
    group, leaf = name.split(".")[-2:]
    H, V, E = cfg.n_heads, cfg.vocab_size, cfg.n_experts
    if group == "embedding":
        return t[:V] if leaf == "tokens" else t[:, :V]
    if group == "attn":
        kv = _kv_index(cfg).to(t.device)
        return {"wq": lambda: t[:, :H], "bq": lambda: t[:H], "wo": lambda: t[:H],
                "wk": lambda: t[:, kv], "wv": lambda: t[:, kv],
                "bk": lambda: t[kv], "bv": lambda: t[kv]}[leaf]()
    if group == "ffn" and cfg.n_experts:
        return t[:, :E] if leaf == "router" else t[:E]
    return t


def unpadded(params, cfg, model):
    """(the unpadded model's parameters, its config) from the padded
    ``params`` of ``cfg``, on their device and in their dtypes; ``model``
    the port's ``models.model`` module."""
    ucfg = unpadded_config(cfg)
    named = dict(params.named_parameters())
    device = next(iter(named.values())).device
    out = model.init_params(ucfg, torch.Generator(), device="meta").to_empty(device=device)
    with torch.no_grad():
        for name, p in out.named_parameters():
            p.copy_(_cut(name, named[name], cfg))
    return out, ucfg


def pad_slots(name: str, shape, cfg) -> torch.Tensor | None:
    """A bool mask over the padded parameter ``name`` (of ``shape``), True
    on its pad entries, or None where it has none.  A KV head is a pad slot
    where every query head that reads it is one."""
    group, leaf = name.split(".")[-2:]
    mask = torch.zeros(shape, dtype=torch.bool)
    if group == "embedding":
        axis = 0 if leaf == "tokens" else 1
        idx = torch.arange(shape[axis]) >= cfg.vocab_size
    elif group == "attn":
        g = cfg.heads_p // cfg.kv_heads_p
        q = leaf in ("wq", "bq", "wo")
        axis = 0 if leaf in ("bq", "bk", "bv", "wo") else 1
        heads = torch.arange(shape[axis])
        idx = heads >= cfg.n_heads if q else heads * g >= cfg.n_heads
    elif group == "ffn" and cfg.n_experts:
        axis = 1 if leaf == "router" else 0
        idx = torch.arange(shape[axis]) >= cfg.n_experts
    else:
        return None
    if not idx.any():
        return None
    view = [1] * len(shape)
    view[axis] = shape[axis]
    return mask | idx.view(view)
