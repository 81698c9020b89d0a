"""Mixture-of-Experts layer: top-k routing + capacity-bounded dispatch.

Ports ``repro.models.moe``'s one-device path.  Dispatch is index-based, as
in the reference: an int slot table maps each (expert, position-in-expert)
slot to the token it holds, token rows are gathered into per-expert
capacity buffers (B, E, C, d), each expert runs its SwiGLU on its buffer,
and each token sums its k weighted expert rows.  Capacity is per sequence,
C = ceil(S·k·cf / E) (``moe_capacity``); a choice whose position in its
expert reaches C is dropped and adds nothing, so its token passes through
the residual untouched.

Every step is deterministic on the card, forward and backward: positions
are one cumsum of int one-hots, the inverse slot table is written by one
``scatter_`` whose indices are all distinct (dropped choices go to slots of
their own past the table, which are then cut off), the dispatch writes each
choice's token row into its slot by a ``scatter_`` of distinct indices the
same way (its gradient gathers each token's k slot rows and sums them; a
gather from the tokens would scatter-add duplicates with atomics), and the
combine gathers each token's k rows and sums them in rank order j = 0..k-1
instead of the reference's scatter-add (the same terms in another order).
No atomics, so a rematerialised layer recomputes the same bits.

Mesh-padding experts (``experts_p`` > ``n_experts``, set by
``configs.base.pad_for_mesh``): the router and the expert weights hold
``experts_p`` of them, the router's padded columns are set to -1e30 before
the softmax so no token is routed to one, the slot table spans
``experts_p · C`` slots (the padded experts' rows stay empty) and only the
``n_experts`` real experts run their FFN, as in the reference's one-device
path.  The padded experts' weights and router columns get zero
gradients.

``apply_moe`` is ``apply_moe_local``: the reference's ``shard_map`` expert
parallelism (all-gather / psum-scatter and the all-to-all dispatch) comes
with the multi-device slice.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init, param_dict

__all__ = ["moe_init", "moe_specs", "apply_moe", "apply_moe_local", "apply_moe_ref",
           "moe_capacity"]


def moe_init(gen, cfg, dtype, device):
    """Router (d, Ep) in float32 in every model dtype; experts (Ep, d, f) and
    (Ep, f, d)."""
    d, f, E = cfg.d_model, cfg.d_ff, cfg.experts_p
    return param_dict({
        "router": dense_init(gen, (d, E), d, torch.float32, device),
        "w_gate": dense_init(gen, (E, d, f), d, dtype, device),
        "w_up": dense_init(gen, (E, d, f), d, dtype, device),
        "w_down": dense_init(gen, (E, f, d), f, dtype, device),
    })


def moe_specs(cfg):
    # expert weights shard over the data axis ("fsdp") as well as expert
    # parallelism, gathered a layer at a time inside the expert-parallel map
    return {"router": (None, None),
            "w_gate": ("experts", "fsdp", None),
            "w_up": ("experts", "fsdp", None),
            "w_down": ("experts", "fsdp", None)}


def moe_capacity(cfg, seq_len: int) -> int:
    c = math.ceil(seq_len * cfg.experts_per_token * cfg.capacity_factor
                  / cfg.n_experts)
    return max(4, min(int(c), seq_len)) if seq_len > 1 else cfg.experts_per_token


# ---------------------------------------------------------------------------
# routing: token -> (expert, position-in-expert) with per-sequence capacity
# ---------------------------------------------------------------------------

def _route(cfg, x, router, capacity):
    """x (B, S, d) -> gates gk (B, S, k) f32, slot (B, S, k) in [0, Ep·C]
    (Ep·C = dropped), slot_token (B, Ep·C + 1) the token index per slot (S =
    empty), and the full softmax gates (B, S, Ep), exactly 0 on the
    mesh-padding experts."""
    B, S, _ = x.shape
    E, k = cfg.n_experts, cfg.experts_per_token
    C, Etab = capacity, cfg.experts_p
    logits = x.float() @ router                                      # (B, S, Ep)
    if router.shape[1] != E:
        pad = torch.arange(router.shape[1], device=x.device) >= E
        logits = logits.masked_fill(pad, -1e30)
    gates_full = torch.softmax(logits, dim=-1)
    gk, ik = torch.topk(gates_full, k, dim=-1)                       # (B, S, k)
    gk = gk / gk.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    # position-in-expert: priority by (k, token), all rank-0 choices first:
    # the choices in that order (rank-major), each counting the earlier
    # choices of its expert -- the reference's per-rank counts plus rank
    # within the rank, in one cumsum
    order = ik.transpose(1, 2).reshape(B, k * S)                     # (B, k·S)
    oh = F.one_hot(order, E)                                         # (B, k·S, E) int64
    earlier = (torch.cumsum(oh, dim=1) - oh).gather(2, order[..., None])[..., 0]
    pos = earlier.view(B, k, S).transpose(1, 2)                      # (B, S, k)
    slot = torch.where(pos >= C, Etab * C, ik * C + pos)             # (B, S, k)
    # invert slot -> token: kept slots are distinct, dropped choices spill
    # past the table and are cut off
    dest = _spill_dest(slot, Etab * C)
    n = dest.shape[1]
    token_ids = torch.arange(S, device=x.device).repeat_interleave(k).expand(B, n)
    table = torch.full((B, Etab * C + 1 + n), S, dtype=torch.int64, device=x.device)
    table.scatter_(1, dest, token_ids)
    return gk, slot, table[:, :Etab * C + 1], gates_full


def _spill_dest(slot, n_slots):
    """Each choice's row (B, S·k) in a buffer of n_slots + 1 + S·k rows: its
    slot, or for a dropped choice (slot n_slots) a spill row of its own past
    n_slots + 1, so the indices are distinct and a scatter needs no atomics."""
    B, S, k = slot.shape
    flat = slot.reshape(B, S * k)
    spill = n_slots + 1 + torch.arange(S * k, device=slot.device)
    return torch.where(flat < n_slots, flat, spill)


def _dispatch(x, slot, n_slots):
    """Token rows into the slots: (B, n_slots, d), zero where a slot is
    empty; each choice's row scattered to ``_spill_dest``'s row."""
    B, S, d = x.shape
    dest = _spill_dest(slot, n_slots)
    n = dest.shape[1]
    rows = x[:, :, None, :].expand(B, S, n // S, d).reshape(B, n, d)
    out = torch.zeros((B, n_slots + 1 + n, d), dtype=x.dtype, device=x.device)
    out.scatter_(1, dest[..., None].expand(B, n, d), rows)
    return out[:, :n_slots]


def _expert_ffn(w_gate, w_up, w_down, xin):
    """xin (B, E, C, d) -> (B, E, C, d); SwiGLU per expert."""
    h = F.silu(torch.einsum("becd,edf->becf", xin, w_gate)) \
        * torch.einsum("becd,edf->becf", xin, w_up)
    return torch.einsum("becf,efd->becd", h, w_down)


def _combine(h, valid, slot, gk, n_slots):
    """Each token's k expert rows of h (B, E·C, d), weighted by ``gk`` and
    summed in rank order; a dropped choice (slot ``n_slots`` = Ep·C) reads
    a zero row."""
    B, S, k = slot.shape
    d = h.shape[-1]
    zero = torch.zeros((), dtype=h.dtype, device=h.device)
    rest = n_slots + 1 - h.shape[1]              # the padded experts' and the drop row
    hz = torch.cat([torch.where(valid[..., None], h, zero),
                    torch.zeros((B, rest, d), dtype=h.dtype, device=h.device)], dim=1)
    rows = torch.gather(hz, 1, slot.reshape(B, S * k, 1).expand(B, S * k, d))
    weighted = rows.view(B, S, k, d) * gk[..., None].to(h.dtype)
    out = weighted[:, :, 0].float()
    for j in range(1, k):
        out = out + weighted[:, :, j]
    return out


def _first(t, n: int, dim: int = 0):
    """The first ``n`` entries of ``t`` along ``dim`` (the real experts'),
    ``t`` itself where it holds no more: no op on an unpadded config."""
    return t if t.shape[dim] == n else t.narrow(dim, 0, n)


def _moe_core(cfg, p, x, capacity):
    """The MoE math for the E real experts (the padded ones' slots are
    empty and skipped); x (B, S, d) full sequence."""
    B, S, d = x.shape
    E, C = cfg.n_experts, capacity
    n_slots = cfg.experts_p * C
    gk, slot, slot_token, _ = _route(cfg, x, p["router"], C)
    xin = _first(_dispatch(x, slot, n_slots), E * C, dim=1)
    valid = slot_token[:, :E * C] < S
    h = _expert_ffn(*(_first(p[w], E) for w in ("w_gate", "w_up", "w_down")),
                    xin.view(B, E, C, d))
    return _combine(h.reshape(B, E * C, d), valid, slot, gk, n_slots)


def apply_moe_local(p, cfg, x, capacity=None):
    """The one-device path (the reference's CPU test path and the oracle
    for its sharded one)."""
    C = capacity or moe_capacity(cfg, x.shape[1])
    return _moe_core(cfg, p, x, C).to(x.dtype)


apply_moe = apply_moe_local    # one device (see the module docstring)


def apply_moe_ref(p, cfg, x):
    """Dropless dense reference: every expert on every token, gate-masked.
    O(T·E·d·f) — tiny test sizes only.  Capacity-dropping in the real path
    means outputs match only when capacity is not exceeded."""
    E, k = cfg.n_experts, cfg.experts_per_token
    gates_full = torch.softmax(x.float() @ p["router"], dim=-1)
    gk, ik = torch.topk(gates_full, k, dim=-1)
    gk = gk / gk.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for e in range(E):
        h = F.silu(x @ p["w_gate"][e]) * (x @ p["w_up"][e])
        ye = (h @ p["w_down"][e]).float()
        gate_e = torch.where(ik == e, gk, torch.zeros_like(gk)).sum(dim=-1)    # (B, S)
        out = out + ye * gate_e[..., None]
    return out.to(x.dtype)
