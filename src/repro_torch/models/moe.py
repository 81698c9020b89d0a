"""Mixture-of-Experts layer: top-k routing + capacity-bounded dispatch.

Ports ``repro.models.moe``.  Dispatch is index-based, as
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

Expert parallelism (``apply_moe`` under sharding rules with a mesh, the
reference's ``shard_map`` region) runs on local shards
(``distributed.sharding.local_region``): the expert weights at the
reference's ``P("model", "data", None)``, all-gathered over ``data`` into
the region (FSDP weight gathering); the router replicated.  Rank m of the
``model`` axis holds experts [m·E_loc, (m + 1)·E_loc), E_loc = Ep / |model|.

* Gather / reduce-scatter (``default``, ``fsdp_ep``, ``moe_noseq``): the
  stream enters the region whole over ``model`` (all-gathered where it
  was sequence-sharded), every rank routes the whole sequence (the same
  bits on each), runs its own experts (``_moe_core_padded``) and returns
  its partial sum in float32 as a ``Partial`` DTensor; the partials are
  reduce-scattered back to the stream's sequence shards, or summed over
  ``model`` where the stream is not sequence-sharded.  Under ``fsdp``,
  whose batch shards over ``model`` too, the batch is gathered into the
  region and scattered back the same way (the reference's ``shard_map``
  refuses that layout).
* All-to-all (``moe_a2a``, the stream sequence-sharded): each rank routes
  its own slice with capacity per source shard, C_loc = max(4,
  ceil(S_loc·k·cf / E)), packs its rows by destination, exchanges them
  (``_moe_a2a``), runs its experts on every source's rows (padding
  experts on zero rows, as in the reference) and exchanges the outputs
  back.  Drops then differ from the one-device path's, as in the
  reference.

Every collective is differentiable: the region's inputs take ``Partial``
gradients on the mesh dims their work is split over (the router's over
``model`` and ``data``, the stream's over ``model`` in the gather path),
and the all-to-all's backward is the reverse all-to-all.  With no rules,
no mesh, or a ``model`` axis of one device, ``apply_moe`` is
``apply_moe_local`` (on the local batch shard under a mesh).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import Partial, Replicate, Shard

from repro_torch.distributed.sharding import (axis_sizes, constrain, current_rules,
                                              local_region)
from repro_torch.models.layers import dense_init, param_dict

__all__ = ["moe_init", "moe_specs", "apply_moe", "apply_moe_local", "apply_moe_ref",
           "moe_capacity", "a2a_capacity", "stacked_exchange", "group_exchange"]


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


def _moe_core_padded(cfg, p_loc, x, capacity, e_lo, e_n, total_e):
    """The MoE math of experts [e_lo, e_lo + e_n) with their weights
    ``p_loc`` (e_n rows each; the router whole), x (B, S, d) the full
    sequence: each token's weighted rows from these experts, summed in rank
    order in float32 (a choice of another shard's expert reads a zero
    row).  Experts at or past ``total_e`` (mesh padding) hold no slot and
    run no FFN."""
    B, S, d = x.shape
    C = capacity
    n_real = max(0, min(e_n, total_e - e_lo))
    gk, slot, slot_token, _ = _route(cfg, x, p_loc["router"], C)
    lo, n_slots = e_lo * C, e_n * C
    local = torch.where((slot >= lo) & (slot < lo + n_slots), slot - lo, n_slots)
    xin = _first(_dispatch(x, local, n_slots), n_real * C, dim=1)
    valid = slot_token[:, lo:lo + n_real * C] < S
    h = _expert_ffn(*(_first(p_loc[w], n_real) for w in ("w_gate", "w_up", "w_down")),
                    xin.view(B, n_real, C, d))
    return _combine(h.reshape(B, n_real * C, d), valid, local, gk, n_slots)


def apply_moe_local(p, cfg, x, capacity=None):
    """The one-device path (the reference's CPU test path and the oracle
    for its sharded one)."""
    C = capacity or moe_capacity(cfg, x.shape[1])
    return _moe_core_padded(cfg, p, x, C, 0, cfg.experts_p, cfg.n_experts).to(x.dtype)


def a2a_capacity(cfg, seq_len: int) -> int:
    """The all-to-all path's capacity per (source shard, expert) for a
    shard of ``seq_len`` tokens: max(4, ceil(S_loc·k·cf / E)), unclipped."""
    return max(4, math.ceil(seq_len * cfg.experts_per_token * cfg.capacity_factor
                            / cfg.n_experts))


def stacked_exchange(t):
    """The all-to-all over shards held in one process: ``t`` (n, n, ...)
    with t[r, j] the rows shard r sends shard j; returns u with u[r, j]
    the rows shard j sent shard r."""
    return t.transpose(0, 1)


def group_exchange(group):
    """The all-to-all over the ranks of ``group`` (each holding one shard):
    maps (1, n, ...) to (1, n, ...) as ``stacked_exchange`` maps its
    shards, differentiable (its backward is the reverse all-to-all)."""
    from torch.distributed._functional_collectives import all_to_all_single_autograd

    def exchange(t):
        out = all_to_all_single_autograd(t[0].contiguous(), None, None, group)
        return out.unsqueeze(0)

    return exchange


def _moe_a2a(cfg, p_loc, x_loc, n_model, e_per, exchange=stacked_exchange):
    """All-to-all token dispatch (the reference's ``_moe_a2a``).

    ``x_loc`` (R, B, S_loc, d) holds the R sequence shards this process
    owns (R = 1 on a rank of a group, R = n_model for ``stacked_exchange``)
    and ``p_loc`` their experts, R·e_per rows each (the router whole).
    Each shard routes its own slice at capacity ``a2a_capacity(S_loc)``,
    packs its rows into per-destination buffers of e_per·C_loc rows an
    expert shard, ``exchange`` sends each shard its experts' rows from
    every source, the experts run on them, and the outputs go back by the
    same exchange; each token then sums its k weighted rows in rank order
    (float32).  Returns (R, B, S_loc, d) float32."""
    R, B, S_loc, d = x_loc.shape
    C = a2a_capacity(cfg, S_loc)
    n_slots = n_model * e_per * C
    if n_slots != cfg.experts_p * C:
        raise ValueError(f"{n_model} shards x {e_per} experts is not the {cfg.experts_p} "
                         f"experts of {cfg.name}")
    x = x_loc.reshape(R * B, S_loc, d)
    gk, slot, slot_token, _ = _route(cfg, x, p_loc["router"], C)
    rows = _dispatch(x, slot, n_slots)                               # (R·B, Ep·C, d)
    send = rows.view(R, B, n_model, e_per * C, d).transpose(1, 2)   # (R, dst, B, e·C, d)
    recv = exchange(send).reshape(R, n_model, B, e_per, C, d)       # (R, src, B, e, C, d)
    xin = recv.permute(2, 0, 3, 1, 4, 5).reshape(B, R * e_per, n_model * C, d)
    h = _expert_ffn(p_loc["w_gate"], p_loc["w_up"], p_loc["w_down"], xin)
    back = h.reshape(B, R, e_per, n_model, C, d).permute(1, 3, 0, 2, 4, 5)
    got = exchange(back.reshape(R, n_model, B, e_per * C, d))       # (R, expert shard, ...)
    got = got.transpose(1, 2).reshape(R * B, n_slots, d)
    out = _combine(got, slot_token[:, :n_slots] < S_loc, slot, gk, n_slots)
    return out.view(R, B, S_loc, d)


_STREAM = ("batch", "act_seq", None)
_WEIGHTS = {"router": (None, None), "w_gate": ("experts", None, None),
            "w_up": ("experts", None, None), "w_down": ("experts", None, None)}


def _split(local):
    """A region's local arguments -> (the layer's weights by name, x)."""
    return dict(zip(_WEIGHTS, local[:-1])), local[-1]


def apply_moe(p, cfg, x):
    """The MoE layer: ``apply_moe_local`` with no sharding rules (or no
    mesh), else expert parallelism over the ``model`` axis on local shards
    (module docstring): the all-to-all dispatch where the rules say
    ``moe_dispatch: a2a`` and the stream is sequence-sharded, else gather /
    reduce-scatter (or sum over ``model``).  Returns x's dtype at the
    stream's placements."""
    rules = current_rules()
    mesh = None if rules is None else rules.mesh
    if mesh is None:
        return apply_moe_local(p, cfg, x)
    n_model = axis_sizes(mesh).get("model", 1)
    x = constrain(x, _STREAM)
    args = tuple(p[w] for w in _WEIGHTS) + (x,)
    in_axes = tuple(_WEIGHTS.values()) + (_STREAM,)
    if n_model == 1:
        def local(*a):
            p_loc, xl = _split(a)
            return apply_moe_local(p_loc, cfg, xl)

        return local_region(local, args, in_axes, _STREAM)
    if cfg.experts_p % n_model:
        raise ValueError(f"{cfg.name}: {cfg.experts_p} experts do not divide over a model "
                         f"axis of {n_model}: pad the config (configs.base.pad_for_mesh)")
    e_per = cfg.experts_p // n_model
    m = mesh.mesh_dim_names.index("model")
    if rules.table.get("moe_dispatch") == "a2a" and x.placements[m] == Shard(1):
        exchange = group_exchange(mesh.get_group("model"))

        def a2a(*a):
            p_loc, xl = _split(a)
            return _moe_a2a(cfg, p_loc, xl[None], n_model, e_per, exchange)[0].to(xl.dtype)

        return local_region(a2a, args, in_axes, _STREAM)
    whole = tuple(Replicate() if i == m else pl for i, pl in enumerate(x.placements))
    partial = tuple(Partial() if i == m else pl for i, pl in enumerate(x.placements))
    e_lo = mesh.get_local_rank("model") * e_per
    C = moe_capacity(cfg, x.shape[1])

    def gather(*a):
        p_loc, xl = _split(a)
        return _moe_core_padded(cfg, p_loc, xl, C, e_lo, e_per, cfg.n_experts)

    out = local_region(gather, args, in_axes, None, out_placements=[partial],
                       in_placements=[None] * len(_WEIGHTS) + [whole])
    return out.redistribute(mesh, x.placements).to(x.dtype)


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
