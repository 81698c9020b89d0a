"""AdamW with global-norm clipping, on tensors.

Ports ``repro.training.optimizer``.  The moments are float32
whatever the parameter dtype (bf16 parameters + f32 moments), the
reference's leaves with ``ndim >= 2`` decay (below), and the arithmetic is
the reference's, in float32, in its order.  The state and the gradients are dicts keyed by the
parameters' ``named_parameters()`` names.

Which parameters decay: the reference decays a leaf of its own tree with
``ndim >= 2``, and it stacks the layers of its scanned groups along a
leading axis, so there every parameter of a group layer decays, its norm
scales and biases too, while the tail's layers and the top level decay by
their own rank.  ``decay_names`` computes that set from the config and
``adamw_step`` takes it as ``decay``, so both packages take the same step.

Unlike the reference's pure update, ``adamw_step`` writes the new
parameters and moments IN PLACE (under ``torch.no_grad``): a full-width
model then holds one copy of each.  It returns the parameters, the new
state and the reference's metrics.

Under a mesh (``launch.steps.build_train``) the parameters and moments are
DTensors, the moments at their ZeRO placements (``sharding.zero_specs``).
``adamw_step`` then redistributes each f32 gradient to its moment's
placements, updates there, and redistributes the new parameter back to
the parameter's own: the ZeRO update that GSPMD inserts in the reference,
with every layout fixed rather than left to DTensor.  ``global_norm`` sums
each DTensor's square over the mesh into one plain scalar, the same on
every rank.  On plain tensors every step is as on one device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.distributed.sharding import like

__all__ = ["OptimizerConfig", "OptState", "init_opt_state", "adamw_step",
           "decay_names", "global_norm", "lr_schedule"]


@dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1


class OptState(NamedTuple):
    step: torch.Tensor          # () int32, on the parameters' device
    mu: dict                    # name -> f32 first moment
    nu: dict                    # name -> f32 second moment


def init_opt_state(params) -> OptState:
    """Zero f32 moments beside every parameter of the module ``params``, on
    its device (``meta`` included)."""
    named = dict(params.named_parameters())
    device = next(iter(named.values())).device
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
    return OptState(step=torch.zeros((), dtype=torch.int32, device=device),
                    mu={n: zeros(p) for n, p in named.items()},
                    nu={n: zeros(p) for n, p in named.items()})


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every tensor of an iterable, in f32; a
    DTensor's square is summed over the mesh first (a replicated scalar)."""
    total = None
    for g in tensors:
        sq = torch.sum(torch.square(g.float()))
        if isinstance(sq, DTensor):
            sq = sq.full_tensor()
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def lr_schedule(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``cfg.lr``, then cosine decay to ``min_lr_ratio``
    of it, in float32 as the reference computes it."""
    step = step.float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps) / max(cfg.decay_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def decay_names(cfg, params) -> set[str]:
    """The parameters that the reference's AdamW decays: its leaves with
    ``ndim >= 2``, where every parameter of a layer in its stacked groups
    (the port's layers 0 .. n_groups·len(block_pattern) - 1) has the
    group axis in front (the module's note)."""
    stacked = cfg.n_groups * len(cfg.block_pattern)
    return {n for n, p in params.named_parameters()
            if p.ndim >= 2 or (n.startswith("stack.") and int(n.split(".")[1]) < stacked)}


@torch.no_grad()
def adamw_step(params, grads: dict, state: OptState, cfg: OptimizerConfig, decay: set[str]):
    """One AdamW step on the module ``params`` from ``grads`` (name ->
    tensor, any float dtype), updating the parameters and the moments in
    place; ``decay``: the names that take weight decay (``decay_names``).
    Returns (params, new state,
    metrics) with the reference's metrics: ``grad_norm`` (before clipping),
    ``lr`` and ``param_norm`` (after the step), as 0-d f32 tensors."""
    named = dict(params.named_parameters())
    gnorm = global_norm(grads[n] for n in named)
    clip = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)
    step = state.step + 1
    lr = lr_schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1.0 - torch.pow(b1, step.float())
    bc2 = 1.0 - torch.pow(b2, step.float())
    for name, p in named.items():
        m, n = state.mu[name], state.nu[name]
        g32 = like(grads[name].float(), m) * clip         # at the moment's placements
        m.copy_(b1 * m + (1 - b1) * g32)
        n.copy_(b2 * n + (1 - b2) * g32 * g32)
        delta = (m / bc1) / (torch.sqrt(n / bc2) + cfg.eps)
        p32 = like(p.float(), m)
        if name in decay:
            delta = delta + cfg.weight_decay * p32
        p.copy_(like((p32 - lr * delta).to(p.dtype), p))  # back to the parameter's
    metrics = {"grad_norm": gnorm, "lr": lr, "param_norm": global_norm(named.values())}
    return params, OptState(step=step, mu=state.mu, nu=state.nu), metrics
