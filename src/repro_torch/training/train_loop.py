"""Training step factory: loss + grad + AdamW, with gradient accumulation.

Ports ``repro.training.train_loop``.  ``make_train_step(cfg, opt_cfg,
n_microbatches)`` returns ``train_step(params, opt_state, batch) ->
(params, opt_state, metrics)``: the gradient of ``models.model.loss_fn`` by
``torch.autograd.grad`` (so nothing accumulates in ``.grad``), then
``adamw_step``, which updates the parameters and moments in place.  With
``n_microbatches > 1`` the batch is split on its leading axis and the f32
gradients are summed over the microbatches, then divided once, as the
reference's ``lax.scan`` does; activation memory then scales with the
microbatch.  The sums are accumulated and divided in place and each
microbatch's gradients are freed as they are summed, so the step holds one
f32 copy of the gradients.  Under a mesh (``launch.steps.build_train``)
each rank splits its own batch shard into the microbatches (data-parallel
accumulation: on a world of one, the one-device split), and the f32 sums
live at the parameters' placements.  ``models.transformer`` rematerialises the layer
groups under ``cfg.remat``.  A parameter that the loss does not reach gets
a zero gradient, as ``jax.grad`` gives it.

The parameters must require grad: ``params.requires_grad_(True)`` (they are
frozen at creation, for serving).  On the card every attention layer runs
kernel K3 forward and backward, and every Mamba-2 layer kernel K4 forward
and backward.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch.models import model as M
from repro_torch.training.optimizer import OptimizerConfig, adamw_step, decay_names

__all__ = ["make_train_step", "make_eval_step", "batch_to"]


def batch_to(batch: dict, device) -> dict:
    """A batch of numpy arrays (``data.pipeline``'s) as tensors on ``device``."""
    return {k: torch.from_numpy(np.asarray(v)).to(device) for k, v in batch.items()}


def _split(t, n_micro: int) -> list:
    """``t`` cut into ``n_micro`` parts on its leading axis; a DTensor's own
    shard is cut, each part keeping its placements."""
    local = t.to_local() if isinstance(t, DTensor) else t
    b = local.shape[0]
    if b % n_micro:
        raise ValueError(f"batch {b} not divisible by {n_micro} microbatches")
    size = b // n_micro
    parts = [local[i * size:(i + 1) * size] for i in range(n_micro)]
    if isinstance(t, DTensor):
        parts = [DTensor.from_local(p, t.device_mesh, t.placements, run_check=False)
                 for p in parts]
    return parts


def _split_batch(batch: dict, n_micro: int) -> list[dict]:
    split = {k: _split(v, n_micro) for k, v in batch.items()}
    return [{k: v[i] for k, v in split.items()} for i in range(n_micro)]


def _value_and_grad(params, cfg, batch, named):
    loss = M.loss_fn(params, cfg, batch)
    grads = torch.autograd.grad(loss, list(named.values()), allow_unused=True)
    return loss.detach(), {n: torch.zeros_like(p) if g is None else g
                           for (n, p), g in zip(named.items(), grads)}


def make_train_step(cfg, opt_cfg: OptimizerConfig, n_microbatches: int = 1):
    def train_step(params, opt_state, batch):
        named = dict(params.named_parameters())
        if not all(p.requires_grad for p in named.values()):
            raise ValueError("the parameters are frozen: call params.requires_grad_(True) "
                             "before training")
        if n_microbatches == 1:
            loss, grads = _value_and_grad(params, cfg, batch, named)
        else:
            loss = torch.zeros((), dtype=torch.float32, device=batch["tokens"].device)
            grads = {n: torch.zeros_like(p, dtype=torch.float32) for n, p in named.items()}
            for mb in _split_batch(batch, n_microbatches):
                l, g = _value_and_grad(params, cfg, mb, named)
                loss = loss + l
                for n in grads:
                    grads[n] += g.pop(n)        # each microbatch gradient freed once summed
            loss = loss / n_microbatches
            for g in grads.values():
                g.div_(n_microbatches)          # in place: no second f32 copy
        params, opt_state, metrics = adamw_step(params, grads, opt_state, opt_cfg,
                                                decay_names(cfg, params))
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step


def make_eval_step(cfg):
    @torch.no_grad()
    def eval_step(params, batch):
        return M.loss_fn(params, cfg, batch)

    return eval_step
