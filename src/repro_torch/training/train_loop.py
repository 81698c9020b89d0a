"""Training step factory: loss + grad + AdamW, with gradient accumulation.

Ports ``repro.training.train_loop``.  ``make_train_step(cfg, opt_cfg,
n_microbatches)`` returns ``train_step(params, opt_state, batch) ->
(params, opt_state, metrics)``: the gradient of ``models.model.loss_fn``
by ``torch.autograd.grad`` (so nothing accumulates in ``.grad``), then
``adamw_step``, which updates the parameters and moments in place.  With
``n_microbatches > 1`` the batch is split on its leading axis and the f32
gradients are summed over the microbatches, then divided once, as the
reference's ``lax.scan`` does; activation memory then scales with the
microbatch.  A parameter that the loss does not reach gets a zero gradient,
as ``jax.grad`` gives it.

The parameters must require grad: ``params.requires_grad_(True)`` (they are
frozen at creation, for serving).  On the card every attention layer runs
kernel K3 forward and backward; a Mamba-2 layer's kernel K4 has no backward
yet and raises (ROADMAP queue 2).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import model as M
from repro_torch.training.optimizer import OptimizerConfig, adamw_step, decay_names

__all__ = ["make_train_step", "make_eval_step", "batch_to"]


def batch_to(batch: dict, device) -> dict:
    """A batch of numpy arrays (``data.pipeline``'s) as tensors on ``device``."""
    return {k: torch.from_numpy(np.asarray(v)).to(device) for k, v in batch.items()}


def _split_batch(batch: dict, n_micro: int) -> list[dict]:
    b = batch["tokens"].shape[0]
    if b % n_micro:
        raise ValueError(f"batch {b} not divisible by {n_micro} microbatches")
    size = b // n_micro
    return [{k: v[i * size:(i + 1) * size] for k, v in batch.items()} for i in range(n_micro)]


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
            grads = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                     for n, p in named.items()}
            for mb in _split_batch(batch, n_microbatches):
                l, g = _value_and_grad(params, cfg, mb, named)
                loss = loss + l
                for n in grads:
                    grads[n] += g[n]
                del g
            loss = loss / n_microbatches
            grads = {n: g / n_microbatches for n, g in grads.items()}
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
