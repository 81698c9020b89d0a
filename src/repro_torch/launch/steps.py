"""Step-function assembly for the launchers, on one device.

Ports the one-device form of ``repro.launch.steps.build_train``: the
training step for an (arch config, shape) cell, with the abstract shapes of
its inputs computed on PyTorch's ``meta`` device (shapes and dtypes, no
allocation, no weights drawn) in place of the reference's
``ShapeDtypeStruct``s.  The mesh form (shardings, ZeRO moments, batch
replication), ``build_prefill``, ``build_decode`` and ``build_cell`` come
with the multi-device slice (ROADMAP queue 1, item 9).
"""

from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.models import model as M
from repro_torch.training.optimizer import OptimizerConfig, init_opt_state
from repro_torch.training.train_loop import make_train_step

__all__ = ["build_train"]


def _abstract_batch(cfg, global_batch: int, seq_len: int) -> dict:
    """The batch's tensors on the meta device: tokens (B, S) int32 and, for
    a config with a frontend, embeds (B, n_prefix, d) float32."""
    meta = torch.device("meta")
    batch = {"tokens": torch.empty((global_batch, seq_len), dtype=torch.int32, device=meta)}
    if cfg.frontend is not None:
        batch["embeds"] = torch.empty((global_batch, cfg.n_prefix, cfg.d_model),
                                      dtype=torch.float32, device=meta)
    return batch


def build_train(cfg, shape, mesh=None, *, device="cuda", n_microbatches: int = 1,
                opt_cfg: OptimizerConfig | None = None):
    """(train_step, (params, opt_state, batch) on the meta device) for one
    device: ``shape`` has ``global_batch`` and ``seq_len`` (a
    ``configs.base.ShapeSpec``).  ``train_step`` runs on ``device``'s tensors
    (resolved here, so a missing card raises now).  A mesh raises
    ``NotImplementedError``."""
    if mesh is not None:
        raise NotImplementedError("build_train on a device mesh comes with the "
                                  "multi-device slice (ROADMAP queue 1, item 9)")
    resolve_device(device)
    if shape.global_batch % n_microbatches:
        raise ValueError(f"batch {shape.global_batch} not divisible by {n_microbatches} "
                         f"microbatches")
    params = M.init_params(cfg, torch.Generator(), device="meta")
    step_fn = make_train_step(cfg, opt_cfg or OptimizerConfig(), n_microbatches)
    return step_fn, (params, init_opt_state(params),
                     _abstract_batch(cfg, shape.global_batch, shape.seq_len))
