"""End-to-end training on one torch device or a device mesh: the CLI and its loop.

Ports ``repro.launch.train``: ``SyntheticLM`` data, the step from
``launch.steps.build_train``, AdamW, periodic async checkpoints and an
automatic resume from the latest complete step, which is bit-exact (the
data is a pure function of the step).  Weights are random, drawn from
``--seed``.  On the card every attention layer runs kernel K3 forward and
its backward kernels, at every head dim the configs use (64, 128 and
RecurrentGemma-2B's 256), and every Mamba-2 layer kernel K4 forward
(keeping its span states) and its backward kernels.

``--mesh DxM`` trains on a (data, model) ``DeviceMesh`` through
``launch.steps.build_cell`` (the ``default`` policy, the config padded
for M): a world of one in this process when D·M is 1,
otherwise the world that ``torchrun``'s environment names, which must
have D·M ranks.  Weights, moments and batches are drawn whole on every
rank and placed (``launch.steps.place``); checkpoints hold full tensors,
the same files as one device's.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b --reduced \\
        --device cpu --steps 20 --batch 8 --seq 64 --ckpt-dir /tmp/ckpt
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b --steps 30 \\
        --batch 8 --seq 1024 --microbatches 2      # full width, on the card
    PYTHONPATH=src python -m repro_torch.launch.train --arch recurrentgemma-2b \\
        --steps 8 --batch 4 --seq 1024 --microbatches 2   # Dh 256, on the card
    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m --steps 30 \\
        --batch 8 --seq 1024 --microbatches 2      # K4 and its backward, on the card
    PYTHONPATH=src torchrun --nproc-per-node 8 -m repro_torch.launch.train \\
        --arch qwen2-0.5b --reduced --device cpu --mesh 2x4 --steps 5   # gloo ranks
"""

from __future__ import annotations

import argparse
import os
import time
from dataclasses import dataclass, field

import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.configs.base import ShapeSpec, get_config, pad_for_mesh
from repro_torch.distributed.sharding import axis_sizes
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch.mesh import backend_for, init_world_of_one, make_test_mesh
from repro_torch.launch.steps import build_cell, build_train, place
from repro_torch.models import model as M
from repro_torch.training.checkpoint import CheckpointManager, latest_step
from repro_torch.training.optimizer import OptimizerConfig, init_opt_state
from repro_torch.training.train_loop import batch_to

__all__ = ["TrainResult", "train", "main"]


@dataclass
class TrainResult:
    """What a training run did: the loss and the gradient norm (before
    clipping) of every step it ran (steps ``start`` .. ``steps`` - 1), each
    step's wall seconds (to the loss's read, which waits for the device),
    the tokens a second over the run,
    the device's peak allocated bytes (None on the CPU), and the final
    parameters and optimizer state."""

    start: int
    steps: int
    losses: list[float] = field(default_factory=list)
    grad_norms: list[float] = field(default_factory=list)
    step_s: list[float] = field(default_factory=list)
    tokens_per_s: float = 0.0
    peak_bytes: int | None = None
    params: object = None
    opt_state: object = None


def train(cfg, *, steps: int, batch: int, seq: int, lr: float = 3e-3,
          microbatches: int = 1, ckpt_dir: str | None = None, ckpt_every: int = 50,
          log_every: int = 10, seed: int = 0, device="cuda", mesh=None,
          log=print) -> TrainResult:
    """Train ``cfg`` from random weights (seed ``seed``) or from the latest
    checkpoint under ``ckpt_dir`` up to ``steps`` steps of ``batch`` x
    ``seq`` tokens; checkpoints every ``ckpt_every`` steps and at the end.
    With a ``DeviceMesh`` ``mesh`` the step is ``build_cell``'s (``cfg``
    padded for the mesh's model axis)."""
    dev = resolve_device(device)
    opt_cfg = OptimizerConfig(lr=lr, warmup_steps=min(20, steps // 10 + 1), decay_steps=steps)
    data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch, seed=seed,
                       n_prefix=cfg.n_prefix if cfg.frontend else 0,
                       d_model=cfg.d_model if cfg.frontend else 0)
    shape = ShapeSpec("cli", seq, batch, "train")
    if mesh is None:
        step_fn, _ = build_train(cfg, shape, device=dev, n_microbatches=microbatches,
                                 opt_cfg=opt_cfg)
        to_mesh = lambda tree, spec: tree  # noqa: E731
    else:
        step_fn, spec, _ = build_cell(cfg, shape, mesh, n_microbatches=microbatches,
                                      opt_cfg=opt_cfg)
        cfg = pad_for_mesh(cfg, axis_sizes(mesh).get("model", 1))
        to_mesh = lambda tree, part: place(tree, spec[part], mesh)  # noqa: E731

    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(seed), dev)
    params.requires_grad_(True)
    opt_state = to_mesh(init_opt_state(params), 1)
    params = to_mesh(params, 0)
    start = 0
    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    if mgr and latest_step(ckpt_dir) is not None:
        tree, start = mgr.restore_latest({"params": params, "opt": opt_state})
        opt_state = tree["opt"]
        log(f"resumed from step {start}")

    n_params = sum(p.numel() for p in params.parameters())
    log(f"arch={cfg.name} params={n_params / 1e6:.1f}M steps={steps} device={dev}")
    res = TrainResult(start=start, steps=steps)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    for step in range(start, steps):
        t_step = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state,
                                             to_mesh(batch_to(data.batch_at(step), dev), 2))
        res.losses.append(float(metrics["loss"]))
        res.step_s.append(time.perf_counter() - t_step)
        res.grad_norms.append(float(metrics["grad_norm"]))
        if step % log_every == 0 or step == steps - 1:
            dt = time.perf_counter() - t0
            tok_s = (step - start + 1) * batch * seq / max(dt, 1e-9)
            log(f"step {step:5d} loss {res.losses[-1]:.4f} "
                f"gnorm {res.grad_norms[-1]:.3f} "
                f"lr {float(metrics['lr']):.2e} tok/s {tok_s:,.0f}")
        if mgr and (step + 1) % ckpt_every == 0:
            mgr.save(step + 1, {"params": params, "opt": opt_state})
    res.tokens_per_s = (steps - start) * batch * seq / max(time.perf_counter() - t0, 1e-9)
    if dev.type == "cuda":
        res.peak_bytes = torch.cuda.max_memory_allocated(dev)
    if mgr:
        mgr.save(steps, {"params": params, "opt": opt_state})
        mgr.wait()
    if res.losses:
        log(f"final loss {res.losses[-1]:.4f} (first {res.losses[0]:.4f})")
    res.params, res.opt_state = params, opt_state
    return res


def main(argv=None) -> TrainResult:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mesh", default=None,
                    help="a (data, model) device mesh such as '2x4': a world of one in "
                         "this process for '1x1', else torchrun's world of D*M ranks")
    args = ap.parse_args(argv)
    cfg = get_config(args.arch, reduced=args.reduced)
    mesh = None if args.mesh is None else _mesh_from_arg(args.mesh, args.device)
    return train(cfg, steps=args.steps, batch=args.batch, seq=args.seq, lr=args.lr,
                 microbatches=args.microbatches, ckpt_dir=args.ckpt_dir,
                 ckpt_every=args.ckpt_every, log_every=args.log_every, seed=args.seed,
                 device=args.device, mesh=mesh)


def _mesh_from_arg(arg: str, device="cuda"):
    """The (data, model) mesh of ``--mesh DxM`` on ``device``'s type: a
    world of one in this process when D·M is 1, else the process group of
    ``torchrun``'s environment (``env://``), which must have D·M ranks."""
    try:
        shape = tuple(int(n) for n in arg.lower().split("x"))
    except ValueError:
        shape = ()
    if len(shape) != 2 or min(shape) < 1:
        raise ValueError(f"--mesh {arg!r}: expected DxM, such as 2x4")
    kind = resolve_device(device).type
    if shape[0] * shape[1] == 1:
        init_world_of_one(kind)
    elif not dist.is_initialized():
        if "WORLD_SIZE" not in os.environ:
            raise ValueError(f"--mesh {arg} needs {shape[0] * shape[1]} ranks: run under "
                             f"torchrun --nproc-per-node {shape[0] * shape[1]}")
        dist.init_process_group(backend_for(kind), init_method="env://")
    if dist.get_world_size() != shape[0] * shape[1]:
        raise ValueError(f"--mesh {arg} needs {shape[0] * shape[1]} ranks; the world has "
                         f"{dist.get_world_size()}")
    if kind == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    return make_test_mesh(shape, device_type=kind)


if __name__ == "__main__":
    main()
