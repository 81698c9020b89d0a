"""End-to-end training on one torch device: the CLI and its loop.

Ports ``repro.launch.train``: ``SyntheticLM`` data, the step from
``launch.steps.build_train``, AdamW, periodic async checkpoints and an
automatic resume from the latest complete step, which is bit-exact (the
data is a pure function of the step).  Weights are random, drawn from
``--seed``.  On the card every attention layer runs kernel K3 forward and
its backward kernel.  A config whose training the card cannot run yet
raises ``NotImplementedError`` from the kernel's wrapper in the first
step's forward, before any update: a Mamba-2 layer (K4 has no backward
yet) or a head dim above the K3 backward's 128 (RecurrentGemma-2B's 256),
both in ROADMAP queue 2.  ``--mesh`` is refused: the multi-device slice is
ROADMAP queue 1, item 9.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b --reduced \\
        --device cpu --steps 20 --batch 8 --seq 64 --ckpt-dir /tmp/ckpt
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b --steps 30 \\
        --batch 8 --seq 1024 --microbatches 2      # full width, on the card
"""

from __future__ import annotations

import argparse
import time
from dataclasses import dataclass, field

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ShapeSpec, get_config
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch.steps import build_train
from repro_torch.models import model as M
from repro_torch.training.checkpoint import CheckpointManager, latest_step
from repro_torch.training.optimizer import OptimizerConfig, init_opt_state
from repro_torch.training.train_loop import batch_to

__all__ = ["TrainResult", "train", "main"]


@dataclass
class TrainResult:
    """What a training run did: the loss of every step it ran (steps
    ``start`` .. ``steps`` - 1), each step's wall seconds (to the loss's
    read, which waits for the device), the tokens a second over the run,
    the device's peak allocated bytes (None on the CPU), and the final
    parameters and optimizer state."""

    start: int
    steps: int
    losses: list[float] = field(default_factory=list)
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
    ``seq`` tokens; checkpoints every ``ckpt_every`` steps and at the end."""
    dev = resolve_device(device)
    opt_cfg = OptimizerConfig(lr=lr, warmup_steps=min(20, steps // 10 + 1), decay_steps=steps)
    data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch, seed=seed,
                       n_prefix=cfg.n_prefix if cfg.frontend else 0,
                       d_model=cfg.d_model if cfg.frontend else 0)
    step_fn, _ = build_train(cfg, ShapeSpec("cli", seq, batch, "train"), mesh, device=dev,
                             n_microbatches=microbatches, opt_cfg=opt_cfg)

    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(seed), dev)
    params.requires_grad_(True)
    opt_state = init_opt_state(params)
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
        params, opt_state, metrics = step_fn(params, opt_state, batch_to(data.batch_at(step), dev))
        res.losses.append(float(metrics["loss"]))
        res.step_s.append(time.perf_counter() - t_step)
        if step % log_every == 0 or step == steps - 1:
            dt = time.perf_counter() - t0
            tok_s = (step - start + 1) * batch * seq / max(dt, 1e-9)
            log(f"step {step:5d} loss {res.losses[-1]:.4f} "
                f"gnorm {float(metrics['grad_norm']):.3f} "
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
                    help="a (data, model) device mesh such as '2x4': refused, one device only")
    args = ap.parse_args(argv)
    cfg = get_config(args.arch, reduced=args.reduced)
    return train(cfg, steps=args.steps, batch=args.batch, seq=args.seq, lr=args.lr,
                 microbatches=args.microbatches, ckpt_dir=args.ckpt_dir,
                 ckpt_every=args.ckpt_every, log_every=args.log_every, seed=args.seed,
                 device=args.device, mesh=args.mesh)


if __name__ == "__main__":
    main()
