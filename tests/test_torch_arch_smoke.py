"""Per-architecture smoke tests of the port, the twin of ``tests/test_arch_smoke.py``:
every config the port registers (the reference's ten), reduced, with random
weights drawn from a seed, on the CPU.  A forward pass has the right shape
and is finite; prefill + decode equal the forward pass within the
reference's 2e-2 (the K/V cache, ring cache and recurrent states are exact
paths, not approximations); greedy generation runs; and, as the reference's
train-step test, the loss of a random model sits near log V with finite
gradients, most of them nonzero, and one training step of
``training.train_loop`` runs with finite metrics."""

import dataclasses

import numpy as np
import pytest
import torch

from repro.configs.base import list_configs as jax_list_configs
from repro_torch.configs.base import get_config, list_configs
from repro_torch.models import model as M
from repro_torch.training.optimizer import OptimizerConfig, init_opt_state
from repro_torch.training.train_loop import make_train_step

ARCHS = list_configs()
B, S = 2, 32


def _setup(arch):
    cfg = get_config(arch, reduced=True)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)))
    embeds = None
    if cfg.frontend is not None:
        embeds = torch.from_numpy(0.02 * rng.standard_normal(
            (B, cfg.n_prefix, cfg.d_model), dtype=np.float32))
    return cfg, params, tokens, embeds


def test_list_configs_is_the_references():
    assert ARCHS == jax_list_configs()
    assert len(ARCHS) == 10


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_shapes_and_finiteness(arch):
    cfg, params, tokens, embeds = _setup(arch)
    logits = M.forward(params, cfg, tokens, embeds)
    assert logits.shape == (B, S, cfg.vocab_size)
    assert logits.dtype == torch.float32
    assert torch.isfinite(logits).all(), f"{arch}: non-finite logits"


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_loss_and_grads_finite(arch):
    cfg, params, tokens, embeds = _setup(arch)
    params.requires_grad_(True)
    batch = {"tokens": tokens} if embeds is None else {"tokens": tokens, "embeds": embeds}
    loss = M.loss_fn(params, cfg, batch)
    assert torch.isfinite(loss), f"{arch}: loss {loss}"
    # a random model over V tokens should sit near log(V)
    assert 0.1 * np.log(cfg.vocab_size) < float(loss.detach()) < 3.0 * np.log(cfg.vocab_size)
    leaves = list(params.parameters())
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, torch.autograd.grad(loss, leaves, allow_unused=True))]
    assert grads, "no grads"
    for g in grads:
        assert torch.isfinite(g).all(), f"{arch}: non-finite grad"
    nonzero = sum(float(g.abs().sum()) > 0 for g in grads)
    assert nonzero > len(grads) // 2, f"{arch}: too many zero grads"
    step = make_train_step(cfg, OptimizerConfig(lr=1e-3, warmup_steps=1))
    _, state, metrics = step(params, init_opt_state(params), batch)
    assert int(state.step) == 1
    assert all(torch.isfinite(metrics[k]) for k in ("loss", "grad_norm", "lr", "param_norm"))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """Prefill of the first half (a Mamba-2 prompt of one reduced chunk),
    then 4 teacher-forced decode steps: each step's logits equal the
    forward pass's at that position."""
    cfg, params, tokens, embeds = _setup(arch)
    full = M.forward(params, cfg, tokens, embeds)
    n_prompt = S // 2
    logits, caches = M.prefill(params, cfg, tokens[:, :n_prompt], S, embeds)
    torch.testing.assert_close(logits, full[:, n_prompt - 1], rtol=2e-2, atol=2e-2)
    for i in range(n_prompt, n_prompt + 4):
        logits, caches = M.decode_step(params, cfg, tokens[:, i], caches, i)
        torch.testing.assert_close(logits, full[:, i], rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_generate_runs(arch):
    cfg, params, _, _ = _setup(arch)
    # a Mamba-2 prompt is one reduced SSD chunk or a multiple of it
    n = cfg.ssm_chunk if "ssm" in cfg.layer_kinds else 8
    prompt = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (1, n)))
    out = M.greedy_generate(params, cfg, prompt, 4)
    assert out.shape == (1, 4)
    assert bool(((out >= 0) & (out < cfg.vocab_size)).all())


@pytest.mark.parametrize("arch", ARCHS)
def test_float32_decode_matches_forward_closely(arch):
    """The same in float32, where the paths differ only in summation order."""
    cfg, _, tokens, embeds = _setup(arch)
    cfg = dataclasses.replace(cfg, dtype="float32")
    params = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    full = M.forward(params, cfg, tokens, embeds)
    logits, caches = M.prefill(params, cfg, tokens[:, :S // 2], S, embeds)
    torch.testing.assert_close(logits, full[:, S // 2 - 1], rtol=1e-4, atol=1e-4)
    for i in range(S // 2, S // 2 + 4):
        logits, caches = M.decode_step(params, cfg, tokens[:, i], caches, i)
        torch.testing.assert_close(logits, full[:, i], rtol=1e-4, atol=1e-4)
