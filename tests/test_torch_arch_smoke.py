"""Per-architecture smoke tests of the port, the twin of ``tests/test_arch_smoke.py``:
every config the port registers (the reference's ten), reduced, with random
weights drawn from a seed, on the CPU.  A forward pass has the right shape
and is finite; prefill + decode equal the forward pass within the
reference's 2e-2 (the K/V cache, ring cache and recurrent states are exact
paths, not approximations); greedy generation runs.  The reference's
train-step test waits for the port's training slice."""

import dataclasses

import numpy as np
import pytest
import torch

from repro.configs.base import list_configs as jax_list_configs
from repro_torch.configs.base import get_config, list_configs
from repro_torch.models import model as M

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
