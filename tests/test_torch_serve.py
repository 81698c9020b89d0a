"""The port's serving path end to end on the CPU: requests -> Broker ->
ThreadedStreamingEngine -> ``torch://`` pilot -> greedy generation, with
every reduced config the port has in float32 (the frontend configs take
no ``embeds`` here: the serving path passes none, as the reference's).  Micro-batching
must not change what a request gets: each request's tokens equal
``greedy_generate`` on its own prompt (float32, so batched and single-row
sums cannot flip an argmax)."""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.base import reduced
from repro_torch.launch import serve as S
from repro_torch.models import model as M

N_REQ, PROMPT, NEW = 6, 20, 5


def _setup(arch, prompt_len):
    cfg = dataclasses.replace(reduced(arch), dtype="float32")
    params = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (N_REQ, prompt_len))
    return cfg, params, prompts


@pytest.fixture(scope="module")
def setup():
    return _setup("qwen2-0.5b", PROMPT)


def _check_served(cfg, params, prompts):
    res = S.serve(cfg, params, prompts, new_tokens=NEW, partitions=2, batch_max=2,
                  device="cpu", timeout=120)
    assert (res.processed, res.abandoned, res.failed_batches) == (N_REQ, 0, 0)
    assert len(res.lpx_s) == N_REQ
    assert sum(n for n, _, _ in res.batches) == N_REQ
    assert all(1 <= n <= 2 for n, _, _ in res.batches)
    assert res.tokens.shape == (N_REQ, NEW)
    for i in range(N_REQ):
        alone = M.greedy_generate(params, cfg, torch.from_numpy(prompts[i:i + 1]), NEW)
        np.testing.assert_array_equal(res.tokens[i], alone[0].numpy())


def test_serve_answers_every_request_as_greedy_generate(setup):
    _check_served(*setup)


def test_serve_mamba_answers_every_request_as_greedy_generate():
    """The SSM family through the same path; a prompt of two reduced chunks."""
    cfg, params, prompts = _setup("mamba2-130m", 32)
    assert cfg.layer_kinds == ("ssm",) * cfg.n_layers
    _check_served(cfg, params, prompts)


@pytest.mark.parametrize("arch", ["glm4-9b", "qwen2.5-3b", "qwen2.5-14b", "internvl2-1b",
                                  "musicgen-medium"])
def test_serve_dense_and_frontend_archs_answer_as_greedy_generate(arch):
    _check_served(*_setup(arch, PROMPT))


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "granite-moe-3b-a800m",
                                  "qwen3-moe-235b-a22b"])
def test_serve_hybrid_and_moe_archs_answer_as_greedy_generate(arch):
    """RecurrentGemma's 20-token prompts outrun its reduced window (16), so
    each micro-batch's prefill rolls the ring and decode wraps it; the MoE
    configs route a batch of two prompts per micro-batch."""
    _check_served(*_setup(arch, PROMPT))


def test_serve_cli_runs_reduced_on_the_cpu(capsys):
    S.main(["--arch", "qwen2-0.5b", "--reduced", "--device", "cpu", "--requests", "4",
            "--prompt-len", "8", "--new-tokens", "3", "--batch-max", "2"])
    out = capsys.readouterr().out
    assert "served 4/4 requests" in out and "retries=0 failed=0" in out


def test_serve_cli_runs_reduced_mamba_on_the_cpu(capsys):
    S.main(["--arch", "mamba2-130m", "--reduced", "--device", "cpu", "--requests", "4",
            "--prompt-len", "16", "--new-tokens", "3", "--batch-max", "2"])
    out = capsys.readouterr().out
    assert "served 4/4 requests" in out and "retries=0 failed=0" in out


def test_full_depth_qwen3_moe_is_refused_before_its_weights_are_drawn(monkeypatch):
    """~470 GB of bf16 weights against an 80 GB card: ``main`` raises,
    naming the memory, before ``init_params`` runs (which would fail the
    test if reached)."""
    monkeypatch.setattr(S, "_memory_bytes", lambda device: 80 * 10**9)
    monkeypatch.setattr(S.M, "init_params", lambda *a, **k: pytest.fail("allocated"))
    with pytest.raises(ValueError, match=r"470\.2 GB of bfloat16 weights.*80\.0 GB"):
        S.main(["--arch", "qwen3-moe-235b-a22b", "--device", "cpu"])
    S.check_weights_fit(reduced("qwen3-moe-235b-a22b"), torch.device("cpu"))


def test_serve_on_a_missing_card_raises(setup):
    cfg, params, prompts = setup
    if torch.cuda.is_available():
        pytest.skip("a card is present: the missing-card path cannot be taken")
    with pytest.raises(RuntimeError, match="cuda"):
        S.serve(cfg, params, prompts, new_tokens=NEW, device="cuda")


@pytest.mark.parametrize("arch", ["qwen2.5-14b", "musicgen-medium", "recurrentgemma-2b",
                                  "granite-moe-3b-a800m", "qwen3-moe-235b-a22b"])
def test_serve_cli_runs_reduced_new_archs_on_the_cpu(capsys, arch):
    S.main(["--arch", arch, "--reduced", "--device", "cpu", "--requests", "4",
            "--prompt-len", "8", "--new-tokens", "3", "--batch-max", "2"])
    out = capsys.readouterr().out
    assert "served 4/4 requests" in out and "retries=0 failed=0" in out
