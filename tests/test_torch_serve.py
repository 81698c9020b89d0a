"""The port's serving path end to end on the CPU: requests -> Broker ->
ThreadedStreamingEngine -> ``torch://`` pilot -> greedy generation, with
the reduced ``qwen2-0.5b`` in float32.  Micro-batching must not change what
a request gets: each request's tokens equal ``greedy_generate`` on its own
prompt (float32, so batched and single-row sums cannot flip an argmax)."""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.base import reduced
from repro_torch.launch import serve as S
from repro_torch.models import model as M

N_REQ, PROMPT, NEW = 6, 20, 5


@pytest.fixture(scope="module")
def setup():
    cfg = dataclasses.replace(reduced("qwen2-0.5b"), dtype="float32")
    params = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (N_REQ, PROMPT))
    return cfg, params, prompts


def test_serve_answers_every_request_as_greedy_generate(setup):
    cfg, params, prompts = setup
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


def test_serve_cli_runs_reduced_on_the_cpu(capsys):
    S.main(["--arch", "qwen2-0.5b", "--reduced", "--device", "cpu", "--requests", "4",
            "--prompt-len", "8", "--new-tokens", "3", "--batch-max", "2"])
    out = capsys.readouterr().out
    assert "served 4/4 requests" in out and "retries=0 failed=0" in out


def test_serve_on_a_missing_card_raises(setup):
    cfg, params, prompts = setup
    if torch.cuda.is_available():
        pytest.skip("a card is present: the missing-card path cannot be taken")
    with pytest.raises(RuntimeError, match="cuda"):
        S.serve(cfg, params, prompts, new_tokens=NEW, device="cuda")
