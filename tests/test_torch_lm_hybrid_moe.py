"""The port's hybrid and MoE configs against the JAX package's, on the CPU, on
the same weights: reduced ``recurrentgemma-2b`` (RG-LRU layers and local
attention with a window of 16, a ring cache, the GeGLU MLP, MQA) and the
MoE ``granite-moe-3b-a800m`` and ``qwen3-moe-235b-a22b`` (8 experts, top-2).

As in ``test_torch_lm_archs.py``: the reference's parameters are drawn by
``repro.models.model.init_params``, taken to numpy with biases and norm
parameters perturbed away from their 0/1 init, and handed to both packages
(to the port through ``params_from_numpy``, which keeps the RG-LRU's
``b_a``, ``b_i``, ``lam`` and the MoE router in float32).  float32 logits
and every layer's cache (K/V, or the RG-LRU's state and conv history) are
held within 1e-4 and greedy tokens must be equal; bfloat16 is held to
``BF16_ERROR_RATIO`` times the reference's own bf16 error against its
float32 logits.  The prompts (40 tokens) outrun RecurrentGemma's window,
so prefill fills and rolls the ring, and decode wraps it.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import reduced as jax_reduced
from repro.models import model as JM
from repro_torch.configs.base import reduced
from repro_torch.models import model as TM

ARCHS = ["recurrentgemma-2b", "granite-moe-3b-a800m", "qwen3-moe-235b-a22b"]
TOL = 1e-4
BF16_ERROR_RATIO = {"max": 1.5, "mean": 1.25}
PERTURBED = ("scale", "bias", "b_a", "b_i", "conv_b")


def _cfgs(arch, dtype):
    return (dataclasses.replace(jax_reduced(arch), dtype=dtype),
            dataclasses.replace(reduced(arch), dtype=dtype))


def _tree(jcfg, seed=0):
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(np.asarray, JM.init_params(jax.random.PRNGKey(seed), jcfg))

    def perturb(path, a):
        if path[-1].key in PERTURBED:
            return (a.astype(np.float32) + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(perturb, tree)


def _tokens(shape, vocab, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _reference_layer_caches(cfg, caches):
    """The reference's cache tree as one dict per layer, in layer order."""
    out = []
    for g in range(cfg.n_groups):
        for i, kind in enumerate(cfg.block_pattern):
            out.append({n: a[g] for n, a in caches["groups"][f"b{i}_{kind}"].items()})
    return out + list(caches["tail"])


@pytest.fixture(scope="module", params=ARCHS)
def f32(request):
    jcfg, tcfg = _cfgs(request.param, "float32")
    tree = _tree(jcfg)
    return jcfg, tcfg, tree, TM.params_from_numpy(tcfg, tree, device="cpu")


def test_params_keep_the_references_dtypes():
    jcfg, tcfg = _cfgs("recurrentgemma-2b", "bfloat16")
    params = TM.params_from_numpy(tcfg, _tree(jcfg), device="cpu")
    rec = params["stack"][0]["rec"]
    assert rec["w_a"].dtype == torch.bfloat16
    assert {rec[n].dtype for n in ("b_a", "b_i", "lam")} == {torch.float32}
    jcfg, tcfg = _cfgs("granite-moe-3b-a800m", "bfloat16")
    params = TM.params_from_numpy(tcfg, _tree(jcfg), device="cpu")
    ffn = params["stack"][0]["ffn"]
    assert ffn["router"].dtype == torch.float32 and ffn["w_up"].dtype == torch.bfloat16
    assert tuple(ffn["w_gate"].shape) == (tcfg.n_experts, tcfg.d_model, tcfg.d_ff)


@pytest.mark.parametrize("seq", [16, 64], ids=["attend_full", "attend_chunked"])
def test_forward_logits_match_jax(f32, seq):
    jcfg, tcfg, tree, params = f32
    toks = _tokens((2, seq), jcfg.vocab_size)
    want = jax.jit(lambda p, t: JM.forward(p, jcfg, t))(tree, toks)
    got = TM.forward(params, tcfg, torch.from_numpy(toks).long())
    assert got.dtype == torch.float32 and got.shape == (2, seq, jcfg.vocab_size)
    _close(got.numpy(), want)


def test_prefill_and_decode_steps_match_jax(f32):
    """Prefill of 40 tokens, then 6 decode steps: logits after each, and
    every layer's cache after each stage."""
    jcfg, tcfg, tree, params = f32
    B, S, steps = 2, 40, 6
    cache_len = S + steps
    prompt = _tokens((B, S), jcfg.vocab_size, seed=2)
    feed = _tokens((steps, B), jcfg.vocab_size, seed=3)
    j_logits, j_caches = jax.jit(lambda p, t: JM.prefill(p, jcfg, t, cache_len))(tree, prompt)
    t_logits, t_caches = TM.prefill(params, tcfg, torch.from_numpy(prompt).long(), cache_len)
    _close(t_logits.numpy(), j_logits)

    def check_caches():
        want = _reference_layer_caches(jcfg, j_caches)
        assert len(t_caches) == len(want) == tcfg.n_layers
        for got, ref in zip(t_caches, want):
            assert sorted(got) == sorted(ref)
            for name in got:
                assert tuple(got[name].shape) == ref[name].shape
                _close(got[name].float().numpy(), ref[name])

    check_caches()
    j_step = jax.jit(lambda p, t, c, pos: JM.decode_step(p, jcfg, t, c, pos))
    for i in range(steps):
        j_logits, j_caches = j_step(tree, feed[i], j_caches, S + i)
        t_logits, t_caches = TM.decode_step(params, tcfg, torch.from_numpy(feed[i]).long(),
                                            t_caches, S + i)
        _close(t_logits.numpy(), j_logits)
    check_caches()


@pytest.mark.parametrize("batch", [1, 3])
def test_greedy_generate_tokens_equal_jax(f32, batch):
    jcfg, tcfg, tree, params = f32
    prompt = _tokens((batch, 24), jcfg.vocab_size, seed=4)
    want = jax.jit(lambda p, t: JM.greedy_generate(p, jcfg, t, n_new=8))(tree, prompt)
    got = TM.greedy_generate(params, tcfg, torch.from_numpy(prompt).long(), 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_forward_is_as_accurate_as_jax(arch):
    jcfg, tcfg = _cfgs(arch, "bfloat16")
    tree = _tree(jcfg, seed=5)
    params = TM.params_from_numpy(tcfg, tree, device="cpu")
    jcfg32 = dataclasses.replace(jcfg, dtype="float32")
    tree32 = jax.tree.map(lambda a: a.astype(np.float32), tree)
    toks = _tokens((2, 64), jcfg.vocab_size, seed=6)
    exact = np.asarray(jax.jit(lambda p, t: JM.forward(p, jcfg32, t))(tree32, toks))
    ref = np.asarray(jax.jit(lambda p, t: JM.forward(p, jcfg, t))(tree, toks))
    got = TM.forward(params, tcfg, torch.from_numpy(toks).long()).numpy()
    err_got, err_ref = np.abs(got - exact), np.abs(ref - exact)
    assert err_got.max() <= BF16_ERROR_RATIO["max"] * err_ref.max()
    assert err_got.mean() <= BF16_ERROR_RATIO["mean"] * err_ref.mean()
