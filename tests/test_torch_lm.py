"""The port's dense LM (reduced ``qwen2-0.5b``) against the JAX package's, on
the CPU, on the same weights.

The reference's parameters are drawn by ``repro.models.model.init_params``,
taken to numpy (biases and norm scales perturbed away from their 0/1 init,
so they are exercised), and handed to both packages: to the reference as
they are, to the port through ``params_from_numpy``.  In float32 the two
differ only in the order of their sums, so logits and K/V caches are held
within rtol/atol 1e-4 and greedy tokens must be equal.  In bfloat16 the two
frameworks round at different places (each matmul output, the MLP's
activation), and the logits are bf16 products (one bf16 step near the
largest logits, ~0.7, is 2**-8), so logits are held within 2e-2 there.
On the CPU the port's prefill attention is the flash-attention kernel's
plain version.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.configs.base import reduced as jax_reduced
from repro.models import model as JM
from repro_torch.configs.base import get_config, reduced
from repro_torch.models import attention as TA
from repro_torch.models import model as TM
from repro_torch.models import transformer as TT

ARCH = "qwen2-0.5b"
TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _cfgs(dtype):
    return (dataclasses.replace(jax_reduced(ARCH), dtype=dtype),
            dataclasses.replace(reduced(ARCH), dtype=dtype))


def _tree(jcfg, seed=0):
    """Reference parameters as numpy, with biases and norm scales perturbed."""
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(np.asarray, JM.init_params(jax.random.PRNGKey(seed), jcfg))

    def perturb(path, a):
        name = path[-1].key
        if name in ("bq", "bk", "bv", "scale"):
            return (a.astype(np.float32) + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(perturb, tree)


@pytest.fixture(scope="module")
def f32():
    jcfg, tcfg = _cfgs("float32")
    tree = _tree(jcfg)
    return jcfg, tcfg, tree, TM.params_from_numpy(tcfg, tree, device="cpu")


def _tokens(shape, vocab, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("seq", [16, 64], ids=["attend_full", "attend_chunked"])
def test_forward_logits_match_jax(f32, seq):
    jcfg, tcfg, tree, params = f32
    toks = _tokens((2, seq), jcfg.vocab_size)
    want = jax.jit(lambda p, t: JM.forward(p, jcfg, t))(tree, toks)
    got = TM.forward(params, tcfg, torch.from_numpy(toks).long())
    assert got.dtype == torch.float32 and got.shape == (2, seq, jcfg.vocab_size)
    _close(got.numpy(), want, TOL["float32"])


def test_prefill_and_decode_steps_match_jax(f32):
    jcfg, tcfg, tree, params = f32
    B, S, steps = 2, 40, 6
    cache_len = S + steps
    prompt = _tokens((B, S), jcfg.vocab_size, seed=2)
    feed = _tokens((steps, B), jcfg.vocab_size, seed=3)
    j_logits, j_caches = jax.jit(lambda p, t: JM.prefill(p, jcfg, t, cache_len))(tree, prompt)
    t_logits, t_caches = TM.prefill(params, tcfg, torch.from_numpy(prompt).long(), cache_len)
    _close(t_logits.numpy(), j_logits, TOL["float32"])

    def check_caches():
        group = j_caches["groups"]["b0_attn"]
        for layer, cache in enumerate(t_caches):
            for name in ("k", "v"):
                _close(cache[name].numpy(), group[name][layer], TOL["float32"])

    check_caches()
    j_step = jax.jit(lambda p, t, c, pos: JM.decode_step(p, jcfg, t, c, pos))
    for i in range(steps):
        j_logits, j_caches = j_step(tree, feed[i], j_caches, S + i)
        t_logits, t_caches = TM.decode_step(params, tcfg, torch.from_numpy(feed[i]).long(),
                                            t_caches, S + i)
        _close(t_logits.numpy(), j_logits, TOL["float32"])
    check_caches()


@pytest.mark.parametrize("batch", [1, 3])
def test_greedy_generate_tokens_equal_jax(f32, batch):
    jcfg, tcfg, tree, params = f32
    prompt = _tokens((batch, 24), jcfg.vocab_size, seed=4)
    want = jax.jit(lambda p, t: JM.greedy_generate(p, jcfg, t, n_new=8))(tree, prompt)
    got = TM.greedy_generate(params, tcfg, torch.from_numpy(prompt).long(), 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_bf16_forward_logits_match_jax():
    jcfg, tcfg = _cfgs("bfloat16")
    tree = _tree(jcfg, seed=5)
    params = TM.params_from_numpy(tcfg, tree, device="cpu")
    assert params["embedding"]["tokens"].dtype == torch.bfloat16
    toks = _tokens((2, 64), jcfg.vocab_size, seed=6)
    want = jax.jit(lambda p, t: JM.forward(p, jcfg, t))(tree, toks)
    got = TM.forward(params, tcfg, torch.from_numpy(toks).long())
    _close(got.numpy(), want, TOL["bfloat16"])


def test_prefill_attention_is_plain_full_attention(f32):
    """``attend`` (the kernel's plain version on the CPU) and the model-level
    ``attend_full`` agree on a prompt, K/V included."""
    _, tcfg, _, params = f32
    p = params["stack"][0]["attn"]
    x = torch.from_numpy(np.random.default_rng(7).standard_normal((2, 50, tcfg.d_model),
                                                                  dtype=np.float32))
    pos = torch.arange(50)[None].expand(2, 50)
    out, (k, v) = TA.attend(p, tcfg, x, pos)
    ref, (rk, rv) = TA.attend_full(p, tcfg, x, pos)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
    assert torch.equal(k, rk) and torch.equal(v, rv)


def test_init_params_has_the_reference_layout(f32):
    jcfg, tcfg, _, converted = f32
    fresh = TM.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    want = {n: (tuple(t.shape), t.dtype) for n, t in converted.named_parameters()}
    got = {n: (tuple(t.shape), t.dtype) for n, t in fresh.named_parameters()}
    assert got == want
    assert sum(t.numel() for t in fresh.parameters()) == tcfg.param_count()
    assert [b.kind for b in fresh["stack"]] == ["attn"] * tcfg.n_layers
    toks = torch.from_numpy(_tokens((2, 12), tcfg.vocab_size)).long()
    out = TM.greedy_generate(fresh, tcfg, toks, 4)
    assert out.shape == (2, 4) and bool(((out >= 0) & (out < tcfg.vocab_size)).all())


@pytest.mark.parametrize("kind", ["ssm", "rglru", "local_attn", "moe"])
def test_unported_block_kinds_raise(kind):
    _, tcfg = _cfgs("float32")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TM.init_params(dataclasses.replace(tcfg, block_pattern=(kind,)),
                       torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TT.apply_block(None, tcfg, kind, torch.zeros(1, 2, tcfg.d_model), None)


def test_local_window_raises(f32):
    _, tcfg, _, params = f32
    p = params["stack"][0]["attn"]
    x = torch.zeros(1, 8, tcfg.d_model)
    pos = torch.arange(8)[None]
    for fn in (TA.attend, TA.attend_full):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            fn(p, tcfg, x, pos, window=4)


@pytest.mark.parametrize("small", [False, True], ids=["published", "reduced"])
def test_config_is_the_references(small):
    """Every field the port's config has equals the reference's, and the
    reference leaves its mesh padding (not ported yet) unset."""
    want, got = jax_get_config(ARCH, reduced=small), get_config(ARCH, reduced=small)
    for f in dataclasses.fields(got):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert (want.heads_p, want.kv_heads_p, want.vocab_p) == (
        got.n_heads, got.n_kv_heads, got.vocab_size)


def test_cache_init_is_on_the_card_unless_asked(f32):
    _, tcfg, _, _ = f32
    caches = TM.cache_init(tcfg, 2, 8, device="cpu")
    assert len(caches) == tcfg.n_layers
    for cache in caches:
        for name in ("k", "v"):
            t = cache[name]
            assert t.device.type == "cpu" and t.dtype == torch.float32
            assert t.shape == (2, 8, tcfg.n_kv_heads, tcfg.head_dim) and not t.any()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            TM.cache_init(tcfg, 2, 8)
