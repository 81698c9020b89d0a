"""The port's Mamba-2 LM (reduced ``mamba2-130m``) against the JAX package's,
on the CPU, on the same weights.

The reference's parameters are drawn by ``repro.models.model.init_params``,
taken to numpy (norm scales, ``conv_b``, ``D`` and ``norm_scale`` perturbed
away from their 0/1 init, so they are exercised), and handed to both
packages: to the reference as they are, to the port through
``params_from_numpy``.  In float32 the two differ only in the order of
their sums, so logits and the ``h``/``conv`` caches are held within
rtol/atol 1e-4 and greedy tokens must be equal.  In bfloat16 the two
frameworks round at different places, so logits are held within 2e-2 (as
``tests/test_torch_lm.py`` holds Qwen2's).  On the CPU the prefill's SSD is
the kernel's plain version.  Prompt lengths are at most the reduced chunk
(16) or multiples of it: the reference asserts that.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.configs.base import reduced as jax_reduced
from repro.models import model as JM
from repro.models import ssm as JS
from repro_torch.configs.base import get_config, reduced
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.models import model as TM
from repro_torch.models import ssm as TS

ARCH = "mamba2-130m"
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
F32_PARAMS = ("A_log", "D", "dt_bias")


def _cfgs(dtype):
    return (dataclasses.replace(jax_reduced(ARCH), dtype=dtype),
            dataclasses.replace(reduced(ARCH), dtype=dtype))


def _tree(jcfg, seed=0):
    """Reference parameters as numpy, with biases, scales and D perturbed."""
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(np.asarray, JM.init_params(jax.random.PRNGKey(seed), jcfg))

    def perturb(path, a):
        if path[-1].key in ("scale", "conv_b", "D", "norm_scale"):
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


@pytest.mark.parametrize("seq", [16, 48], ids=["one_chunk", "three_chunks"])
def test_forward_logits_match_jax(f32, seq):
    jcfg, tcfg, tree, params = f32
    toks = _tokens((2, seq), jcfg.vocab_size)
    want = jax.jit(lambda p, t: JM.forward(p, jcfg, t))(tree, toks)
    got = TM.forward(params, tcfg, torch.from_numpy(toks).long())
    assert got.dtype == torch.float32 and got.shape == (2, seq, jcfg.vocab_size)
    _close(got.numpy(), want, TOL["float32"])


def test_prefill_and_decode_steps_match_jax(f32):
    jcfg, tcfg, tree, params = f32
    B, S, steps = 2, 32, 6
    prompt = _tokens((B, S), jcfg.vocab_size, seed=2)
    feed = _tokens((steps, B), jcfg.vocab_size, seed=3)
    j_logits, j_caches = jax.jit(lambda p, t: JM.prefill(p, jcfg, t, S + steps))(tree, prompt)
    before = ssd_ops.LAUNCHES["ssd_scan"]
    t_logits, t_caches = TM.prefill(params, tcfg, torch.from_numpy(prompt).long(), S + steps)
    assert ssd_ops.LAUNCHES["ssd_scan"] == before          # plain version on the CPU
    _close(t_logits.numpy(), j_logits, TOL["float32"])

    def check_caches():
        group = j_caches["groups"]["b0_ssm"]
        for layer, cache in enumerate(t_caches):
            assert cache["h"].dtype == torch.float32
            for name in ("h", "conv"):
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
    prompt = _tokens((batch, 32), jcfg.vocab_size, seed=4)
    want = jax.jit(lambda p, t: JM.greedy_generate(p, jcfg, t, n_new=8))(tree, prompt)
    got = TM.greedy_generate(params, tcfg, torch.from_numpy(prompt).long(), 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_bf16_forward_logits_match_jax():
    jcfg, tcfg = _cfgs("bfloat16")
    tree = _tree(jcfg, seed=5)
    params = TM.params_from_numpy(tcfg, tree, device="cpu")
    toks = _tokens((2, 32), jcfg.vocab_size, seed=6)
    want = jax.jit(lambda p, t: JM.forward(p, jcfg, t))(tree, toks)
    got = TM.forward(params, tcfg, torch.from_numpy(toks).long())
    _close(got.numpy(), want, TOL["bfloat16"])


def test_params_from_numpy_keeps_the_f32_ssm_parameters():
    """In a bf16 model the reference holds ``A_log``, ``D`` and ``dt_bias``
    in float32; the port keeps them so, and casts the rest to bf16."""
    jcfg, tcfg = _cfgs("bfloat16")
    tree = _tree(jcfg, seed=7)
    params = TM.params_from_numpy(tcfg, tree, device="cpu")
    group = tree["stack"]["groups"]["b0_ssm"]["ssm"]
    for layer, block in enumerate(params["stack"]):
        for name, t in block["ssm"].items():
            want = torch.float32 if name in F32_PARAMS else torch.bfloat16
            assert t.dtype == want, name
            assert np.array_equal(t.float().numpy(), group[name][layer].astype(np.float32))
    assert params["embedding"]["tokens"].dtype == torch.bfloat16


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_has_the_reference_layout(dtype):
    jcfg, tcfg = _cfgs(dtype)
    converted = TM.params_from_numpy(tcfg, _tree(jcfg), device="cpu")
    fresh = TM.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    want = {n: (tuple(t.shape), t.dtype) for n, t in converted.named_parameters()}
    got = {n: (tuple(t.shape), t.dtype) for n, t in fresh.named_parameters()}
    assert got == want
    assert [b.kind for b in fresh["stack"]] == ["ssm"] * tcfg.n_layers
    ssm = fresh["stack"][0]["ssm"]
    torch.testing.assert_close(-torch.exp(ssm["A_log"]),
                               -torch.linspace(1.0, 16.0, ssm["A_log"].numel()))
    dt = torch.nn.functional.softplus(ssm["dt_bias"])
    assert bool(((dt > 0.0009) & (dt < 0.11)).all())
    toks = torch.from_numpy(_tokens((2, 16), tcfg.vocab_size)).long()
    out = TM.greedy_generate(fresh, tcfg, toks, 4)
    assert out.shape == (2, 4) and bool(((out >= 0) & (out < tcfg.vocab_size)).all())


def test_block_pieces_match_jax(f32):
    """``_causal_conv`` (prefill and with a history) and ``_segsum``."""
    rng = np.random.default_rng(8)
    xbc = rng.standard_normal((2, 12, 10), dtype=np.float32)
    w = rng.standard_normal((4, 10), dtype=np.float32)
    bias = rng.standard_normal(10, dtype=np.float32)
    hist = rng.standard_normal((2, 3, 10), dtype=np.float32)
    for state in (None, hist):
        want = JS._causal_conv(xbc, w, bias, state)
        got = TS._causal_conv(*(torch.from_numpy(a) for a in (xbc, w, bias)),
                              None if state is None else torch.from_numpy(state))
        for g, v in zip(got, want):
            _close(g.numpy(), v, 1e-6)
    a = -np.abs(rng.standard_normal((3, 7), dtype=np.float32))
    want = np.asarray(JS._segsum(a))
    got = TS._segsum(torch.from_numpy(a)).numpy()
    assert np.array_equal(np.isinf(got), np.isinf(want))
    _close(np.where(np.isinf(got), 0, got), np.where(np.isinf(want), 0, want), 1e-6)


def test_cache_init_layout(f32):
    _, tcfg, _, _ = f32
    for dtype in (torch.float32, torch.bfloat16):
        caches = TM.cache_init(tcfg, 3, 99, dtype=dtype, device="cpu")
        di = tcfg.ssm_expand * tcfg.d_model
        for cache in caches:
            assert cache["h"].dtype == torch.float32 and cache["conv"].dtype == dtype
            assert cache["h"].shape == (3, di // tcfg.ssm_head_dim, tcfg.ssm_head_dim,
                                        tcfg.ssm_state)
            assert cache["conv"].shape == (3, tcfg.ssm_conv - 1, di + 2 * tcfg.ssm_state)
            assert not cache["h"].any() and not cache["conv"].any()


def test_prompt_not_a_multiple_of_the_chunk_raises(f32):
    _, tcfg, _, params = f32
    with pytest.raises(ValueError, match="multiple of the chunk"):
        TM.prefill(params, tcfg, torch.zeros((1, 20), dtype=torch.long))


@pytest.mark.parametrize("small", [False, True], ids=["published", "reduced"])
def test_config_is_the_references(small):
    want, got = jax_get_config(ARCH, reduced=small), get_config(ARCH, reduced=small)
    for f in dataclasses.fields(got):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert got.param_count() == want.param_count()
    if not small:
        assert got.param_count() == 128_921_472
