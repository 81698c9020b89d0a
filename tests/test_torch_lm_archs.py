"""The port's remaining dense and frontend configs against the JAX package's,
on the CPU, on the same weights: reduced ``glm4-9b``, ``qwen2.5-3b``,
``qwen2.5-14b`` (GQA groups 2, 2 and 5), ``internvl2-1b`` (a vision-patch
prefix) and ``musicgen-medium`` (an audio-frame prefix, LayerNorm, the
GELU MLP, MHA and sinusoidal positions).

As in ``test_torch_lm.py``: the reference's parameters are drawn by
``repro.models.model.init_params``, taken to numpy with biases and norm
parameters perturbed away from their 0/1 init, and handed to both packages
(to the port through ``params_from_numpy``).  A frontend config's prompts
carry ``embeds`` (B, n_prefix, d) drawn in numpy.  float32 logits and K/V
caches are held within 1e-4 and greedy tokens must be equal
(``test_torch_lm.py``'s tolerance).

bfloat16 is held to the reference's own bf16 error instead of a fixed
2e-2: with an untied head (GLM-4-9B, Qwen2.5-14B, MusicGen) the logits
reach ~4, where one bf16 step is 2**-6 to 2**-5, and the reference's bf16
logits are 0.03-0.05 from its own float32 logits on the same weights.  Two
bf16 runs that round at different places (XLA's CPU rounds ``silu`` and
``gelu`` op by op; torch's fused ops round once) differ by that much, with
no fault in either.  So the port's bf16 logits must be no further from the
reference's float32 logits than BF16_ERROR_RATIO times the reference's bf16
logits are, at the worst element and on average.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as JB
from repro.configs.base import reduced as jax_reduced
from repro.models import model as JM
from repro.models.layers import sinusoidal_pos_emb as jax_sinusoidal
from repro_torch.configs import base as TB
from repro_torch.configs.base import reduced
from repro_torch.models import model as TM
from repro_torch.models.layers import sinusoidal_pos_emb

ARCHS = ["glm4-9b", "qwen2.5-3b", "qwen2.5-14b", "internvl2-1b", "musicgen-medium"]
TOL = {"float32": 1e-4}
BF16_ERROR_RATIO = {"max": 1.5, "mean": 1.25}
PERTURBED = ("bq", "bk", "bv", "scale", "bias")


def _cfgs(arch, dtype):
    return (dataclasses.replace(jax_reduced(arch), dtype=dtype),
            dataclasses.replace(reduced(arch), dtype=dtype))


def _tree(jcfg, seed=0):
    """Reference parameters as numpy, with biases and norm parameters
    perturbed."""
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(np.asarray, JM.init_params(jax.random.PRNGKey(seed), jcfg))

    def perturb(path, a):
        if path[-1].key in PERTURBED:
            return (a.astype(np.float32) + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(perturb, tree)


def _tokens(shape, vocab, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def _embeds(cfg, batch, seed=11):
    """(batch, n_prefix, d) float32 prefix embeddings, or None without a
    frontend."""
    if cfg.frontend is None:
        return None
    return np.random.default_rng(seed).standard_normal(
        (batch, cfg.n_prefix, cfg.d_model), dtype=np.float32)


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.fixture(scope="module", params=ARCHS)
def f32(request):
    jcfg, tcfg = _cfgs(request.param, "float32")
    tree = _tree(jcfg)
    return jcfg, tcfg, tree, TM.params_from_numpy(tcfg, tree, device="cpu")


@pytest.mark.parametrize("seq", [16, 64], ids=["attend_full", "attend_chunked"])
def test_forward_logits_match_jax(f32, seq):
    jcfg, tcfg, tree, params = f32
    toks = _tokens((2, seq), jcfg.vocab_size)
    embeds = _embeds(jcfg, 2)
    want = jax.jit(lambda p, t, e: JM.forward(p, jcfg, t, e))(tree, toks, embeds)
    got = TM.forward(params, tcfg, torch.from_numpy(toks).long(), _t(embeds))
    assert got.dtype == torch.float32 and got.shape == (2, seq, jcfg.vocab_size)
    _close(got.numpy(), want, TOL["float32"])


def test_prefill_and_decode_steps_match_jax(f32):
    """Prefill (with the prefix where the config has a frontend), then 3
    decode steps: logits and every layer's K/V cache after each stage."""
    jcfg, tcfg, tree, params = f32
    B, S, steps = 2, 40, 3
    cache_len = S + steps
    prompt = _tokens((B, S), jcfg.vocab_size, seed=2)
    feed = _tokens((steps, B), jcfg.vocab_size, seed=3)
    embeds = _embeds(jcfg, B)
    j_logits, j_caches = jax.jit(lambda p, t, e: JM.prefill(p, jcfg, t, cache_len, e))(
        tree, prompt, embeds)
    t_logits, t_caches = TM.prefill(params, tcfg, torch.from_numpy(prompt).long(), cache_len,
                                    _t(embeds))
    _close(t_logits.numpy(), j_logits, TOL["float32"])

    def check_caches():
        group = j_caches["groups"]["b0_attn"]
        assert len(t_caches) == tcfg.n_layers
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


def test_greedy_tokens_after_a_prefix_equal_jax(f32):
    """Greedy decode from a prefill that took ``embeds`` (the token ids
    under the prefix then do not matter): the argmax of each step fed back,
    in both packages."""
    jcfg, tcfg, tree, params = f32
    B, S, n_new = 2, 24, 6
    prompt = _tokens((B, S), jcfg.vocab_size, seed=8)
    embeds = _embeds(jcfg, B, seed=9)
    j_logits, j_caches = jax.jit(lambda p, t, e: JM.prefill(p, jcfg, t, S + n_new, e))(
        tree, prompt, embeds)
    j_step = jax.jit(lambda p, t, c, pos: JM.decode_step(p, jcfg, t, c, pos))
    want = [jnp.argmax(j_logits, axis=-1).astype(jnp.int32)]
    for i in range(n_new - 1):
        j_logits, j_caches = j_step(tree, want[-1], j_caches, S + i)
        want.append(jnp.argmax(j_logits, axis=-1).astype(jnp.int32))
    logits, caches = TM.prefill(params, tcfg, torch.from_numpy(prompt).long(), S + n_new,
                                _t(embeds))
    got = TM.decode_greedy(params, tcfg, torch.argmax(logits, dim=-1), caches, S, n_new)
    np.testing.assert_array_equal(got.numpy(), np.stack([np.asarray(w) for w in want], 1))


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_forward_is_as_accurate_as_jax(arch):
    """MusicGen's case covers LayerNorm, the GELU MLP and the sinusoidal
    positions in bf16; the others GQA, QKV bias and untied heads."""
    jcfg, tcfg = _cfgs(arch, "bfloat16")
    tree = _tree(jcfg, seed=5)
    params = TM.params_from_numpy(tcfg, tree, device="cpu")
    assert params["embedding"]["tokens"].dtype == torch.bfloat16
    jcfg32 = dataclasses.replace(jcfg, dtype="float32")
    tree32 = jax.tree.map(lambda a: a.astype(np.float32), tree)
    toks = _tokens((2, 64), jcfg.vocab_size, seed=6)
    embeds = _embeds(jcfg, 2, seed=7)
    exact = np.asarray(jax.jit(lambda p, t, e: JM.forward(p, jcfg32, t, e))(tree32, toks,
                                                                             embeds))
    ref = np.asarray(jax.jit(lambda p, t, e: JM.forward(p, jcfg, t, e))(tree, toks, embeds))
    got = TM.forward(params, tcfg, torch.from_numpy(toks).long(), _t(embeds)).numpy()
    err_got, err_ref = np.abs(got - exact), np.abs(ref - exact)
    assert err_got.max() <= BF16_ERROR_RATIO["max"] * err_ref.max()
    assert err_got.mean() <= BF16_ERROR_RATIO["mean"] * err_ref.mean()


@pytest.mark.parametrize("d_model", [64, 1536])
def test_sinusoidal_pos_emb_matches_reference(d_model):
    """Positions 0-32,767 (the longest shape's prefill) at the reduced and
    the published MusicGen width.  XLA's CPU ``exp`` and torch's differ by
    one ulp in 72 of MusicGen's 768 float32 frequencies; the angle then
    differs by position x one ulp of its frequency, and may round to the
    other neighbour: up to 1.95e-3 apart at position 32,767.  So each
    element is held within 1e-6 plus two ulps of the angle, one ulp taken
    as 2**-23 of the value."""
    pos = np.arange(32_768, dtype=np.int32).reshape(8, 4_096)
    want = np.asarray(jax_sinusoidal(jnp.asarray(pos), d_model))
    got = sinusoidal_pos_emb(torch.from_numpy(pos), d_model)
    assert got.dtype == torch.float32 and got.shape == (8, 4_096, d_model)
    half = d_model // 2
    freqs = np.exp(-np.log(10000.0) * np.arange(half) / half)
    shift = 2 * pos[..., None] * freqs * 2.0 ** -23
    bound = 1e-6 + np.concatenate([shift, shift], axis=-1)
    assert (np.abs(got.numpy() - want) <= bound).all()


@pytest.mark.parametrize("arch", ["internvl2-1b", "musicgen-medium"])
def test_embeds_longer_than_the_prompt_raise_in_both(arch):
    jcfg, tcfg = _cfgs(arch, "float32")
    tree = _tree(jcfg)
    params = TM.params_from_numpy(tcfg, tree, device="cpu")
    toks = _tokens((1, 3), jcfg.vocab_size)
    embeds = _embeds(jcfg, 1)
    assert embeds.shape[1] > toks.shape[1]
    with pytest.raises((TypeError, ValueError)):
        JM.forward(tree, jcfg, toks, embeds)
    with pytest.raises(ValueError, match="embeds"):
        TM.forward(params, tcfg, torch.from_numpy(toks).long(), _t(embeds))
    with pytest.raises(ValueError, match="embeds"):
        TM.prefill(params, tcfg, torch.from_numpy(toks).long(), 8, _t(embeds))


# -- config helpers ---------------------------------------------------------

PORTED = ["qwen2-0.5b", "mamba2-130m"] + ARCHS + ["recurrentgemma-2b", "granite-moe-3b-a800m",
                                                  "qwen3-moe-235b-a22b"]


def test_shapes_and_list_configs_are_the_references():
    assert {n: dataclasses.astuple(s) for n, s in TB.SHAPES.items()} == \
        {n: dataclasses.astuple(s) for n, s in JB.SHAPES.items()}
    assert TB.list_configs() == sorted(PORTED)
    assert set(TB.list_configs()) <= set(JB.list_configs())


@pytest.mark.parametrize("small", [False, True], ids=["published", "reduced"])
@pytest.mark.parametrize("arch", PORTED)
def test_helpers_equal_reference(arch, small):
    """Attention-free, subquadratic, every shape's support, and the
    parameter counts (the reference's SwiGLU count, even for a GELU MLP)."""
    want, got = JB.get_config(arch, reduced=small), TB.get_config(arch, reduced=small)
    assert got.is_attention_free == want.is_attention_free
    assert got.is_subquadratic == want.is_subquadratic
    for name in JB.SHAPES:
        assert got.supports_shape(TB.SHAPES[name]) == want.supports_shape(JB.SHAPES[name])
    assert got.param_count() == want.param_count()
    assert got.active_param_count() == want.active_param_count()


def test_musicgen_counts_the_references_swiglu_mlp():
    """The count is the reference's, copied: 3 d d_ff a layer for the MLP
    though MusicGen's GELU MLP holds 2 d d_ff, and d a norm though a
    LayerNorm also holds a bias of d."""
    cfg = TB.get_config("musicgen-medium")
    assert cfg.mlp_type == "gelu" and cfg.active_param_count() == 1_818_379_776
    small = TB.reduced("musicgen-medium")
    params = TM.init_params(small, torch.Generator().manual_seed(0), device="cpu")
    held = sum(t.numel() for t in params.parameters())
    extra_mlp = small.n_layers * small.d_model * small.d_ff
    norm_biases = (2 * small.n_layers + 1) * small.d_model
    assert small.param_count() - held == extra_mlp - norm_biases


# -- examples/serve_stream.py's part 2 on the port --------------------------

def _serve_stream_part2(cfg, pilot_api, fit_usl, autoscaler, policy):
    """examples/serve_stream.py's part 2 against one package's modules:
    the serverless sweep with the model's analytic cost, the USL fit, and
    the autoscaler's answers."""
    flops_per_req = 2.0 * cfg.active_param_count() * (16 + 4)
    ns, ts = [], []
    for n in [1, 2, 4, 8, 12, 16, 24]:
        pcs = pilot_api.PilotComputeService(seed=0)
        pilot = pcs.submit_pilot(pilot_api.PilotDescription(
            resource="serverless://aws-sim", memory_mb=3008, partitions=n))
        prof = pilot_api.TaskProfile(flops=flops_per_req / 1e3, msg_bytes=16 * 4,
                                     read_bytes=1e6, write_bytes=0)
        cus = [pilot.submit_compute_unit(pilot_api.ComputeUnitDescription(profile=prof))
               for _ in range(30 * n)]
        pilot.wait_all()
        done = [c for c in cus if c.state.name == "DONE"]
        span = max(c.end_ts for c in done) - min(c.start_ts for c in done)
        ns.append(n)
        ts.append(len(done) / span)
        pcs.close()
    fit = fit_usl(np.array(ns, float), np.array(ts, float))
    scaler = autoscaler(fit, policy(headroom=0.15, max_partitions=30))
    targets = [5, 20, 60, 200]
    return (ts, dataclasses.astuple(fit), scaler.max_sustainable_rate(),
            [scaler.partitions_for(t) for t in targets],
            [scaler.throttle_rate(t) for t in targets],
            scaler.plan([3, 8, 25, 60, 25, 8, 3]))


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "qwen2.5-14b", "musicgen-medium"])
def test_serve_stream_flow_equals_reference(arch):
    from repro.core import autoscale as j_autoscale
    from repro.core import usl as j_usl
    from repro.pilot import api as j_api
    from repro_torch.core import autoscale as t_autoscale
    from repro_torch.core import usl as t_usl
    from repro_torch.pilot import api as t_api

    want = _serve_stream_part2(JB.get_config(arch), j_api, j_usl.fit_usl,
                               j_autoscale.Autoscaler, j_autoscale.AutoscalePolicy)
    got = _serve_stream_part2(TB.get_config(arch), t_api, t_usl.fit_usl,
                              t_autoscale.Autoscaler, t_autoscale.AutoscalePolicy)
    assert repr(got) == repr(want)
