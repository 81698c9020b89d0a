"""The port's RG-LRU block against the JAX package's, on the CPU, on the same
weights and inputs (the reference's ``rglru_init`` taken to numpy; inputs
drawn in numpy), in float32.

The port scans the linear recurrence by Hillis–Steele doubling where the
reference runs ``jax.lax.associative_scan``: the same products and sums in
another order, so outputs and states are held within rtol 1e-5 (with an
atol of 1e-6 for the values that pass near 0).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JaxModelConfig
from repro.models import rglru as JR
from repro_torch.configs.base import ModelConfig
from repro_torch.models import rglru as TR

RTOL, ATOL = 1e-5, 1e-6
FIELDS = dict(name="t", family="hybrid", n_layers=1, d_model=32, n_heads=2, n_kv_heads=1,
              d_ff=64, vocab_size=64, lru_width=48)
JCFG, TCFG = JaxModelConfig(**FIELDS), ModelConfig(**FIELDS)


@pytest.fixture(scope="module")
def params():
    tree = jax.tree.map(np.asarray, JR.rglru_init(jax.random.PRNGKey(0), JCFG, jnp.float32))
    rng = np.random.default_rng(0)
    # biases away from their zero init, so they are exercised
    tree = {name: (a + 0.1 * rng.standard_normal(a.shape).astype(a.dtype)
                   if name in ("b_a", "b_i", "conv_b") else a) for name, a in tree.items()}
    return tree, {name: torch.from_numpy(np.array(a)) for name, a in tree.items()}


def _u(batch, seq, seed=1):
    return np.random.default_rng(seed).standard_normal((batch, seq, FIELDS["d_model"]),
                                                       dtype=np.float32)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("seq", [1, 2, 3, 7, 64, 100])
def test_apply_rglru_matches_reference(params, seq):
    tree, p = params
    u = _u(2, seq)
    want = JR.apply_rglru(tree, JCFG, jnp.asarray(u))
    got = TR.apply_rglru(p, TCFG, torch.from_numpy(u))
    assert got.shape == (2, seq, FIELDS["d_model"]) and got.dtype == torch.float32
    _close(got.numpy(), want)


@pytest.mark.parametrize("seq", [1, 2, 5, 40])
def test_apply_rglru_with_state_and_return_state_matches_reference(params, seq):
    """With ``h0`` and ``conv_state`` given, and the last state and conv
    history returned."""
    tree, p = params
    u = _u(2, seq, seed=2)
    rng = np.random.default_rng(3)
    h0 = rng.standard_normal((2, 48), dtype=np.float32)
    conv = rng.standard_normal((2, 3, 48), dtype=np.float32)
    want, (wh, wconv) = JR.apply_rglru(tree, JCFG, jnp.asarray(u), jnp.asarray(h0),
                                       jnp.asarray(conv), return_state=True)
    got, (h, new_conv) = TR.apply_rglru(p, TCFG, torch.from_numpy(u), torch.from_numpy(h0),
                                        torch.from_numpy(conv), return_state=True)
    _close(got.numpy(), want)
    _close(h.numpy(), wh)
    _close(new_conv.numpy(), wconv)
    assert h.dtype == torch.float32 and new_conv.shape == (2, 3, 48)


@pytest.mark.parametrize("seq", [1, 2])
def test_conv_below_its_width_keeps_the_padding_as_state(params, seq):
    """At S < 3 the new conv state still holds 3 rows: the zero padding (or
    the old state) and the S new inputs, as the reference's."""
    tree, p = params
    x = _u(2, seq, seed=4)[..., :1].repeat(48, axis=-1)
    for state in (None, np.random.default_rng(5).standard_normal((2, 3, 48),
                                                                  dtype=np.float32)):
        want, wstate = JR._conv(jnp.asarray(x), tree["conv_w"], tree["conv_b"],
                                None if state is None else jnp.asarray(state))
        got, gstate = TR._conv(torch.from_numpy(x), p["conv_w"], p["conv_b"],
                               None if state is None else torch.from_numpy(state))
        _close(got.numpy(), want)
        np.testing.assert_array_equal(gstate.numpy(), np.asarray(wstate))


@pytest.mark.parametrize("prompt,steps", [(5, 4), (1, 3), (16, 8)])
def test_decode_steps_after_a_prefill_equal_the_longer_prefill(params, prompt, steps):
    """A prefill that returns its state, then one ``rglru_decode_step`` a
    token: each step's output equals the position's output of one pass over
    the whole sequence, in the port and in the reference, and the final
    cache equals the state that pass returns."""
    tree, p = params
    u = _u(2, prompt + steps, seed=6)
    whole, (h_all, conv_all) = TR.apply_rglru(p, TCFG, torch.from_numpy(u), return_state=True)
    want_whole = JR.apply_rglru(tree, JCFG, jnp.asarray(u))
    _close(whole.numpy(), want_whole)
    _, (h, conv) = TR.apply_rglru(p, TCFG, torch.from_numpy(u[:, :prompt]), return_state=True)
    cache = TR.rglru_cache_init(TCFG, 2, device="cpu")
    cache["h"].copy_(h)
    cache["conv"].copy_(conv)
    jcache = {"h": jnp.asarray(h.numpy()), "conv": jnp.asarray(conv.numpy())}
    for t in range(prompt, prompt + steps):
        out, cache = TR.rglru_decode_step(p, TCFG, torch.from_numpy(u[:, t:t + 1]), cache)
        jout, jcache = JR.rglru_decode_step(tree, JCFG, jnp.asarray(u[:, t:t + 1]), jcache)
        _close(out.numpy(), whole[:, t:t + 1].numpy())
        _close(out.numpy(), jout)
    _close(cache["h"].numpy(), h_all.numpy())
    _close(cache["conv"].numpy(), conv_all.numpy())


@pytest.mark.parametrize("seq", [1, 2, 3, 17, 1024])
def test_scan_matches_reference_associative_scan(seq):
    """The doubling scan against ``jax.lax.associative_scan`` with the
    reference's combine, on gates in the RG-LRU's range (0 < a < 1)."""
    rng = np.random.default_rng(seq)
    a = rng.uniform(0.5, 1.0, (2, seq, 8)).astype(np.float32)
    b = rng.standard_normal((2, seq, 8), dtype=np.float32)

    def combine(left, right):
        return left[0] * right[0], right[0] * left[1] + right[1]

    _, want = jax.lax.associative_scan(combine, (jnp.asarray(a), jnp.asarray(b)), axis=1)
    got = TR._scan(torch.from_numpy(a), torch.from_numpy(b))
    _close(got.numpy(), want)


def test_cache_init_dtypes():
    cache = TR.rglru_cache_init(TCFG, 3, torch.bfloat16, device="cpu")
    want = JR.rglru_cache_init(JCFG, 3, jnp.bfloat16)
    assert cache["h"].dtype == torch.float32 and cache["conv"].dtype == torch.bfloat16
    assert cache["h"].shape == want["h"].shape and cache["conv"].shape == want["conv"].shape


def test_init_keeps_gate_parameters_in_float32():
    p = TR.rglru_init(torch.Generator().manual_seed(0), TCFG, torch.bfloat16, "cpu")
    want = JR.rglru_init(jax.random.PRNGKey(0), JCFG, jnp.bfloat16)
    assert {n: (tuple(t.shape), str(t.dtype).split(".")[1]) for n, t in p.items()} == \
        {n: (a.shape, str(a.dtype)) for n, a in want.items()}
    # softplus(lam) spans -log(u)/8 for u in (0.81, 0.998): a^8 in (0.9, 0.999)
    sp = torch.nn.functional.softplus(p["lam"])
    assert float(sp.min()) >= -np.log(0.999 ** 2) / 8 * 0.99
    assert float(sp.max()) <= -np.log(0.9 ** 2) / 8 * 1.01
