"""The port's local attention (``window > 0``) and its ring-buffer decode cache
against the JAX package's, on the CPU, on the same weights and inputs.

The weights are the reference's ``attention_init`` taken to numpy; inputs are
drawn in numpy.  On the CPU the port's ``attend`` runs the flash-attention
kernel's plain version ``mha_ref`` with the window.  Tolerances are
``tests/test_attention.py``'s: rtol/atol 2e-4 in float32.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JaxModelConfig
from repro.models import attention as JA
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention.ref import mha_ref
from repro_torch.models import attention as TA

TOL = 2e-4


def _cfgs(heads=4, kv=2, dh=16, window=0, chunk=16):
    fields = dict(name="t", family="dense", n_layers=1, d_model=heads * dh, n_heads=heads,
                  n_kv_heads=kv, d_ff=4 * heads * dh, vocab_size=64, d_head=dh,
                  local_window=window, attn_chunk=chunk)
    return JaxModelConfig(**fields), ModelConfig(**fields)


def _params(jcfg, seed=0):
    tree = jax.tree.map(np.asarray, JA.attention_init(jax.random.PRNGKey(seed), jcfg,
                                                      jnp.float32))
    return tree, {name: torch.from_numpy(np.array(a)) for name, a in tree.items()}


def _x(batch, seq, d, seed=1):
    return 0.3 * np.random.default_rng(seed).standard_normal((batch, seq, d), dtype=np.float32)


def _pos(batch, seq):
    return np.broadcast_to(np.arange(seq, dtype=np.int32)[None], (batch, seq))


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("window", [8, 16, 24])
@pytest.mark.parametrize("port_fn", ["attend", "attend_full"])
@pytest.mark.parametrize("ref_fn", ["attend_full", "attend_chunked"])
def test_local_attention_matches_reference(window, port_fn, ref_fn):
    jcfg, tcfg = _cfgs(window=window)
    tree, p = _params(jcfg)
    x, pos = _x(2, 64, jcfg.d_model), _pos(2, 64)
    want, (wk, wv) = getattr(JA, ref_fn)(tree, jcfg, jnp.asarray(x), jnp.asarray(pos), window)
    got, (k, v) = getattr(TA, port_fn)(p, tcfg, torch.from_numpy(x),
                                       torch.from_numpy(pos.copy()).long(), window)
    _close(got.numpy(), want)
    _close(k.numpy(), wk)
    _close(v.numpy(), wv)


@pytest.mark.parametrize("window", [1, 8, 16, 24, 100])
def test_mha_ref_window_matches_reference_attend_full(window):
    """The plain version with a window against the reference's
    ``attend_full``: with ``wo`` the identity (H·Dh = d) the reference's
    output is its attention context, and q, k, v are the port's own
    projections of the same x."""
    jcfg, tcfg = _cfgs(heads=4, kv=1, dh=16)
    tree, p = _params(jcfg)
    eye = np.eye(jcfg.d_model, dtype=np.float32).reshape(4, 16, jcfg.d_model)
    tree = {**tree, "wo": eye}
    B, S = 2, 40
    x, pos = _x(B, S, jcfg.d_model, seed=2), _pos(B, S)
    want, _ = JA.attend_full(tree, jcfg, jnp.asarray(x), jnp.asarray(pos), window)
    q, k, v = TA._project_qkv(p, tcfg, torch.from_numpy(x), torch.from_numpy(pos.copy()).long())
    rows = [t.transpose(1, 2).reshape(-1, S, 16).contiguous() for t in (q, k, v)]
    ctx = mha_ref(*rows, window=window).view(B, 4, S, 16).transpose(1, 2).reshape(B, S, -1)
    _close(ctx.numpy(), want)


@pytest.mark.parametrize("window", [8, 5])
def test_ring_cache_decode_matches_full_sequence_local_attention(window):
    """Token by token through a ring of ``window`` slots against full-sequence
    local attention (the reference's and the port's ``attend_full``) and
    against the reference's ring decode, cache included, at each step."""
    jcfg, tcfg = _cfgs(window=window, chunk=64)
    tree, p = _params(jcfg)
    B, S = 1, 24
    x, pos = _x(B, S, jcfg.d_model), _pos(B, S)
    want, _ = JA.attend_full(tree, jcfg, jnp.asarray(x), jnp.asarray(pos), window)
    cache = TA.init_cache(tcfg, B, window, window=window, dtype=torch.float32, device="cpu")
    jcache = JA.init_cache(jcfg, B, window, window=window, dtype=jnp.float32)
    assert cache["k"].shape == (B, window, tcfg.n_kv_heads, tcfg.head_dim)
    outs = []
    for t in range(S):
        o, cache = TA.decode_step(p, tcfg, torch.from_numpy(x[:, t:t + 1]), cache, t, window)
        jo, jcache = JA.decode_step(tree, jcfg, jnp.asarray(x[:, t:t + 1]), jcache,
                                    jnp.int32(t), window=window)
        _close(o.numpy(), jo)
        _close(cache["k"].numpy(), jcache["k"])
        _close(cache["v"].numpy(), jcache["v"])
        outs.append(o)
    _close(torch.cat(outs, dim=1).numpy(), want)
    full, _ = TA.attend_full(p, tcfg, torch.from_numpy(x), torch.from_numpy(pos.copy()).long(),
                             window)
    _close(torch.cat(outs, dim=1).numpy(), full.numpy())


@pytest.mark.parametrize("prompt", [16, 19, 8, 5])
def test_prefill_into_ring_then_decode_equals_pure_decode(prompt):
    """A prompt as long as the ring (roll 0), longer (roll 3 at 19) and
    shorter than it, then one decode step: the cache equals the reference's
    ``prefill_into_cache`` (the roll by S % S_cache and slot pos % S), and
    the step equals token-by-token decode."""
    W = 8
    jcfg, tcfg = _cfgs(window=W, chunk=8)
    tree, p = _params(jcfg)
    B = 1
    x, pos = _x(B, prompt + 1, jcfg.d_model, seed=3), _pos(B, prompt)
    cache = TA.init_cache(tcfg, B, W, window=W, dtype=torch.float32, device="cpu")
    _, cache = TA.prefill_into_cache(p, tcfg, torch.from_numpy(x[:, :prompt]),
                                     torch.from_numpy(pos.copy()).long(), cache, W)
    jcache = JA.init_cache(jcfg, B, W, window=W, dtype=jnp.float32)
    _, jcache = JA.prefill_into_cache(tree, jcfg, jnp.asarray(x[:, :prompt]), jnp.asarray(pos),
                                      jcache, window=W)
    _close(cache["k"].numpy(), jcache["k"])
    _close(cache["v"].numpy(), jcache["v"])
    got, _ = TA.decode_step(p, tcfg, torch.from_numpy(x[:, prompt:]), cache, prompt, W)
    pure = TA.init_cache(tcfg, B, W, window=W, dtype=torch.float32, device="cpu")
    for t in range(prompt):
        _, pure = TA.decode_step(p, tcfg, torch.from_numpy(x[:, t:t + 1]), pure, t, W)
    want, _ = TA.decode_step(p, tcfg, torch.from_numpy(x[:, prompt:]), pure, prompt, W)
    _close(got.numpy(), want.numpy())
    jwant, _ = JA.decode_step(tree, jcfg, jnp.asarray(x[:, prompt:]), jcache,
                              jnp.int32(prompt), window=W)
    _close(got.numpy(), jwant)


@pytest.mark.parametrize("window,max_seq,slots", [(0, 12, 12), (8, 12, 8), (16, 12, 12)])
def test_init_cache_holds_min_of_window_and_max_seq(window, max_seq, slots):
    jcfg, tcfg = _cfgs(window=window)
    cache = TA.init_cache(tcfg, 2, max_seq, window=window, device="cpu")
    want = JA.init_cache(jcfg, 2, max_seq, window=window)
    assert cache["k"].shape == cache["v"].shape == tuple(want["k"].shape)
    assert cache["k"].shape[1] == slots and cache["k"].dtype == torch.bfloat16


def test_window_longer_than_the_prompt_is_causal_attention():
    jcfg, tcfg = _cfgs()
    _, p = _params(jcfg)
    x = torch.from_numpy(_x(2, 30, jcfg.d_model))
    pos = torch.arange(30)[None].expand(2, 30)
    causal, _ = TA.attend(p, tcfg, x, pos)
    wide, _ = TA.attend(p, dataclasses.replace(tcfg, local_window=64), x, pos, 64)
    assert torch.equal(causal, wide)
