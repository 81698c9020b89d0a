"""The port's expert-parallel shard functions against the JAX package's, in
one process, on the CPU, in float32.

The reference's shard functions run under ``jax.vmap(fn,
axis_name="model")`` (its collectives over the mapped axis, no forced
devices), the port's over the same shards in a loop
(``_moe_core_padded``) or stacked (``_moe_a2a`` with
``stacked_exchange``), on the same weights (the reference's ``moe_init``
taken to numpy) and numpy tokens whose top k + 1 gates are at least 1e-6
apart (no routing tie either framework could break the other way).

* ``_moe_core_padded`` for each ``e_lo`` slice of reduced Granite with 6
  experts padded to 8 on a model axis of 4 (the last slice only padding
  experts), with choices dropped and without;
* the gather / reduce-scatter composition (all-gather the sequence, each
  slice's partial, reduce-scatter) against the reference's and against
  ``apply_moe_local``;
* ``_moe_a2a`` against the reference's at 2 and 4 shards, with drops
  (capacity factor 0.5) and without; without drops it also equals
  ``apply_moe_local``, with them it does not (capacity per source shard);
* the gradients of both compositions against ``jax.grad`` of the
  reference's.

Outputs within 2e-4 (``tests/test_moe.py``'s tolerance: the port sums each
token's rows in rank order, the reference scatter-adds them); gradients
within 1e-4 of the leaf's largest entry plus 1e-6
(``tests/test_torch_training.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.configs.base import pad_for_mesh as jax_pad
from repro.models import moe as JMoE
from repro_torch.configs.base import get_config, pad_for_mesh
from repro_torch.models import moe as TMoE

ARCH = "granite-moe-3b-a800m"         # reduced: d 64, 8 experts top-2
TOL = 2e-4
B, S = 2, 16
EXPERTS = ("w_gate", "w_up", "w_down")


def _cfgs(n, **changes):
    j = jax_pad(dataclasses.replace(jax_get_config(ARCH, reduced=True), dtype="float32",
                                    **changes), n)
    t = pad_for_mesh(dataclasses.replace(get_config(ARCH, reduced=True), dtype="float32",
                                         **changes), n)
    return j, t


def _setup(n, seed=1, **changes):
    """(jax cfg, port cfg, numpy weights, tokens (B, S, d)) with no near tie."""
    jcfg, tcfg = _cfgs(n, **changes)
    tree = jax.tree.map(np.asarray, JMoE.moe_init(jax.random.PRNGKey(0), jcfg, jnp.float32))
    x = 0.5 * np.random.default_rng(seed).standard_normal((B, S, jcfg.d_model),
                                                          dtype=np.float32)
    logits = x.astype(np.float64) @ tree["router"].astype(np.float64)
    logits[..., jcfg.n_experts:] = -np.inf
    gates = np.exp(logits - logits.max(-1, keepdims=True))
    gates /= gates.sum(-1, keepdims=True)
    top = -np.sort(-gates, axis=-1)[..., :jcfg.experts_per_token + 1]
    assert np.diff(-top, axis=-1).min() > 1e-6, "draw has a near tie"
    return jcfg, tcfg, tree, x


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _grads_close(got, want):
    for name in want:
        w, g = np.asarray(want[name]), np.asarray(got[name])
        assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max() + 1e-6, name


def _stack(tree, n):
    """Expert weights (Ep, ...) -> (n, Ep / n, ...): shard m's experts."""
    return {w: tree[w].reshape(n, -1, *tree[w].shape[1:]) for w in EXPERTS}


def _over_shards(shard, tree, x, n):
    """``shard(router, w_gate, w_up, w_down, x_loc)`` jitted under
    ``jax.vmap(axis_name="model")`` over the n sequence and expert shards:
    (B, S, d)."""
    xs = jnp.moveaxis(x.reshape(B, n, S // n, -1), 1, 0)
    st = _stack(tree, n)
    out = jax.jit(jax.vmap(shard, in_axes=(None, 0, 0, 0, 0), axis_name="model"))(
        tree["router"], st["w_gate"], st["w_up"], st["w_down"], xs)
    return jnp.moveaxis(out, 0, 1).reshape(B, S, -1)


def _jax_gather(jcfg, tree, x, n):
    """The reference's gather / reduce-scatter region under vmap over the
    shards: (B, S, d)."""
    e_per, C = jcfg.experts_p // n, JMoE.moe_capacity(jcfg, S)

    def shard(router, wg, wu, wd, x_loc):
        e_lo = jax.lax.axis_index("model") * e_per
        xf = jax.lax.all_gather(x_loc, "model", axis=1, tiled=True)
        p = {"router": router, "w_gate": wg, "w_up": wu, "w_down": wd}
        out = JMoE._moe_core_padded(jcfg, p, xf, C, e_lo, e_per, jcfg.n_experts)
        return jax.lax.psum_scatter(out, "model", scatter_dimension=1, tiled=True)

    return _over_shards(shard, tree, x, n)


def _torch_gather(tcfg, p, x, n):
    """The port's composition: each slice's ``_moe_core_padded`` on the
    whole sequence, the partials summed in shard order."""
    e_per, C = tcfg.experts_p // n, TMoE.moe_capacity(tcfg, S)
    out = 0
    for m in range(n):
        p_loc = {"router": p["router"],
                 **{w: p[w][m * e_per:(m + 1) * e_per] for w in EXPERTS}}
        out = out + TMoE._moe_core_padded(tcfg, p_loc, x, C, m * e_per, e_per,
                                          tcfg.n_experts)
    return out


def _jax_a2a(jcfg, tree, x, n):
    e_per = jcfg.experts_p // n

    def shard(router, wg, wu, wd, x_loc):
        p = {"router": router, "w_gate": wg, "w_up": wu, "w_down": wd}
        return JMoE._moe_a2a(jcfg, p, x_loc, n, e_per)

    return _over_shards(shard, tree, x, n)


def _torch_a2a(tcfg, p, x, n):
    xs = x.view(B, n, S // n, -1).transpose(0, 1)
    out = TMoE._moe_a2a(tcfg, p, xs, n, tcfg.experts_p // n, TMoE.stacked_exchange)
    return out.transpose(0, 1).reshape(B, S, -1)


@pytest.mark.parametrize("cf", [8.0, 0.5], ids=["no-drops", "drops"])
def test_moe_core_padded_equals_the_references_for_each_slice(cf):
    jcfg, tcfg, tree, x = _setup(4, n_experts=6, capacity_factor=cf)
    assert jcfg.experts_p == tcfg.experts_p == 8
    C, e_per = JMoE.moe_capacity(jcfg, S), 2
    for m in range(4):
        loc = {"router": tree["router"],
               **{w: tree[w][m * e_per:(m + 1) * e_per] for w in EXPERTS}}
        want = JMoE._moe_core_padded(jcfg, jax.tree.map(jnp.asarray, loc), jnp.asarray(x), C,
                                     m * e_per, e_per, jcfg.n_experts)
        got = TMoE._moe_core_padded(tcfg, _t(loc), torch.from_numpy(x), C, m * e_per, e_per,
                                    tcfg.n_experts)
        assert got.dtype == torch.float32 and got.shape == (B, S, tcfg.d_model)
        _close(got, want)
        if m == 3:                                 # padding experts only: no token
            assert not got.any()


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("cf", [8.0, 0.5], ids=["no-drops", "drops"])
def test_gather_composition_equals_the_references_and_the_local_path(n, cf):
    jcfg, tcfg, tree, x = _setup(n, n_experts=6, capacity_factor=cf)
    want = _jax_gather(jcfg, tree, jnp.asarray(x), n)
    p = _t(tree)
    got = _torch_gather(tcfg, p, torch.from_numpy(x), n)
    _close(got, want)
    _close(got, TMoE.apply_moe_local(p, tcfg, torch.from_numpy(x)))
    _close(want, JMoE.apply_moe_local(tree, jcfg, jnp.asarray(x)))


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("cf", [8.0, 0.5], ids=["no-drops", "drops"])
def test_a2a_equals_the_references(n, cf):
    jcfg, tcfg, tree, x = _setup(n, capacity_factor=cf)
    want = np.asarray(_jax_a2a(jcfg, tree, jnp.asarray(x), n))
    p = _t(tree)
    got = _torch_a2a(tcfg, p, torch.from_numpy(x), n)
    _close(got, want)
    local = TMoE.apply_moe_local(p, tcfg, torch.from_numpy(x)).numpy()
    if cf == 8.0:
        _close(got, local)                         # no drop: one device's result
    else:
        assert np.abs(got.numpy() - local).max() > 10 * TOL   # per-shard capacity drops


def test_a2a_capacity_is_the_references():
    jcfg, tcfg = _cfgs(4, capacity_factor=0.5)
    for s_loc in (1, 3, 4, 8, 16, 64, 1_000):
        C = max(4, int(np.ceil(s_loc * jcfg.experts_per_token * jcfg.capacity_factor
                               / jcfg.n_experts)))
        assert TMoE.a2a_capacity(tcfg, s_loc) == C


def test_a2a_refuses_shards_that_miss_the_experts():
    _, tcfg, tree, x = _setup(4)
    with pytest.raises(ValueError, match="experts"):
        TMoE._moe_a2a(tcfg, _t(tree), torch.from_numpy(x)[None], 4, 1)


@pytest.mark.parametrize("path", ["gather", "a2a"])
def test_gradients_equal_jax_grad_of_the_references(path):
    n = 4
    jcfg, tcfg, tree, x = _setup(n, capacity_factor=0.5)
    r = np.random.default_rng(9).standard_normal(x.shape).astype(np.float32)
    jfn = _jax_gather if path == "gather" else _jax_a2a
    tfn = _torch_gather if path == "gather" else _torch_a2a

    def jloss(p, x):
        return jnp.sum(jfn(jcfg, p, x, n) * r)

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(jax.tree.map(jnp.asarray, tree), jnp.asarray(x))
    p = {k: v.requires_grad_(True) for k, v in _t(tree).items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    (tfn(tcfg, p, xt, n) * torch.from_numpy(r)).sum().backward()
    _grads_close({**{k: v.grad.numpy() for k, v in p.items()}, "x": xt.grad.numpy()},
                 {**{k: np.asarray(v) for k, v in jg.items()}, "x": np.asarray(jgx)})
