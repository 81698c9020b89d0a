"""The port's MoE layer (the one-device path) against the JAX package's, on the
CPU, on the same weights and inputs (the reference's ``moe_init`` taken to
numpy; inputs drawn in numpy), in float32.

Routing is compared exactly: capacities, the top-k slots and the valid part
of the inverse slot table are ints and must be equal, the normalised gates
within 1e-6.  Inputs are drawn so that no two of a token's top k + 1 gates
tie within 1e-6 (a tie would let the two frameworks pick different experts).
Layer outputs are held within 2e-4 (``tests/test_moe.py``'s tolerance): the
port sums each token's k expert rows in rank order where the reference
scatter-adds them in slot order.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.models import moe as JMoE
from repro_torch.configs.base import get_config
from repro_torch.models import moe as TMoE

ARCH = "qwen3-moe-235b-a22b"          # reduced: 8 experts, top-2 (tests/test_moe.py's)
TOL = 2e-4
JCFG = dataclasses.replace(jax_get_config(ARCH, reduced=True), dtype="float32")
TCFG = dataclasses.replace(get_config(ARCH, reduced=True), dtype="float32")


@pytest.fixture(scope="module")
def params():
    tree = jax.tree.map(np.asarray, JMoE.moe_init(jax.random.PRNGKey(0), JCFG, jnp.float32))
    return tree, {name: torch.from_numpy(np.array(a)) for name, a in tree.items()}


def _x(b, s, seed=1, cfg=JCFG, router=None):
    """0.5 x N(0, 1) tokens whose top k + 1 gates are at least 1e-6 apart."""
    x = 0.5 * np.random.default_rng(seed).standard_normal((b, s, cfg.d_model), dtype=np.float32)
    if router is not None:
        gates = np.asarray(jax.nn.softmax(jnp.asarray(x) @ router, axis=-1))
        top = -np.sort(-gates, axis=-1)[..., :cfg.experts_per_token + 1]
        assert np.diff(-top, axis=-1).min() > 1e-6, "draw has a near tie"
    return x


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "granite-moe-3b-a800m"])
@pytest.mark.parametrize("small", [False, True], ids=["published", "reduced"])
def test_capacity_equals_reference_for_every_length(arch, small):
    jcfg, tcfg = jax_get_config(arch, reduced=small), get_config(arch, reduced=small)
    want = [JMoE.moe_capacity(jcfg, s) for s in range(1, 4097)]
    assert [TMoE.moe_capacity(tcfg, s) for s in range(1, 4097)] == want
    assert TMoE.moe_capacity(tcfg, 1) == tcfg.experts_per_token


@pytest.mark.parametrize("s,capacity", [(16, 8), (24, 3), (1, 2), (64, 4)])
def test_route_equals_reference(params, s, capacity):
    tree, p = params
    x = _x(2, s, seed=s, router=tree["router"])
    gk, slot, table, gates = JMoE._route(JCFG, jnp.asarray(x), jnp.asarray(tree["router"]),
                                         capacity)
    tgk, tslot, ttable, tgates = TMoE._route(TCFG, torch.from_numpy(x), p["router"], capacity)
    np.testing.assert_array_equal(tslot.numpy(), np.asarray(slot))
    n = JCFG.n_experts * capacity
    np.testing.assert_array_equal(ttable[:, :n].numpy(), np.asarray(table)[:, :n])
    assert (ttable[:, n] == s).all()                          # the dropped slot holds no token
    _close(tgk.numpy(), gk, 1e-6)
    _close(tgates.numpy(), gates, 1e-6)


@pytest.mark.parametrize("capacity", [16, 4, 2], ids=["ample", "tight", "tighter"])
def test_apply_moe_local_matches_reference(params, capacity):
    tree, p = params
    x = _x(2, 16, router=tree["router"])
    want = JMoE.apply_moe_local(tree, JCFG, jnp.asarray(x), capacity=capacity)
    got = TMoE.apply_moe_local(p, TCFG, torch.from_numpy(x), capacity=capacity)
    assert got.dtype == torch.float32 and got.shape == x.shape
    _close(got.numpy(), want)


@pytest.mark.parametrize("s", [1, 5, 40])
def test_apply_moe_at_its_own_capacity_matches_reference(params, s):
    """``apply_moe`` at ``moe_capacity`` (k a slot an expert at S = 1, the
    decode step)."""
    tree, p = params
    x = _x(3, s, seed=10 + s, router=tree["router"])
    want = JMoE.apply_moe(tree, JCFG, jnp.asarray(x))
    got = TMoE.apply_moe(p, TCFG, torch.from_numpy(x))
    _close(got.numpy(), want)


def test_apply_moe_ref_matches_reference_and_the_local_path(params):
    tree, p = params
    x = _x(2, 16, router=tree["router"])
    want = JMoE.apply_moe_ref(tree, JCFG, jnp.asarray(x))
    got = TMoE.apply_moe_ref(p, TCFG, torch.from_numpy(x))
    _close(got.numpy(), want)
    local = TMoE.apply_moe_local(p, TCFG, torch.from_numpy(x), capacity=16)   # no drops
    _close(local.numpy(), got.numpy())


def test_capacity_drops_reduce_output_norm_not_nan(params):
    _, p = params
    x = torch.from_numpy(_x(2, 32, seed=3))
    tight = TMoE.apply_moe_local(p, TCFG, x, capacity=2)
    ample = TMoE.apply_moe_local(p, TCFG, x, capacity=32)
    assert torch.isfinite(tight).all()
    assert float(tight.norm()) <= float(ample.norm()) + 1e-4


@pytest.mark.parametrize("capacity", [8, 3])
def test_routing_positions_unique_per_expert(params, capacity):
    _, p = params
    x = torch.from_numpy(_x(2, 24, seed=4))
    _, slot, table, _ = TMoE._route(TCFG, x, p["router"], capacity)
    n = TCFG.n_experts * capacity
    for b in range(2):
        kept = slot[b].reshape(-1)
        kept = kept[kept < n]
        assert len(torch.unique(kept)) == len(kept), "slot collision"
        # the table inverts the kept slots, and holds S in every other one
        tokens = torch.arange(24).repeat_interleave(TCFG.experts_per_token)
        flat = slot[b].reshape(-1)
        assert torch.equal(table[b, flat[flat < n]], tokens[flat < n])
        assert int((table[b, :n] < 24).sum()) == len(kept)


@pytest.mark.parametrize("seed", [0, 7, 123, 9_999])
def test_gates_normalized(params, seed):
    _, p = params
    x = torch.from_numpy(_x(1, 8, seed=seed))
    gk, *_ = TMoE._route(TCFG, x, p["router"], 8)
    torch.testing.assert_close(gk.sum(-1), torch.ones(1, 8), rtol=1e-5, atol=1e-5)
    assert (gk >= 0).all()


def test_init_keeps_the_router_in_float32_and_the_reference_layout():
    cfg = get_config(ARCH, reduced=True)
    p = TMoE.moe_init(torch.Generator().manual_seed(0), cfg, torch.bfloat16, "cpu")
    want = JMoE.moe_init(jax.random.PRNGKey(0), jax_get_config(ARCH, reduced=True),
                         jnp.bfloat16)
    assert {n: (tuple(t.shape), str(t.dtype).split(".")[1]) for n, t in p.items()} == \
        {n: (a.shape, str(a.dtype)) for n, a in want.items()}


def test_bf16_layer_is_as_accurate_as_the_references(params):
    """bf16 experts (the router stays f32): the port's output no further
    from the float32 result than 1.5x the reference's bf16 output is."""
    tree, _ = params
    x = _x(2, 16, seed=5, router=tree["router"])
    exact = np.asarray(JMoE.apply_moe_local(tree, JCFG, jnp.asarray(x)))
    tree16 = {n: (a if n == "router" else a.astype(jnp.bfloat16)) for n, a in tree.items()}
    jcfg16 = dataclasses.replace(JCFG, dtype="bfloat16")
    ref = np.asarray(JMoE.apply_moe_local(tree16, jcfg16, jnp.asarray(x, jnp.bfloat16)),
                     np.float32)
    p16 = {n: torch.from_numpy(np.array(a, np.float32)).to(
        torch.float32 if n == "router" else torch.bfloat16) for n, a in tree16.items()}
    got = TMoE.apply_moe_local(p16, dataclasses.replace(TCFG, dtype="bfloat16"),
                               torch.from_numpy(x).bfloat16()).float().numpy()
    assert np.abs(got - exact).max() <= 1.5 * np.abs(ref - exact).max()
