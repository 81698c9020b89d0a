"""The port's MoE configs and the MoE and KV-head policies on a world of one.

A gloo process group of one rank and a (1, 1) ("data", "model") mesh
(``tests/test_torch_mesh_steps.py``'s module fixture).  A model axis of one
device takes ``models.moe.apply_moe``'s one-device math on local shards, so
``launch.steps.build_cell`` trains, prefills and decodes the reduced
granite-moe-3b-a800m and qwen3-moe-235b-a22b in float32 under each of the
six policies:

* bit-equal (``torch.equal``) to the port's one-device path on the same
  weights: losses, every parameter and moment after two steps, logits and
  caches;
* within ``tests/test_torch_mesh_steps.py``'s tolerances of the JAX
  package's own ``build_cell`` on a (1, 1) mesh with Auto axes, Granite
  under ``default``, ``fsdp_ep``, ``moe_noseq`` and ``moe_a2a``: the first
  loss rtol 1e-5 against ``loss_fn``, two steps rtol 1e-4.

The multi-rank expert parallelism runs on spawned gloo ranks
(``tests/test_torch_distributed.py``) and in one process against the
reference's shard functions (``tests/test_torch_moe_shards.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.configs.base import ShapeSpec as JaxShapeSpec
from repro.launch import steps as jax_steps
from repro.models import model as JM
from repro.training import optimizer as jax_opt
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch.steps import _MESH_POLICIES, build_cell
from repro_torch.models import attention as attn_mod
from tests.test_torch_mesh_steps import (B, S, _batches, _full, _mesh_train,  # noqa: F401
                                         _one_device_train, _serve, mesh)
from tests.test_torch_training import JAX_OPT, _cfgs, _tree

MOE_ARCHS = ["granite-moe-3b-a800m", "qwen3-moe-235b-a22b"]
MOE_POLICIES = ["default", "fsdp_ep", "moe_noseq", "moe_a2a"]


def test_the_six_policies_are_the_references():
    assert set(_MESH_POLICIES) == {"default", "fsdp", "fsdp_ep", "moe_noseq", "moe_a2a",
                                   "decode_kv"}


@pytest.mark.parametrize("policy", _MESH_POLICIES)
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_train_is_bit_equal_to_one_device(mesh, arch, policy):
    jcfg, tcfg = _cfgs(arch)
    tree = _tree(jcfg)
    batches = _batches(tcfg, 2)
    want_l, want_p, want_s = _one_device_train(tcfg, tree, batches)
    got_l, got_p, got_s = _mesh_train(tcfg, tree, batches, mesh, policy)
    assert got_l == want_l
    for (name, a), b in zip(want_p.named_parameters(), got_p.parameters()):
        assert torch.equal(a, _full(b)), name
    for name, a in want_s.mu.items():
        assert torch.equal(a, _full(got_s.mu[name])), name
        assert torch.equal(want_s.nu[name], _full(got_s.nu[name])), name


@pytest.mark.parametrize("policy", ["default", "decode_kv"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_prefill_and_decode_are_bit_equal_to_one_device(mesh, arch, policy):
    jcfg, tcfg = _cfgs(arch)
    tree = _tree(jcfg)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, tcfg.vocab_size, (B, 16), dtype=np.int32))
    want_l, want_c = _serve(tcfg, tree, tokens, None, 4)
    got_l, got_c = _serve(tcfg, tree, tokens, mesh, 4, policy)
    assert all(torch.equal(a, b) for a, b in zip(want_l, got_l))
    for a, b in zip(want_c, got_c):
        assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("policy", MOE_POLICIES)
def test_granite_train_matches_the_references_build_cell(mesh, policy):
    jcfg, tcfg = _cfgs("granite-moe-3b-a800m")
    tree = _tree(jcfg)
    batches = _batches(tcfg, 2)
    jmesh = jax.make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    with jmesh:
        step, _, _ = jax_steps.build_cell(jcfg, JaxShapeSpec("t", S, B, "train"), jmesh,
                                          policy=policy, opt_cfg=JAX_OPT)
        params = jax.tree.map(jnp.asarray, tree)
        plain = float(JM.loss_fn(params, jcfg, {"tokens": jnp.asarray(batches[0]["tokens"])}))
        state = jax_opt.init_opt_state(params)
        want = []
        for b in batches:
            params, state, m = step(params, state, {k: jnp.asarray(v.numpy())
                                                    for k, v in b.items()})
            want.append(float(m["loss"]))
    got, _, _ = _mesh_train(tcfg, tree, batches, mesh, policy)
    np.testing.assert_allclose(got[0], plain, rtol=1e-5)
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_decode_kv_prefill_gives_k3_positions_0_to_s(mesh, monkeypatch):
    """K3 masks by index, the reference by position: under ``decode_kv`` the
    prefill's attention still gets positions 0..S-1 (``model.prefill``
    builds them; the decode step runs no K3)."""
    _, tcfg = _cfgs("qwen2-0.5b")
    seen = []
    attend = attn_mod.attend

    def spy(p, cfg, x, positions, window=0):
        seen.append(_full(positions).clone())
        return attend(p, cfg, x, positions, window)

    monkeypatch.setattr(attn_mod, "attend", spy)
    tree = _tree(_cfgs("qwen2-0.5b")[0])
    tokens = torch.from_numpy(np.random.default_rng(4).integers(
        0, tcfg.vocab_size, (B, 12), dtype=np.int32))
    _serve(tcfg, tree, tokens, mesh, 2, "decode_kv")
    assert len(seen) == tcfg.n_layers
    assert all(torch.equal(s, torch.arange(12).expand(B, 12)) for s in seen)


def test_build_cell_pads_kv_heads_only_under_decode_kv(monkeypatch):
    """``build_cell`` pads with ``pad_kv`` under ``decode_kv`` alone (the
    reference's ``steps.py:167-168``), on a stand-in mesh of model axis 4."""
    from repro_torch.launch import steps

    class Mesh:
        mesh_dim_names, shape = ("data", "model"), (2, 4)

    got = {}
    monkeypatch.setattr(steps, "build_decode",
                        lambda cfg, shape, mesh, **kw: got.setdefault(kw["policy"], cfg))
    _, tcfg = _cfgs("qwen2-0.5b", n_heads=6, n_kv_heads=2, d_head=16)
    for policy in ("default", "decode_kv"):
        steps.build_cell(tcfg, ShapeSpec("d", 8, 8, "decode"), Mesh(), policy)
    assert (got["default"].heads_p, got["default"].kv_heads_p) == (8, 2)
    assert (got["decode_kv"].heads_p, got["decode_kv"].kv_heads_p) == (12, 4)
