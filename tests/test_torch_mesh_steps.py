"""The port's mesh path on a world of one, in this process, on the CPU.

A gloo process group of one rank (``launch.mesh.init_world_of_one``: a
``HashStore``, no TCP port) and a (1, 1) ("data", "model") mesh, set up
and torn down by a module fixture.  ``launch.steps.build_cell`` trains,
prefills and decodes the reduced qwen2-0.5b, mamba2-130m and
recurrentgemma-2b on it, in float32:

* bit-equal (``torch.equal``) to the port's one-device path on the same
  weights: losses, every parameter and moment after the steps, logits and
  caches, under ``default`` and ``fsdp`` and every ``cfg.remat`` policy;
* within the tolerances of ``tests/test_torch_training.py`` and
  ``tests/test_torch_lm.py`` of the JAX package's own ``build_cell`` on a
  (1, 1) mesh with Auto axes (jax 0.9's ``make_mesh`` defaults to Explicit
  axes, under which the reference's ``with_sharding_constraint`` raises):
  losses rtol 1e-5 (the first, against ``loss_fn``) and 1e-4 (two steps),
  logits and caches rtol/atol 1e-4.  The reference's plain loss is taken
  before its step runs, because the step donates its inputs.

Weights come from the reference's ``init_params`` as numpy (norm scales
and biases perturbed, as in ``test_torch_training.py``) and reach the port
through ``params_from_numpy``; batches from ``SyntheticLM``.
"""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AxisType

from repro.configs.base import ShapeSpec as JaxShapeSpec
from repro.launch import steps as jax_steps
from repro.models import model as JM
from repro.training import optimizer as jax_opt
from repro_torch.configs.base import ShapeSpec, get_config
from repro_torch.launch import train as train_cli
from repro_torch.launch.mesh import init_world_of_one, make_test_mesh
from repro_torch.launch.steps import TensorSpec, build_cell, place
from repro_torch.models import model as TM
from repro_torch.training import optimizer as opt
from repro_torch.training.checkpoint import latest_step
from repro_torch.training.train_loop import batch_to
from tests.test_torch_training import JAX_OPT, OPT, _cfgs, _data, _tree

ARCHS = ["qwen2-0.5b", "mamba2-130m", "recurrentgemma-2b"]
B, S = 4, 32


@pytest.fixture(scope="module")
def mesh():
    owned = not dist.is_initialized()
    init_world_of_one("cpu")
    yield make_test_mesh((1, 1), device_type="cpu")
    if owned:
        dist.destroy_process_group()


def _full(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _params(tcfg, tree):
    params = TM.params_from_numpy(tcfg, tree, device="cpu")
    params.requires_grad_(True)
    return params


def _one_device_train(tcfg, tree, batches, n_micro=1):
    step_fn, _ = build_cell(tcfg, ShapeSpec("t", S, B, "train"), None, device="cpu",
                            opt_cfg=OPT, n_microbatches=n_micro)
    params = _params(tcfg, tree)
    state = opt.init_opt_state(params)
    losses = []
    for b in batches:
        params, state, m = step_fn(params, state, b)
        losses.append(float(m["loss"]))
    return losses, params, state


def _mesh_train(tcfg, tree, batches, mesh, policy, n_micro=1):
    step_fn, (pspec, ospec, bspec), rules = build_cell(
        tcfg, ShapeSpec("t", S, B, "train"), mesh, policy, opt_cfg=OPT,
        n_microbatches=n_micro)
    params = _params(tcfg, tree)
    state = place(opt.init_opt_state(params), ospec, mesh)
    params = place(params, pspec, mesh)
    losses = []
    for b in batches:
        params, state, m = step_fn(params, state, place(b, bspec, mesh))
        assert not hasattr(m["loss"], "placements")          # plain metrics
        losses.append(float(m["loss"]))
    return losses, params, state


def _batches(tcfg, n, seed=3):
    data = _data(tcfg, S, B, seed)
    return [batch_to(data.batch_at(i), "cpu") for i in range(n)]


# -- training ------------------------------------------------------------------------

TRAIN_CASES = [pytest.param(arch, policy, 1, id=f"{arch}-{policy}")
               for arch in ARCHS for policy in ("default", "fsdp")]
TRAIN_CASES.append(pytest.param("qwen2-0.5b", "default", 2, id="qwen2-0.5b-2micro"))


@pytest.mark.parametrize("arch,policy,n_micro", TRAIN_CASES)
def test_build_cell_train_is_bit_equal_to_one_device(mesh, arch, policy, n_micro):
    jcfg, tcfg = _cfgs(arch)
    tree = _tree(jcfg)
    batches = _batches(tcfg, 2)
    want_l, want_p, want_s = _one_device_train(tcfg, tree, batches, n_micro)
    got_l, got_p, got_s = _mesh_train(tcfg, tree, batches, mesh, policy, n_micro)
    assert got_l == want_l
    for (name, a), b in zip(want_p.named_parameters(), got_p.parameters()):
        assert torch.equal(a, _full(b)), name
    for moments_a, moments_b in ((want_s.mu, got_s.mu), (want_s.nu, got_s.nu)):
        for name, a in moments_a.items():
            assert torch.equal(a, _full(moments_b[name])), name
    assert torch.equal(want_s.step, got_s.step)


@pytest.mark.parametrize("arch", ARCHS)
def test_build_cell_train_matches_the_references_build_cell(mesh, arch):
    jcfg, tcfg = _cfgs(arch)
    tree = _tree(jcfg)
    batches = _batches(tcfg, 2)
    jmesh = jax.make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    with jmesh:
        step, _, _ = jax_steps.build_cell(jcfg, JaxShapeSpec("t", S, B, "train"), jmesh,
                                          opt_cfg=JAX_OPT)
        params = jax.tree.map(jnp.asarray, tree)
        plain = float(JM.loss_fn(params, jcfg, {"tokens": jnp.asarray(batches[0]["tokens"])}))
        state = jax_opt.init_opt_state(params)
        want = []
        for b in batches:
            params, state, m = step(params, state, {k: jnp.asarray(v.numpy())
                                                    for k, v in b.items()})
            want.append(float(m["loss"]))
    got, _, _ = _mesh_train(tcfg, tree, batches, mesh, "default")
    np.testing.assert_allclose(got[0], plain, rtol=1e-5)
    np.testing.assert_allclose(got, want, rtol=1e-4)


@pytest.mark.parametrize("remat", ["none", "dots", "full"])
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "mamba2-130m"])
def test_every_remat_policy_gives_the_same_bits_under_a_mesh(mesh, arch, remat):
    jcfg, tcfg = _cfgs(arch, remat=remat)
    tree = _tree(jcfg)
    batches = _batches(tcfg, 2)
    _, base_cfg = _cfgs(arch, remat="full")
    want_l, want_p, _ = _one_device_train(base_cfg, tree, batches)
    got_l, got_p, _ = _mesh_train(tcfg, tree, batches, mesh, "default")
    assert got_l == want_l
    for a, b in zip(want_p.parameters(), got_p.parameters()):
        assert torch.equal(a, _full(b))


# -- serving -------------------------------------------------------------------------

def _serve(tcfg, tree, tokens, mesh, n_decode, policy="default"):
    """Prefill ``tokens`` into caches of S + n_decode slots, then greedy
    decode steps (on ``mesh`` under ``policy``): (every logits, the
    caches)."""
    shape = ShapeSpec("p", tokens.shape[1], B, "prefill")
    dshape = ShapeSpec("d", tokens.shape[1] + n_decode, B, "decode")
    params = _params(tcfg, tree)
    with torch.no_grad():
        if mesh is None:
            prefill, _ = build_cell(tcfg, shape, None, device="cpu", cache_len=dshape.seq_len)
            decode, _ = build_cell(tcfg, dshape, None, device="cpu")
            put = lambda t, spec: t  # noqa: E731
        else:
            prefill, (pspec, bspec), _ = build_cell(tcfg, shape, mesh, policy,
                                                    cache_len=dshape.seq_len)
            decode, (_, cspec, tspec), _ = build_cell(tcfg, dshape, mesh, policy)
            params = place(params, pspec, mesh)
            put = lambda t, spec: place(t, spec, mesh)  # noqa: E731
        logits, caches = prefill(params, put({"tokens": tokens}, None if mesh is None
                                             else bspec))
        out = [_full(logits)]
        tok = out[-1].argmax(-1).int()
        for i in range(n_decode):
            logits, caches = decode(params, caches, put(tok, None if mesh is None else tspec),
                                    tokens.shape[1] + i)
            out.append(_full(logits))
            tok = out[-1].argmax(-1).int()
    return out, [{k: _full(v) for k, v in c.items()} for c in caches]


@pytest.mark.parametrize("arch", ARCHS)
def test_build_cell_prefill_and_decode_are_bit_equal_to_one_device(mesh, arch):
    jcfg, tcfg = _cfgs(arch)
    tree = _tree(jcfg)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, tcfg.vocab_size, (B, 16), dtype=np.int32))
    want_l, want_c = _serve(tcfg, tree, tokens, None, 4)
    got_l, got_c = _serve(tcfg, tree, tokens, mesh, 4)
    assert all(torch.equal(a, b) for a, b in zip(want_l, got_l))
    for a, b in zip(want_c, got_c):
        assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("arch", ARCHS)
def test_build_cell_prefill_and_decode_match_the_references_build_cell(mesh, arch):
    """The reference's prefill fills a cache of the prompt's length, so the
    decode steps start from empty caches on both sides."""
    jcfg, tcfg = _cfgs(arch)
    tree = _tree(jcfg)
    rng = np.random.default_rng(2)
    prompt = rng.integers(0, tcfg.vocab_size, (B, 16), dtype=np.int32)
    toks = rng.integers(0, tcfg.vocab_size, (3, B), dtype=np.int32)
    jmesh = jax.make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    with jmesh:
        params = jax.tree.map(jnp.asarray, tree)
        pf, _, _ = jax_steps.build_cell(jcfg, JaxShapeSpec("p", 16, B, "prefill"), jmesh)
        want_logits, want_caches = pf(params, {"tokens": jnp.asarray(prompt)})
        dec, _, _ = jax_steps.build_cell(jcfg, JaxShapeSpec("d", 8, B, "decode"), jmesh)
        caches = JM.cache_init(jcfg, B, 8)
        want_dec = []
        for i, t in enumerate(toks):
            lg, caches = dec(params, caches, jnp.asarray(t), jnp.int32(i))
            want_dec.append(np.asarray(lg))
    pf, (pspec, bspec), _ = build_cell(tcfg, ShapeSpec("p", 16, B, "prefill"), mesh)
    dec, (_, cspec, tspec), _ = build_cell(tcfg, ShapeSpec("d", 8, B, "decode"), mesh)
    params = place(_params(tcfg, tree), pspec, mesh)
    with torch.no_grad():
        logits, pcaches = pf(params, place({"tokens": torch.from_numpy(prompt)}, bspec, mesh))
        np.testing.assert_allclose(_full(logits).numpy(), np.asarray(want_logits),
                                   rtol=1e-4, atol=1e-4)
        caches = place(TM.cache_init(tcfg, B, 8, device="cpu"), cspec, mesh)
        for i, t in enumerate(toks):
            lg, caches = dec(params, caches, place(torch.from_numpy(t), tspec, mesh), i)
            np.testing.assert_allclose(_full(lg).numpy(), want_dec[i], rtol=1e-4, atol=1e-4)
    want_layers = jax.tree.map(np.asarray, _layers(jcfg, want_caches))
    assert len(want_layers) == len(pcaches) == tcfg.n_layers
    for layer, (w, g) in enumerate(zip(want_layers, pcaches)):
        for k in w:
            np.testing.assert_allclose(_full(g[k]).float().numpy(), w[k].astype(np.float32),
                                       rtol=1e-4, atol=1e-4, err_msg=f"{layer}.{k}")


def _layers(cfg, caches) -> list:
    """The reference's stacked cache tree as one dict a layer."""
    P = len(cfg.block_pattern)
    out = [caches["groups"][f"b{i}_{kind}"] for _ in range(cfg.n_groups)
           for i, kind in enumerate(cfg.block_pattern)]
    out = [{k: v[layer // P] for k, v in c.items()} for layer, c in enumerate(out)]
    return out + list(caches["tail"])


# -- the launcher and the guards -----------------------------------------------------

ARGS = ["--arch", "qwen2-0.5b", "--reduced", "--device", "cpu", "--batch", "4", "--seq", "16",
        "--log-every", "100"]


def test_train_cli_mesh_1x1_equals_the_run_without_a_mesh(mesh):
    plain = train_cli.main(ARGS + ["--steps", "5"])
    meshed = train_cli.main(ARGS + ["--steps", "5", "--mesh", "1x1"])
    assert meshed.losses == plain.losses and meshed.grad_norms == plain.grad_norms
    for a, b in zip(plain.params.parameters(), meshed.params.parameters()):
        assert torch.equal(a, _full(b))
    assert all(hasattr(p, "placements") for p in meshed.params.parameters())


def test_train_cli_mesh_1x1_resumes_bit_exactly(mesh, tmp_path):
    args = ARGS + ["--steps", "8", "--mesh", "1x1"]
    first = train_cli.main(args + ["--ckpt-dir", str(tmp_path / "a"), "--ckpt-every", "3"])
    assert latest_step(str(tmp_path / "a")) == 8
    shutil.copytree(tmp_path / "a" / "step_000000006", tmp_path / "b" / "step_000000006")
    second = train_cli.main(args + ["--ckpt-dir", str(tmp_path / "b")])
    assert second.start == 6 and second.losses == first.losses[6:]
    for a, b in zip(first.params.parameters(), second.params.parameters()):
        assert torch.equal(_full(a), _full(b))


def test_build_cell_refuses_moe_and_the_unported_policies(mesh):
    """What ``build_cell`` still refuses, each as the reference raises it: a
    policy that neither package knows (``KeyError`` from ``make_rules_for``,
    reference ``steps.py:46``) and a mesh that is not a ``DeviceMesh``
    (``TypeError``).  MoE configs and the six policies are all accepted
    now: the MoE config and each policy here build their steps."""
    shape = ShapeSpec("t", S, B, "train")
    granite = get_config("granite-moe-3b-a800m", reduced=True)
    with pytest.raises(KeyError, match="zero3"):
        build_cell(granite, shape, mesh, "zero3")
    with pytest.raises(KeyError, match="zero3"):
        jax_steps.make_rules_for(jax.make_mesh((1, 1), ("data", "model")), B, "zero3")
    with pytest.raises(TypeError, match="DeviceMesh"):
        build_cell(granite, shape, "1x1")
    for policy in ("default", "fsdp", "fsdp_ep", "moe_noseq", "moe_a2a", "decode_kv"):
        step, _, rules = build_cell(granite, shape, mesh, policy)
        assert callable(step) and rules.mesh is mesh


def test_abstract_inputs_carry_placements_and_the_step_checks_them(mesh):
    _, tcfg = _cfgs("qwen2-0.5b")
    step, (pspec, ospec, bspec), rules = build_cell(tcfg, ShapeSpec("t", S, B, "train"), mesh,
                                                    "fsdp", opt_cfg=OPT)
    meta = TM.init_params(tcfg, torch.Generator(), device="meta")
    assert {n: s.shape for n, s in pspec.items()} == {
        n: tuple(p.shape) for n, p in meta.named_parameters()}
    assert all(isinstance(s, TensorSpec) and len(s.placements) == 2 for s in pspec.values())
    assert ospec.step.placements is None and bspec["tokens"].shape == (B, S)
    assert rules.mesh is mesh and rules.table["batch"] == ("data", "model")
    params = _params(tcfg, _tree(_cfgs("qwen2-0.5b")[0]))
    with pytest.raises(ValueError, match="place"):
        step(params, opt.init_opt_state(params), _batches(tcfg, 1)[0])


def test_world_of_one_keeps_its_backend(mesh):
    """A world of gloo stays gloo: a cuda mesh asks for nccl and raises
    (this torch has no nccl, or the group's backend differs); nothing falls
    back to another backend."""
    with pytest.raises(RuntimeError, match="nccl"):
        init_world_of_one("cuda")
    assert init_world_of_one("cpu") == "gloo" and dist.get_world_size() == 1

