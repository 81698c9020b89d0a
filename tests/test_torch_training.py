"""The port's training slice on the CPU against the JAX package's, at reduced
size: the data pipeline, ``loss_fn`` and its gradients, AdamW, train steps,
checkpoints, ``launch.steps.build_train`` and ``launch.train``; and the
twins of ``tests/test_training.py``.

Inputs are made with numpy from a seed and handed to both packages: the
reference's parameters are drawn by ``repro.models.model.init_params``,
taken to numpy with norm scales and biases perturbed away from their 1/0
init, and carried to the port by ``params_from_numpy``.  Tolerances, all in
float32: ``loss_fn`` rtol 1e-5; each gradient leaf max|Δ| <= 1e-4·max|g_ref|
+ 1e-6 (the two packages sum in other orders through the layers);
``adamw_step`` rtol 1e-6 with atol 1e-6 of each leaf's largest entry (a
moment may cancel to near 0); ``lr_schedule`` equal; five train steps'
losses rtol 1e-4.
"""

import dataclasses
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import reduced as jax_reduced
from repro.data import pipeline as jax_pipeline
from repro.models import model as JM
from repro.training import optimizer as jax_opt
from repro.training.train_loop import make_train_step as jax_make_train_step
from repro_torch.configs.base import ShapeSpec, get_config, reduced
from repro_torch.data.pipeline import FileCorpus, SyntheticLM
from repro_torch.launch import train as train_cli
from repro_torch.launch.steps import build_train
from repro_torch.models import model as TM
from repro_torch.training import optimizer as opt
from repro_torch.training.checkpoint import (CheckpointManager, latest_step,
                                             restore_checkpoint, save_checkpoint)
from repro_torch.training.train_loop import batch_to, make_eval_step, make_train_step

PERTURBED = ("scale", "bias", "bq", "bk", "bv", "b_a", "b_i", "conv_b")
OPT = opt.OptimizerConfig(lr=1e-2, warmup_steps=2, decay_steps=100)
JAX_OPT = jax_opt.OptimizerConfig(lr=1e-2, warmup_steps=2, decay_steps=100)


# -- helpers -----------------------------------------------------------------------

def _cfgs(arch, dtype="float32", **changes):
    return (dataclasses.replace(jax_reduced(arch), dtype=dtype, **changes),
            dataclasses.replace(reduced(arch), dtype=dtype, **changes))


def _tree(jcfg, seed=0):
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(np.asarray, JM.init_params(jax.random.PRNGKey(seed), jcfg))

    def perturb(path, a):
        if path[-1].key in PERTURBED:
            return (a.astype(np.float32) + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(perturb, tree)


def _setup(arch, seed=0, **changes):
    jcfg, tcfg = _cfgs(arch, **changes)
    tree = _tree(jcfg, seed)
    params = TM.params_from_numpy(tcfg, tree, device="cpu")
    params.requires_grad_(True)
    return jcfg, tcfg, tree, params


def _data(cfg, seq, batch, seed):
    return SyntheticLM(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch, seed=seed,
                       n_prefix=cfg.n_prefix if cfg.frontend else 0,
                       d_model=cfg.d_model if cfg.frontend else 0)


def _to_port(tree, cfg) -> dict:
    """The reference's tree of arrays as the port's ``{name: array}``."""
    P = len(cfg.block_pattern)
    out = {f"{top}.{k}": a for top in ("embedding", "final_norm") for k, a in tree[top].items()}
    for i, kind in enumerate(cfg.block_pattern):
        for grp, leaves in tree["stack"]["groups"][f"b{i}_{kind}"].items():
            for name, a in leaves.items():
                for g in range(cfg.n_groups):
                    out[f"stack.{g * P + i}.{grp}.{name}"] = a[g]
    for i, blk in enumerate(tree["stack"]["tail"]):
        for grp, leaves in blk.items():
            for name, a in leaves.items():
                out[f"stack.{cfg.n_groups * P + i}.{grp}.{name}"] = a
    return out


def _from_port(tree, cfg, named: dict):
    """The port's ``{name: array}`` in the reference tree's structure (its
    group layers stacked on a leading axis)."""
    P = len(cfg.block_pattern)
    base = cfg.n_groups * P
    return {
        "embedding": {k: named[f"embedding.{k}"] for k in tree["embedding"]},
        "final_norm": {k: named[f"final_norm.{k}"] for k in tree["final_norm"]},
        "stack": {
            "groups": {f"b{i}_{kind}": {
                grp: {name: np.stack([named[f"stack.{g * P + i}.{grp}.{name}"]
                                      for g in range(cfg.n_groups)]) for name in leaves}
                for grp, leaves in tree["stack"]["groups"][f"b{i}_{kind}"].items()}
                for i, kind in enumerate(cfg.block_pattern)},
            "tail": [{grp: {name: named[f"stack.{base + i}.{grp}.{name}"] for name in leaves}
                      for grp, leaves in blk.items()}
                     for i, blk in enumerate(tree["stack"]["tail"])]}}


def _numpy(named: dict) -> dict:
    return {n: t.detach().float().numpy() for n, t in named.items()}


def _close_leaves(got_tree, want_tree, rtol, atol_share):
    for (path, want), got in zip(jax.tree_util.tree_flatten_with_path(want_tree)[0],
                                 jax.tree.leaves(got_tree)):
        want = np.asarray(want, np.float32)
        np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=rtol,
                                   atol=atol_share * np.abs(want).max(),
                                   err_msg=jax.tree_util.keystr(path))


# -- data ----------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(vocab_size=128, seq_len=32, global_batch=4, seed=3),
    dict(vocab_size=151_936, seq_len=100, global_batch=8, seed=0),
    dict(vocab_size=128, seq_len=16, global_batch=8, seed=2, shard=1, n_shards=2),
    dict(vocab_size=128, seq_len=24, global_batch=2, seed=5, n_prefix=4, d_model=64)],
    ids=["small", "qwen2-vocab", "shard", "frontend"])
def test_synthetic_batches_bit_equal_to_the_reference(kw):
    ours, ref = SyntheticLM(**kw), jax_pipeline.SyntheticLM(**kw)
    for step in (0, 1, 7, 1000):
        a, b = ours.batch_at(step), ref.batch_at(step)
        assert a.keys() == b.keys()
        for key in a:
            assert a[key].dtype == b[key].dtype
            np.testing.assert_array_equal(a[key], b[key])


def test_file_corpus_batches_bit_equal_to_the_reference(tmp_path):
    path = tmp_path / "tokens.npy"
    np.save(path, np.random.default_rng(0).integers(0, 1000, 5_000).astype(np.int32))
    for shard in (0, 1):
        ours = FileCorpus(str(path), seq_len=64, global_batch=8, shard=shard, n_shards=2)
        ref = jax_pipeline.FileCorpus(str(path), seq_len=64, global_batch=8, shard=shard,
                                      n_shards=2)
        for step in (0, 3, 40):
            np.testing.assert_array_equal(ours.batch_at(step)["tokens"],
                                          ref.batch_at(step)["tokens"])


def test_data_determinism_and_sharding():
    a = SyntheticLM(vocab_size=100, seq_len=16, global_batch=8, seed=2)
    b = SyntheticLM(vocab_size=100, seq_len=16, global_batch=8, seed=2)
    np.testing.assert_array_equal(a.batch_at(5)["tokens"], b.batch_at(5)["tokens"])
    s0 = SyntheticLM(vocab_size=100, seq_len=16, global_batch=8, seed=2, shard=0, n_shards=2)
    s1 = SyntheticLM(vocab_size=100, seq_len=16, global_batch=8, seed=2, shard=1, n_shards=2)
    assert s0.batch_at(0)["tokens"].shape == (4, 16)
    assert not np.array_equal(s0.batch_at(0)["tokens"], s1.batch_at(0)["tokens"])


# -- loss and gradients -------------------------------------------------------------

LOSS_CASES = [("qwen2-0.5b", {}), ("internvl2-1b", {}), ("granite-moe-3b-a800m", {}),
              ("recurrentgemma-2b", {}), ("qwen2-0.5b", {"loss_chunk": 8})]


@pytest.mark.parametrize("arch,changes", LOSS_CASES,
                         ids=[a + ("-loss_chunk" if c else "") for a, c in LOSS_CASES])
def test_loss_matches_the_reference(arch, changes):
    jcfg, tcfg, tree, params = _setup(arch, **changes)
    batch = _data(tcfg, 33, 2, seed=1).batch_at(0)      # S - 1 = 32: four chunks of 8
    if tcfg.frontend:
        assert "embeds" in batch and tcfg.n_prefix > 0   # and the prefix mask bites
    want = JM.loss_fn(jax.tree.map(jnp.asarray, tree), jcfg, jax.tree.map(jnp.asarray, batch))
    got = TM.loss_fn(params, tcfg, batch_to(batch, "cpu"))
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    assert float(make_eval_step(tcfg)(params, batch_to(batch, "cpu"))) == float(got.detach())


def test_loss_chunk_equals_the_unchunked_loss():
    _, tcfg, tree, params = _setup("qwen2-0.5b")
    chunked = dataclasses.replace(tcfg, loss_chunk=8)
    batch = batch_to(_data(tcfg, 33, 2, seed=4).batch_at(0), "cpu")
    torch.testing.assert_close(TM.loss_fn(params, chunked, batch),
                               TM.loss_fn(params, tcfg, batch), rtol=1e-6, atol=0)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "internvl2-1b", "mamba2-130m"])
def test_gradients_match_jax_grad_of_the_reference(arch):
    jcfg, tcfg, tree, params = _setup(arch)
    batch = _data(tcfg, 32, 2, seed=2).batch_at(0)
    want = jax.grad(JM.loss_fn)(jax.tree.map(jnp.asarray, tree), jcfg,
                                jax.tree.map(jnp.asarray, batch))
    named = dict(params.named_parameters())
    loss = TM.loss_fn(params, tcfg, batch_to(batch, "cpu"))
    grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
    got = _from_port(tree, tcfg, _numpy(grads))
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                            jax.tree.leaves(got)):
        w = np.asarray(w, np.float32)
        err = np.abs(np.asarray(g, np.float32) - w).max()
        assert err <= 1e-4 * np.abs(w).max() + 1e-6, (jax.tree_util.keystr(path), err)


# -- optimizer ----------------------------------------------------------------------

def test_lr_schedule_equals_the_reference():
    for cfg in (opt.OptimizerConfig(lr=1.0, warmup_steps=10, decay_steps=100),
                opt.OptimizerConfig(lr=3e-3, warmup_steps=3, decay_steps=30)):
        jcfg = jax_opt.OptimizerConfig(**dataclasses.asdict(cfg))
        for s in (0, 1, 2, 3, 5, 10, 11, 29, 50, 99, 100, 1000):
            got = float(opt.lr_schedule(cfg, torch.tensor(s, dtype=torch.int32)))
            assert got == float(jax_opt.lr_schedule(jcfg, jnp.asarray(s, jnp.int32))), (cfg, s)


def test_lr_schedule_shape():
    cfg = opt.OptimizerConfig(lr=1.0, warmup_steps=10, decay_steps=100, min_lr_ratio=0.1)
    lrs = [float(opt.lr_schedule(cfg, torch.tensor(s))) for s in [0, 5, 10, 50, 100, 1000]]
    assert lrs[0] == 0.0
    assert lrs[1] == pytest.approx(0.5)
    assert lrs[2] == pytest.approx(1.0)
    assert lrs[3] < lrs[2]
    assert lrs[-1] == pytest.approx(0.1, rel=1e-3)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "recurrentgemma-2b"])
def test_adamw_step_matches_the_reference(arch):
    """Same params, gradients and (nonzero) state; the reference decays its
    stacked group layers' norm scales, and so must the port."""
    jcfg, tcfg, tree, params = _setup(arch)
    rng = np.random.default_rng(7)
    like = lambda a, s=1.0: (s * rng.standard_normal(a.shape)).astype(np.float32)  # noqa: E731
    grads = jax.tree.map(lambda a: like(a, 0.3), tree)
    mu = jax.tree.map(lambda a: like(a, 0.01), tree)
    nu = jax.tree.map(lambda a: np.abs(like(a, 0.01)), tree)
    j = jnp.asarray
    want_p, want_s, want_m = jax_opt.adamw_step(
        jax.tree.map(j, tree), jax.tree.map(j, grads),
        jax_opt.OptState(step=jnp.asarray(4, jnp.int32), mu=jax.tree.map(j, mu),
                         nu=jax.tree.map(j, nu)), JAX_OPT)
    t = lambda d: {n: torch.from_numpy(np.array(a)) for n, a in _to_port(d, tcfg).items()}  # noqa: E731
    state = opt.OptState(step=torch.tensor(4, dtype=torch.int32), mu=t(mu), nu=t(nu))
    _, got_s, got_m = opt.adamw_step(params, t(grads), state, OPT, opt.decay_names(tcfg, params))
    assert int(got_s.step) == 5
    for key in ("grad_norm", "lr", "param_norm"):
        np.testing.assert_allclose(float(got_m[key]), float(want_m[key]), rtol=1e-6)
    for got, want in ((_numpy(dict(params.named_parameters())), want_p),
                      (_numpy(got_s.mu), want_s.mu), (_numpy(got_s.nu), want_s.nu)):
        _close_leaves(_from_port(tree, tcfg, got), want, 1e-6, 1e-6)


def test_decay_names_follow_the_references_stacked_layout():
    _, tcfg, _, params = _setup("recurrentgemma-2b")
    names = opt.decay_names(tcfg, params)
    stacked = tcfg.n_groups * len(tcfg.block_pattern)
    assert "stack.0.norm1.scale" in names                      # a group layer: decays
    assert f"stack.{stacked}.norm1.scale" not in names          # a tail layer's norm
    assert f"stack.{stacked}.ffn.w_up" in names and "final_norm.scale" not in names


def test_optimizer_clips_gradients():
    _, tcfg, _, params = _setup("qwen2-0.5b")
    big = {n: torch.full(p.shape, 1e6) for n, p in params.named_parameters()}
    _, _, metrics = opt.adamw_step(params, big, opt.init_opt_state(params), OPT,
                                   opt.decay_names(tcfg, params))
    assert float(metrics["grad_norm"]) > 1e6                  # raw norm reported


# -- train steps ----------------------------------------------------------------------

def _jax_steps(jcfg, tree, data, n, n_micro=1):
    step_fn = jax.jit(jax_make_train_step(jcfg, JAX_OPT, n_micro))
    p = jax.tree.map(jnp.asarray, tree)
    s = jax_opt.init_opt_state(p)
    losses = []
    for step in range(n):
        p, s, m = step_fn(p, s, jax.tree.map(jnp.asarray, data.batch_at(step)))
        losses.append(float(m["loss"]))
    return losses


def _steps(tcfg, params, data, n, n_micro=1, start=0, state=None):
    step_fn = make_train_step(tcfg, OPT, n_micro)
    state = opt.init_opt_state(params) if state is None else state
    losses = []
    for step in range(start, start + n):
        params, state, m = step_fn(params, state, batch_to(data.batch_at(step), "cpu"))
        losses.append(float(m["loss"]))
    return losses, state


@pytest.mark.parametrize("n_micro", [1, 2])
def test_five_train_steps_match_the_reference(n_micro):
    jcfg, tcfg, tree, params = _setup("qwen2-0.5b")
    data = _data(tcfg, 32, 4, seed=3)
    want = _jax_steps(jcfg, tree, data, 5, n_micro)
    got, _ = _steps(tcfg, params, data, 5, n_micro)
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_loss_decreases_over_steps():
    cfg = get_config("qwen2-0.5b", reduced=True)
    params = TM.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    params.requires_grad_(True)
    data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4, seed=3)
    losses, _ = _steps(cfg, params, data, 30)
    assert losses[-1] < losses[0] - 0.5, losses[:3] + losses[-3:]
    assert all(np.isfinite(losses))


def test_grad_accumulation_matches_full_batch():
    cfg = get_config("qwen2-0.5b", reduced=True)
    data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=16, global_batch=8, seed=1)
    batch = batch_to(data.batch_at(0), "cpu")
    out = []
    for n_micro in (1, 4):
        params = TM.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
        params.requires_grad_(True)
        _, _, m = make_train_step(cfg, OPT, n_micro)(params, opt.init_opt_state(params), batch)
        out.append((float(m["loss"]), {n: p.detach().float() for n, p in params.named_parameters()}))
    np.testing.assert_allclose(out[0][0], out[1][0], rtol=1e-5)
    assert max(float((out[0][1][n] - out[1][1][n]).abs().max()) for n in out[0][1]) < 5e-2


def test_train_step_refuses_frozen_parameters():
    cfg = get_config("qwen2-0.5b", reduced=True)
    params = TM.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert not any(p.requires_grad for p in params.parameters())     # serving's default
    batch = batch_to(SyntheticLM(cfg.vocab_size, 16, 2).batch_at(0), "cpu")
    with pytest.raises(ValueError, match="requires_grad_"):
        make_train_step(cfg, OPT)(params, opt.init_opt_state(params), batch)


# -- checkpoints ----------------------------------------------------------------------

def _state(seed=0):
    cfg = get_config("qwen2-0.5b", reduced=True)
    params = TM.init_params(cfg, torch.Generator().manual_seed(seed), device="cpu")
    params.requires_grad_(True)
    return cfg, params, opt.init_opt_state(params)


def test_checkpoint_roundtrip(tmp_path):
    cfg, params, state = _state()
    _, state = _steps(cfg, params, SyntheticLM(cfg.vocab_size, 16, 2, seed=1), 2, state=state)
    tree = {"params": params, "opt": state}
    path = save_checkpoint(str(tmp_path), 7, tree)
    assert latest_step(str(tmp_path)) == 7
    assert sorted(os.listdir(path)) == ["arrays.npz", "manifest.json"]
    with np.load(os.path.join(path, "arrays.npz")) as data:
        assert data["params/embedding.tokens"].dtype == np.uint16        # bf16 as raw bits
        assert data["opt/mu/stack.0.attn.wq"].dtype == np.float32
    _, fresh, fresh_state = _state(seed=1)
    restored, step = restore_checkpoint(str(tmp_path), {"params": fresh, "opt": fresh_state})
    assert step == 7 and restored["params"] is fresh
    for (na, a), (nb, b) in zip(tree["params"].state_dict().items(), fresh.state_dict().items()):
        assert na == nb and a.dtype == b.dtype and torch.equal(a, b)
    assert int(fresh_state.step) == 2
    for n in state.mu:
        assert torch.equal(state.mu[n], fresh_state.mu[n])
        assert torch.equal(state.nu[n], fresh_state.nu[n])


def test_checkpoint_restart_bit_exact(tmp_path):
    """Train 6 steps straight vs 3 + checkpoint/restore + 3: identical."""
    cfg, p_straight, s_straight = _state(9)
    data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=16, global_batch=2, seed=5)
    straight, _ = _steps(cfg, p_straight, data, 6, state=s_straight)

    _, p1, s1 = _state(9)
    first, s1 = _steps(cfg, p1, data, 3, state=s1)
    save_checkpoint(str(tmp_path), 3, {"params": p1, "opt": s1})
    _, p2, s2 = _state(1)
    restore_checkpoint(str(tmp_path), {"params": p2, "opt": s2})
    second, _ = _steps(cfg, p2, data, 3, start=3, state=s2)
    assert first + second == straight
    for a, b in zip(p_straight.parameters(), p2.parameters()):
        assert torch.equal(a, b)


def test_checkpoint_manager_async_and_retention(tmp_path):
    _, params, _ = _state()
    mgr = CheckpointManager(str(tmp_path), keep=2, async_write=True)
    for s in [1, 2, 3, 4]:
        with torch.no_grad():
            params["final_norm"]["scale"].fill_(float(s))   # after save: the snapshot holds
        mgr.save(s, {"p": params})
    with torch.no_grad():
        params["final_norm"]["scale"].fill_(99.0)
    mgr.wait()
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert steps == [3, 4]
    restored, step = mgr.restore_latest({"p": params})
    assert step == 4 and float(params["final_norm"]["scale"][0].detach()) == 4.0


def test_checkpoint_atomicity_no_tmp_left(tmp_path):
    _, params, _ = _state()
    save_checkpoint(str(tmp_path), 1, {"p": params})
    assert not any(d.endswith(".tmp") for d in os.listdir(tmp_path))


def test_restore_refuses_a_missing_leaf_or_another_shape(tmp_path):
    _, params, _ = _state()
    save_checkpoint(str(tmp_path), 1, {"p": params})
    with pytest.raises(KeyError, match="missing leaf"):
        restore_checkpoint(str(tmp_path), {"q": params})
    with pytest.raises(ValueError, match="shape"):
        restore_checkpoint(str(tmp_path), {"p": {"embedding.tokens": torch.zeros(3)}})


# -- launch --------------------------------------------------------------------------

def test_build_train_returns_meta_shapes_without_allocating():
    cfg = get_config("internvl2-1b")                      # published width
    step_fn, (params, state, batch) = build_train(cfg, ShapeSpec("t", 1024, 8, "train"),
                                                  device="cpu", n_microbatches=2)
    assert callable(step_fn)
    assert all(p.device.type == "meta" for p in params.parameters())
    assert sum(p.numel() for p in params.parameters()) == cfg.param_count()
    assert all(t.device.type == "meta" and t.dtype == torch.float32 for t in state.mu.values())
    assert tuple(batch["tokens"].shape) == (8, 1024) and batch["tokens"].dtype == torch.int32
    assert tuple(batch["embeds"].shape) == (8, cfg.n_prefix, cfg.d_model)


def test_build_train_refuses_a_mesh():
    with pytest.raises(NotImplementedError, match="multi-device slice"):
        build_train(reduced("qwen2-0.5b"), ShapeSpec("t", 16, 2, "train"), mesh="2x4",
                    device="cpu")
    with pytest.raises(NotImplementedError, match="multi-device slice"):
        train_cli.main(["--arch", "qwen2-0.5b", "--reduced", "--device", "cpu", "--mesh", "2x4"])


def test_train_cli_trains_mamba2_on_the_cpu():
    """On the CPU the SSD scan's plain version is differentiable, so the
    launcher trains the SSM family there (on the card K4 refuses a
    gradient until its backward exists)."""
    res = train_cli.main(["--arch", "mamba2-130m", "--reduced", "--device", "cpu",
                          "--batch", "4", "--seq", "32", "--log-every", "100",
                          "--steps", "6", "--lr", "1e-2"])
    assert len(res.losses) == 6 and all(np.isfinite(res.losses))
    assert res.losses[-1] < res.losses[0]


def test_train_cli_resumes_bit_exactly(tmp_path):
    """8 steps with checkpoints at 3, 6 and 8; then, from a directory that
    holds only step 6, a second run resumes there and redoes steps 6 and 7
    bit for bit."""
    args = ["--arch", "qwen2-0.5b", "--reduced", "--device", "cpu", "--batch", "4",
            "--seq", "16", "--log-every", "100", "--steps", "8"]
    first = train_cli.main(args + ["--ckpt-dir", str(tmp_path / "a"), "--ckpt-every", "3"])
    assert latest_step(str(tmp_path / "a")) == 8
    shutil.copytree(tmp_path / "a" / "step_000000006", tmp_path / "b" / "step_000000006")
    second = train_cli.main(args + ["--ckpt-dir", str(tmp_path / "b")])
    assert first.start == 0 and second.start == 6 and second.losses == first.losses[6:]
    for a, b in zip(first.params.parameters(), second.params.parameters()):
        assert torch.equal(a, b)
    assert first.losses[-1] < first.losses[0]
