"""The port's remat policy (``cfg.remat``: ``none``, ``dots``, ``full``) on
the CPU, at reduced size in float32, in every family: the dense Qwen2-0.5B,
Mamba2-130M (K4's plain path), RecurrentGemma-2B (a group of rglru, rglru,
local_attn and its unwrapped 2-layer tail), Granite-3.0-3B-A800M (MoE),
InternVL2-1B (``embeds``) and MusicGen-Medium.

A policy changes what the backward keeps and recomputes, never a number:
losses, gradients and a two-microbatch ``make_train_step`` are
``torch.equal`` under all three.  ``apply_block`` runs twice in a wrapped
layer of a grad step under ``full`` and ``dots`` and once in a tail layer,
under ``none``, and in a ``no_grad`` prefill.  What one loss keeps for its
backward falls from ``none`` to ``dots`` to ``full``.  The gradients stay
within ``tests/test_torch_training.py``'s tolerance of ``jax.grad`` of the
reference's ``loss_fn`` under the same policy (each leaf max|Δ| <=
1e-4·max|g_ref| + 1e-6).  K3's and K4's ``autograd.Function``s, with their
launches replaced by the plain versions, give under a checkpoint the
gradients they give without one, bit for bit, inside the model too, where
a checkpointed layer launches its forward twice and its backward once.
"""

import copy
import dataclasses
import gc
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

from repro.models import model as JM
from repro_torch.configs.base import reduced
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import lse_ref, mha_bwd_ref, mha_ref
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan.ref import span_states_ref, ssd_bwd_ref
from repro_torch.models import attention as attn_mod
from repro_torch.models import model as M
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import transformer as tf
from repro_torch.models.ssm import ssd_chunked
from repro_torch.training.optimizer import OptimizerConfig, init_opt_state
from repro_torch.training.train_loop import batch_to, make_train_step

from test_torch_training import _data, _from_port, _numpy, _setup

FAMILIES = ["qwen2-0.5b", "mamba2-130m", "recurrentgemma-2b", "granite-moe-3b-a800m",
            "internvl2-1b", "musicgen-medium"]
POLICIES = ("none", "dots", "full")
OPT = OptimizerConfig(lr=1e-2, warmup_steps=1, decay_steps=100)
B, S = 2, 32


def _cfg(arch, remat):
    return dataclasses.replace(reduced(arch), dtype="float32", remat=remat)


def _params(arch):
    params = M.init_params(_cfg(arch, "none"), torch.Generator().manual_seed(0), "cpu")
    params.requires_grad_(True)
    return params


def _batch(cfg, batch=B, seed=1):
    return batch_to(_data(cfg, S, batch, seed).batch_at(0), "cpu")


def _loss_and_grads(params, cfg, batch):
    loss = M.loss_fn(params, cfg, batch)
    return loss.detach(), torch.autograd.grad(loss, list(params.parameters()))


def _wrapped(cfg) -> int:
    return cfg.n_groups * len(cfg.block_pattern)


# -- the policies give the same bits -------------------------------------------------

@pytest.mark.parametrize("arch", FAMILIES)
def test_policies_give_bit_equal_losses_and_gradients(arch):
    params = _params(arch)
    batch = _batch(_cfg(arch, "none"))
    want_loss, want = _loss_and_grads(params, _cfg(arch, "none"), batch)
    for policy in ("dots", "full"):
        loss, grads = _loss_and_grads(params, _cfg(arch, policy), batch)
        assert torch.equal(loss, want_loss), policy
        assert all(torch.equal(g, w) for g, w in zip(grads, want)), policy


@pytest.mark.parametrize("arch", FAMILIES)
def test_two_microbatch_train_step_bit_equal_across_policies(arch):
    base = _params(arch)
    batch = _batch(_cfg(arch, "none"), batch=4)
    out = {}
    for policy in POLICIES:
        params = copy.deepcopy(base)
        params, state, metrics = make_train_step(_cfg(arch, policy), OPT, 2)(
            params, init_opt_state(params), batch)
        out[policy] = (metrics, dict(params.named_parameters()), state)
    (m0, p0, s0) = out["none"]
    for policy in ("dots", "full"):
        m, p, s = out[policy]
        for key in ("loss", "grad_norm", "param_norm"):
            assert torch.equal(m[key], m0[key]), (policy, key)
        for name in p0:
            assert torch.equal(p[name], p0[name]), (policy, name)
            assert torch.equal(s.mu[name], s0.mu[name]), (policy, name)
            assert torch.equal(s.nu[name], s0.nu[name]), (policy, name)


# -- what runs twice -------------------------------------------------------------------

@pytest.fixture
def block_calls(monkeypatch):
    """``apply_block`` counted by the block it runs."""
    calls = Counter()
    apply_block = tf.apply_block

    def counted(p, *args, **kwargs):
        calls[id(p)] += 1
        return apply_block(p, *args, **kwargs)

    monkeypatch.setattr(tf, "apply_block", counted)
    return calls


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("arch", FAMILIES)
def test_a_grad_step_recomputes_each_wrapped_layer_once(block_calls, arch, policy):
    cfg = _cfg(arch, policy)
    params = _params(arch)
    batch = _batch(cfg)
    layers = list(params["stack"])
    assert len(layers) == cfg.n_layers and _wrapped(cfg) >= 1
    loss = M.loss_fn(params, cfg, batch)
    assert [block_calls[id(b)] for b in layers] == [1] * cfg.n_layers   # the forward
    block_calls.clear()
    torch.autograd.grad(loss, list(params.parameters()))
    twice = policy != "none"
    assert [block_calls[id(b)] for b in layers] == (
        [int(twice)] * _wrapped(cfg) + [0] * (cfg.n_layers - _wrapped(cfg)))
    block_calls.clear()
    with torch.no_grad():
        M.prefill(params, cfg, batch["tokens"], embeds=batch.get("embeds"))
        M.forward(params, cfg, batch["tokens"], embeds=batch.get("embeds"))
    assert [block_calls[id(b)] for b in layers] == [2] * cfg.n_layers


def test_recurrentgemma_wraps_its_groups_and_not_its_tail():
    cfg = _cfg("recurrentgemma-2b", "full")
    assert cfg.block_pattern == ("rglru", "rglru", "local_attn")
    assert cfg.tail_pattern == ("rglru", "rglru")
    assert _wrapped(cfg) == cfg.n_layers - 2 == 3 * cfg.n_groups


# -- what one loss keeps -------------------------------------------------------------

class _Made(TorchDispatchMode):
    """Every storage an op makes, by a weak reference, with its bytes."""

    def __init__(self):
        super().__init__()
        self.made = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                storage = t.untyped_storage()
                self.made[storage.data_ptr()] = (StorageWeakRef(storage), storage.nbytes())
        return out


def _kept_bytes(params, cfg, batch) -> tuple[int, int]:
    """(saved, alive) bytes of one loss's graph: what a
    ``saved_tensors_hooks`` outside the loss sees packed (it cannot see into
    a checkpoint, whose own hook packs there, nor into the selective
    policy's cache), and the storages made in the forward that the graph
    keeps alive after it (saved tensors, each checkpoint's input, the
    policy's cache)."""
    saved = {}

    def pack(t):
        storage = t.untyped_storage()
        saved[storage.data_ptr()] = storage.nbytes()
        return t

    mode = _Made()
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t), mode:
        loss = M.loss_fn(params, cfg, batch)
    gc.collect()
    params_at = {p.untyped_storage().data_ptr() for p in params.parameters()}
    alive = sum(n for ptr, (ref, n) in mode.made.items()
                if not ref.expired() and ptr not in params_at)
    grads = torch.autograd.grad(loss, list(params.parameters()))
    assert all(torch.isfinite(g).all() for g in grads)
    return sum(n for ptr, n in saved.items() if ptr not in params_at), alive


@pytest.mark.parametrize("arch", FAMILIES)
def test_saved_bytes_fall_from_none_to_dots_to_full(arch):
    params = _params(arch)
    batch = _batch(_cfg(arch, "none"))
    got = {p: _kept_bytes(params, _cfg(arch, p), batch) for p in POLICIES}
    saved, alive = ({p: got[p][i] for p in POLICIES} for i in (0, 1))
    assert saved["full"] == saved["dots"] < saved["none"], saved
    assert alive["full"] < alive["dots"] < alive["none"], alive


# -- against the reference -----------------------------------------------------------

@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "mamba2-130m", "recurrentgemma-2b"])
def test_gradients_match_jax_grad_of_the_reference_under_each_policy(arch, policy):
    jcfg, tcfg, tree, params = _setup(arch, remat=policy)
    assert jcfg.remat == tcfg.remat == policy
    batch = _data(tcfg, 32, 2, seed=2).batch_at(0)
    want = jax.grad(JM.loss_fn)(jax.tree.map(jnp.asarray, tree), jcfg,
                                jax.tree.map(jnp.asarray, batch))
    named = dict(params.named_parameters())
    loss = M.loss_fn(params, tcfg, batch_to(batch, "cpu"))
    grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
    got = _from_port(tree, tcfg, _numpy(grads))
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                            jax.tree.leaves(got)):
        w = np.asarray(w, np.float32)
        err = np.abs(np.asarray(g, np.float32) - w).max()
        assert err <= 1e-4 * np.abs(w).max() + 1e-6, (jax.tree_util.keystr(path), err)


# -- K3's and K4's Functions under a checkpoint --------------------------------------

@pytest.fixture
def plain_launches(monkeypatch):
    """K3's and K4's Functions with their launches replaced by the plain
    versions (counted), and the model's attention and SSD calling the
    Functions on CPU tensors, as it calls them on the card in training."""
    calls = Counter()

    def fa_forward(q, k, v, window, with_lse):
        calls["fa_forward", with_lse] += 1
        return mha_ref(q, k, v, window=window), lse_ref(q, k, window=window)

    def fa_backward(q, k, v, out, dout, lse, window=0):
        calls["fa_backward"] += 1
        return mha_bwd_ref(q, k, v, out, dout, lse, window=window)

    def ssd_forward(x, dt, A, Bm, Cm, h0, keep_states):
        calls["ssd_forward", keep_states] += 1
        y, h = ssd_chunked(x, dt, A, Bm, Cm, x.shape[1], h0)
        return y, h, span_states_ref(x, dt, A, Bm, Cm, h0)

    def ssd_backward(x, dt, A, Bm, Cm, dy, states, dh=None):
        calls["ssd_backward"] += 1
        return ssd_bwd_ref(x, dt, A, Bm, Cm, dy, states, dh)

    monkeypatch.setattr(fa_ops, "_forward", fa_forward)
    monkeypatch.setattr(fa_ops, "flash_attention_bwd", fa_backward)
    monkeypatch.setattr(ssd_ops, "_forward", ssd_forward)
    monkeypatch.setattr(ssd_ops, "ssd_scan_bwd", ssd_backward)
    monkeypatch.setattr(attn_mod, "flash_attention",
                        lambda q, k, v, window=0: fa_ops._FlashAttention.apply(q, k, v, window))
    monkeypatch.setattr(ssm_mod, "ssd_scan", lambda x, dt, A, Bm, Cm, *, chunk, h0=None:
                        ssd_ops._SSDScan.apply(x, dt, A, Bm, Cm, h0))
    return calls


def _fa_inputs(seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
               for shape in ((6, 40, 16), (2, 40, 16), (2, 40, 16)))
    return q, k, v, torch.from_numpy(rng.standard_normal((6, 40, 16), dtype=np.float32))


def _ssd_inputs(seed=0):
    rng = np.random.default_rng(seed)
    b, s, h, p, n = 2, 96, 3, 8, 4
    out = [rng.standard_normal((b, s, h, p), dtype=np.float32),
           np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32),
           -np.exp(0.5 * rng.standard_normal(h)).astype(np.float32),
           rng.standard_normal((b, s, n), dtype=np.float32),
           rng.standard_normal((b, s, n), dtype=np.float32)]
    return [torch.from_numpy(a) for a in out], torch.from_numpy(
        rng.standard_normal((b, s, h, p), dtype=np.float32))


def _under(policy, fn, *args):
    """fn(*args) as it is, or under the checkpoint ``policy`` names."""
    if policy == "none":
        return fn(*args)
    context = (dict(context_fn=lambda: create_selective_checkpoint_contexts(tf._keep_products))
               if policy == "dots" else {})
    return checkpoint(fn, *args, use_reentrant=False, **context)


@pytest.mark.parametrize("policy", ["dots", "full"])
@pytest.mark.parametrize("kernel", ["flash_attention", "ssd_scan"])
def test_kernel_functions_give_the_same_gradients_under_a_checkpoint(plain_launches, kernel,
                                                                      policy):
    """The Function inside a checkpointed region (with a product in front of
    it, as a projection is): its forward launched again in the backward,
    saving what it saved the first time, and the gradients bit-equal to
    those without the checkpoint."""
    if kernel == "flash_attention":
        q, k, v, do = _fa_inputs()
        w = torch.eye(16) + 0.1 * torch.from_numpy(
            np.random.default_rng(9).standard_normal((16, 16), dtype=np.float32))

        def region(q, k, v):
            return fa_ops._FlashAttention.apply((q @ w).contiguous(), k, v, 7)

        inputs, cot, fwd = [q, k, v], do, ("fa_forward", True)
    else:
        inputs, cot = _ssd_inputs()
        w = torch.full((4, 4), 0.25) + torch.eye(4)

        def region(x, dt, A, Bm, Cm):
            return ssd_ops._SSDScan.apply(x, dt, A, (Bm @ w).contiguous(), Cm, None)[0]

        fwd = ("ssd_forward", True)
    grads = {}
    for p in ("none", policy):
        leaves = [t.clone().requires_grad_(True) for t in inputs]
        plain_launches.clear()
        out = _under(p, region, *leaves)
        grads[p] = torch.autograd.grad(out, leaves, cot)
        bwd = "fa_backward" if kernel == "flash_attention" else "ssd_backward"
        assert plain_launches == {fwd: 1 if p == "none" else 2, bwd: 1}, (p, plain_launches)
    assert all(torch.equal(g, w) for g, w in zip(grads[policy], grads["none"]))


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "mamba2-130m", "recurrentgemma-2b"])
def test_the_model_through_the_kernel_functions_under_each_policy(plain_launches, arch):
    """The model's attention and SSD through K3's and K4's Functions: the
    loss and gradients bit-equal under the three policies; the forward
    launched once a layer under ``none``, twice in a wrapped layer under
    ``dots`` and ``full``; the backward once a layer."""
    params = _params(arch)
    batch = _batch(_cfg(arch, "none"))
    kinds = ("ssm",) if arch == "mamba2-130m" else ("attn", "local_attn")
    fwd, bwd = ((("ssd_forward", True), "ssd_backward") if arch == "mamba2-130m"
                else (("fa_forward", True), "fa_backward"))
    out = {}
    for policy in POLICIES:
        cfg = _cfg(arch, policy)
        plain_launches.clear()
        out[policy] = _loss_and_grads(params, cfg, batch)
        layers = sum(kind in kinds for kind in cfg.layer_kinds)
        wrapped = sum(kind in kinds for kind in cfg.layer_kinds[:_wrapped(cfg)])
        assert layers >= 1 and wrapped >= 1
        assert plain_launches == {fwd: layers + (wrapped if policy != "none" else 0),
                                  bwd: layers}, (policy, plain_launches)
    for policy in ("dots", "full"):
        assert torch.equal(out[policy][0], out["none"][0])
        assert all(torch.equal(g, w) for g, w in zip(out[policy][1], out["none"][1]))
