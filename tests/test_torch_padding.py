"""Mesh padding on the port against the JAX package's, on the CPU.

``pad_for_mesh`` equals the reference's field for field on every
registered config (published and reduced) at tp 1, 2, 3, 4, 8 and 16, with
and without ``pad_kv``, and raises the same ``ValueError`` where it does.

Then reduced models padded for a model axis of 2, 4 and 8, with and
without ``pad_kv`` (each distinct padded config once), in float32: Qwen2,
InternVL2-1B and Mamba2 here, RecurrentGemma-2B and Granite in
``test_torch_padding_hybrid_moe.py``; and at tp 3, the axis that pads the
reduced vocab of 128 and the 8 experts, a soft-capped, loss-chunked Qwen2,
Qwen2.5-14B (MQA, an untied head), Qwen3-MoE (untied) and Granite.  Each case
draws the reference's padded parameters (``repro.models.model.init_params``
from a seed, biases and norm parameters perturbed with a numpy seed) and
hands that one numpy tree to both packages.  Held, with the tolerances of
``test_torch_lm.py`` / ``test_torch_lm_archs.py`` and
``test_torch_training.py``:

(a) the port's padded model against the reference's padded model: logits
    of a forward, prefill logits and 4 decode steps within rtol/atol
    ``TOL`` (1e-4); the loss within rtol ``LOSS_RTOL`` (1e-5);
(b) the port's padded model against the port's unpadded model of the same
    function (``tests/_padding.py``: the padded weights' real slots, with
    one KV head a query head where padding regrouped them): the real
    logits, loss and decode logits within ``SAME_MODEL_TOL`` (1e-5), every
    pad logit exactly -1e30;
(c) gradients: each leaf within 1e-4·max|g| + 1e-6 of ``jax.grad`` of the
    reference's padded loss, and every pad slot's gradient exactly 0
    (``wq`` pad columns, ``wo`` pad rows, KV heads that serve only pad
    heads, pad vocab rows or columns, router pad columns, pad experts);
and every ``cfg.remat`` policy gives the padded model the same bits.
"""

import dataclasses
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.configs.base import list_configs as jax_list_configs
from repro.configs.base import pad_for_mesh as jax_pad_for_mesh
from repro.models import model as JM
from repro_torch.configs.base import get_config, list_configs, pad_for_mesh
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.models import model as TM
from repro_torch.training.train_loop import batch_to
from tests._padding import pad_slots, regroups, unpadded

TOL = 1e-4
LOSS_RTOL = 1e-5
SAME_MODEL_TOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
TPS = (1, 2, 3, 4, 8, 16)
PERTURBED = ("bq", "bk", "bv", "scale", "bias", "b_a", "b_i", "conv_b")


# -- pad_for_mesh ------------------------------------------------------------------

@pytest.mark.parametrize("pad_kv", [False, True], ids=["", "pad_kv"])
@pytest.mark.parametrize("tp", TPS, ids=[f"tp{t}" for t in TPS])
@pytest.mark.parametrize("arch,small", [(a, s) for a in sorted(jax_list_configs())
                                        for s in (False, True)],
                         ids=[f"{a}-{'reduced' if s else 'published'}"
                              for a in sorted(jax_list_configs()) for s in (False, True)])
def test_pad_for_mesh_equals_the_reference(arch, small, tp, pad_kv):
    want_cfg, got_cfg = jax_get_config(arch, reduced=small), get_config(arch, reduced=small)
    try:
        want = jax_pad_for_mesh(want_cfg, tp, pad_kv)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e)):
            pad_for_mesh(got_cfg, tp, pad_kv)
        return
    got = pad_for_mesh(got_cfg, tp, pad_kv)
    for f in dataclasses.fields(got):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    for prop in ("heads_p", "kv_heads_p", "vocab_p", "experts_p"):
        assert getattr(got, prop) == getattr(want, prop), prop
    assert all(n % tp == 0 for n in (got.heads_p, got.vocab_p))
    # the logical architecture is unchanged
    assert got.param_count() == got_cfg.param_count()
    assert got.active_param_count() == got_cfg.active_param_count()


def test_pad_for_mesh_raises_where_the_reference_does():
    cfg = get_config("qwen2.5-14b")                    # 40 heads over 8 KV heads
    with pytest.raises(ValueError, match="padded heads 42 not divisible by kv heads 8"):
        pad_for_mesh(cfg, 3)
    assert list_configs() == sorted(jax_list_configs())


# -- padded reduced models ---------------------------------------------------------

def _key(cfg):
    return (cfg.heads_p, cfg.kv_heads_p, cfg.vocab_p, cfg.experts_p)


def _cases(archs, extras=()):
    """Each distinct padded config of ``archs`` at tp 2, 4 and 8 (the
    (tp, pad_kv) pairs that give it in its id), then ``extras``."""
    out = []
    for arch in archs:
        seen = {}
        for tp in (2, 4, 8):
            for kv in (False, True):
                seen.setdefault(_key(pad_for_mesh(get_config(arch, reduced=True), tp, kv)),
                                []).append((tp, kv))
        for pairs in seen.values():
            tp, kv = pairs[0]
            out.append(pytest.param((arch, tp, kv, {}), id=f"{arch}-" + ",".join(
                f"tp{t}{'kv' if k else ''}" for t, k in pairs)))
    return out + [pytest.param(e, id=f"{e[0]}-tp{e[1]}" + "".join(f"-{k}" for k in e[3]))
                  for e in extras]


def _tree(jcfg, seed):
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(np.asarray, JM.init_params(jax.random.PRNGKey(seed), jcfg))

    def perturb(path, a):
        if path[-1].key in PERTURBED:
            return (a.astype(np.float32) + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(perturb, tree)


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


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _prompt(cfg):
    """A prompt (2, 16): the reduced Mamba-2 chunk, past RecurrentGemma's
    window of 16; 4 tokens to decode; prefix embeds for a frontend."""
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    feed = rng.integers(0, cfg.vocab_size, (4, 2)).astype(np.int32)
    embeds = (rng.standard_normal((2, cfg.n_prefix, cfg.d_model)).astype(np.float32)
              if cfg.frontend else None)
    return prompt, feed, embeds


def _reference(jcfg, tree, batch, prompt, feed, embeds):
    """The reference's padded model on the case's inputs: forward logits,
    loss and its gradient (one compile), prefill and decode logits."""
    def train(p, b):
        loss, grads = jax.value_and_grad(JM.loss_fn)(p, jcfg, b)
        return JM.forward(p, jcfg, b["tokens"], b.get("embeds")), loss, grads

    logits, loss, grads = jax.jit(train)(tree, batch)
    cache_len = prompt.shape[1] + len(feed)
    out, caches = jax.jit(lambda p, t, e: JM.prefill(p, jcfg, t, cache_len, e))(
        tree, prompt, embeds)
    serve = [np.asarray(out)]
    step = jax.jit(lambda p, t, c, pos: JM.decode_step(p, jcfg, t, c, pos))
    for i, tok in enumerate(feed):
        out, caches = step(tree, tok, caches, prompt.shape[1] + i)
        serve.append(np.asarray(out))
    return SimpleNamespace(logits=np.asarray(logits), loss=float(loss),
                           grads=_to_port(jax.tree.map(np.asarray, grads), jcfg), serve=serve)


def build_case(request):
    """A padded case (the ``case`` fixture of this file and of
    ``test_torch_padding_hybrid_moe.py``): its config, the port's padded
    and unpadded parameters, a training batch, a prompt, and the
    reference's outputs on them."""
    arch, tp, pad_kv, changes = request.param
    jcfg = jax_pad_for_mesh(dataclasses.replace(jax_get_config(arch, reduced=True),
                                                dtype="float32", **changes), tp, pad_kv)
    cfg = pad_for_mesh(dataclasses.replace(get_config(arch, reduced=True), dtype="float32",
                                           **changes), tp, pad_kv)
    tree = _tree(jcfg, seed=tp)
    params = TM.params_from_numpy(cfg, tree, device="cpu")
    uparams, ucfg = unpadded(params, cfg, TM)
    seq = 32 if cfg.ssm_state else 33                  # Mamba-2: a multiple of its chunk
    batch = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=2, seed=tp,
                        n_prefix=cfg.n_prefix if cfg.frontend else 0,
                        d_model=cfg.d_model if cfg.frontend else 0).batch_at(0)
    prompt, feed, embeds = _prompt(cfg)
    return SimpleNamespace(cfg=cfg, params=params, uparams=uparams, ucfg=ucfg, batch=batch,
                           prompt=prompt, feed=feed, embeds=embeds,
                           want=_reference(jcfg, tree, batch, prompt, feed, embeds))


# the dense, frontend and SSM archs here, and at tp 3 (vocab and experts
# padded) a soft-capped, loss-chunked Qwen2, MQA with an untied head and
# two MoEs; the hybrid and MoE archs in test_torch_padding_hybrid_moe.py
case = pytest.fixture(scope="module", params=_cases(
    ("qwen2-0.5b", "internvl2-1b", "mamba2-130m"),
    [("qwen2-0.5b", 3, False, {"logits_soft_cap": 30.0, "loss_chunk": 8}),
     ("qwen2.5-14b", 3, False, {}), ("qwen3-moe-235b-a22b", 3, False, {}),
     ("granite-moe-3b-a800m", 3, False, {})]))(build_case)


def _t(a):
    return None if a is None else torch.from_numpy(a)


def test_padded_model_is_drawn_at_the_padded_sizes(case):
    cfg, params = case.cfg, case.params
    assert params["embedding"]["tokens"].shape[0] == cfg.vocab_p
    assert case.uparams["embedding"]["tokens"].shape[0] == case.ucfg.vocab_size == cfg.vocab_size
    for block in params["stack"]:
        if "attn" in block:
            assert block["attn"]["wq"].shape[1] == block["attn"]["wo"].shape[0] == cfg.heads_p
            assert block["attn"]["wk"].shape[1] == cfg.kv_heads_p
        if block.kind == "moe":
            assert block["ffn"]["router"].shape[1] == block["ffn"]["w_up"].shape[0] \
                == cfg.experts_p
    drawn = TM.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert {n: p.shape for n, p in drawn.named_parameters()} == {
        n: p.shape for n, p in params.named_parameters()}


def test_padded_forward_and_loss_match_the_reference(case):
    cfg, batch = case.cfg, case.batch
    got = TM.forward(case.params, cfg, _t(batch["tokens"]).long(), _t(batch.get("embeds")))
    assert got.shape == (*batch["tokens"].shape, cfg.vocab_p)
    _close(got.numpy(), case.want.logits, TOL)
    got_loss = TM.loss_fn(case.params, cfg, batch_to(batch, "cpu"))
    np.testing.assert_allclose(float(got_loss), case.want.loss, rtol=LOSS_RTOL)


def _serve(case, params, cfg):
    """Prefill logits, then each decode step's, as numpy."""
    prompt = _t(case.prompt).long()
    logits, caches = TM.prefill(params, cfg, prompt, prompt.shape[1] + len(case.feed),
                                embeds=_t(case.embeds))
    out = [logits.numpy()]
    for i, tok in enumerate(case.feed):
        logits, caches = TM.decode_step(params, cfg, _t(tok).long(), caches,
                                        prompt.shape[1] + i)
        out.append(logits.numpy())
    return out


def test_padded_prefill_and_decode_match_the_reference(case):
    for got, want in zip(_serve(case, case.params, case.cfg), case.want.serve, strict=True):
        _close(got, want, TOL)


def test_padded_model_is_the_unpadded_model(case):
    cfg, batch = case.cfg, case.batch
    V = cfg.vocab_size
    toks, embeds = _t(batch["tokens"]).long(), _t(batch.get("embeds"))
    got = TM.forward(case.params, cfg, toks, embeds)
    want = TM.forward(case.uparams, case.ucfg, toks, embeds)
    _close(got[..., :V].numpy(), want.numpy(), SAME_MODEL_TOL)
    assert bool((got[..., V:] == -1e30).all())
    b = batch_to(batch, "cpu")
    np.testing.assert_allclose(float(TM.loss_fn(case.params, cfg, b)),
                               float(TM.loss_fn(case.uparams, case.ucfg, b)),
                               rtol=SAME_MODEL_TOL)
    for g, w in zip(_serve(case, case.params, cfg), _serve(case, case.uparams, case.ucfg),
                    strict=True):
        _close(g[:, :V], w, SAME_MODEL_TOL)
        assert bool((g[:, V:] == -1e30).all())


def test_padded_gradients_match_jax_grad_and_pad_slots_are_zero(case):
    cfg, params = case.cfg, case.params
    params.requires_grad_(True)
    try:
        named = dict(params.named_parameters())
        loss = TM.loss_fn(params, cfg, batch_to(case.batch, "cpu"))
        grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
    finally:
        params.requires_grad_(False)
    assert set(grads) == set(case.want.grads)
    n_pad = 0
    for name, g in grads.items():
        w = np.asarray(case.want.grads[name], np.float32)
        err = np.abs(g.numpy() - w).max()
        assert err <= GRAD_RTOL * np.abs(w).max() + GRAD_ATOL, (name, err)
        mask = pad_slots(name, tuple(g.shape), cfg)
        if mask is not None:
            n_pad += int(mask.sum())
            assert bool((g[mask] == 0).all()), name           # exactly 0, not small
    padded = ((cfg.heads_p > cfg.n_heads and not cfg.is_attention_free)
              or cfg.vocab_p > cfg.vocab_size or cfg.experts_p > cfg.n_experts)
    assert (n_pad > 0) == padded


def test_padded_remat_policies_give_the_same_bits(case):
    """``cfg.remat`` none, dots and full give the same loss and gradient
    bits on the padded model (``tests/test_torch_remat.py``'s contract)."""
    params, batch = case.params, batch_to(case.batch, "cpu")
    params.requires_grad_(True)
    try:
        out = {}
        for policy in ("none", "dots", "full"):
            loss = TM.loss_fn(params, dataclasses.replace(case.cfg, remat=policy), batch)
            out[policy] = (loss.detach(), torch.autograd.grad(loss, list(params.parameters())))
    finally:
        params.requires_grad_(False)
    for policy in ("dots", "full"):
        assert torch.equal(out[policy][0], out["none"][0]), policy
        assert all(torch.equal(g, w) for g, w in zip(out[policy][1], out["none"][1])), policy


def test_regrouping_is_the_references_rule():
    """Without pad_kv a GQA config's padded heads regroup (G 2 -> 4 at tp 8:
    real heads 2 and 3 move from KV head 1 to 0), as the reference's
    ``_repeat_kv`` does; ``pad_kv`` keeps G."""
    base = get_config("qwen2-0.5b", reduced=True)
    assert regroups(pad_for_mesh(base, 8)) and not regroups(pad_for_mesh(base, 8, True))
    assert not regroups(pad_for_mesh(get_config("recurrentgemma-2b", reduced=True), 8))
