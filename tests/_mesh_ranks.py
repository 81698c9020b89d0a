"""Jobs for spawned gloo ranks: the port's mesh path against its one-device path.

``spawn(world, job, tmp)`` starts ``world`` processes (the ``spawn`` start
method), each joining a gloo process group through a ``FileStore`` under
``tmp`` (no TCP port), runs ``JOBS[job]`` on every rank and returns what
rank 0 returned (a JSON-able dict).  Every rank draws the same weights and
batches from the same seeds, computes the one-device result itself, then
the mesh result, so rank 0 can compare them; collectives run on every rank
in the same order.  Used by ``tests/test_torch_distributed.py``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

__all__ = ["spawn", "JOBS"]

PERTURBED = ("scale", "bias", "bq", "bk", "bv", "b_a", "b_i", "conv_b")
# the reduced configs divide a model axis of 4; this one pads to it: heads
# 6 -> 8 over 2 KV heads (G 3 -> 4) and vocab 130 -> 132
PADDED = {"n_heads": 6, "n_kv_heads": 2, "d_head": 16, "vocab_size": 130}
# MoE's reduced configs: 8 experts top-2 at capacity factor 8 (no choice is
# dropped); DROPS drops choices, SIX pads 6 experts to 8 at tp 4 (the last
# model rank holds only padding experts)
DROPS = {"capacity_factor": 0.5}
SIX = {"n_experts": 6, "capacity_factor": 0.5}
MOE_ARCHS = ("granite-moe-3b-a800m", "qwen3-moe-235b-a22b")
MOE_POLICIES = ("default", "fsdp_ep", "moe_noseq", "moe_a2a")
# the layer also under fsdp, whose batch shards over model as well
LAYER_POLICIES = MOE_POLICIES + ("fsdp",)
CASES = {"qwen2-0.5b": ("qwen2-0.5b", {}), "recurrentgemma-2b": ("recurrentgemma-2b", {}),
         "mamba2-130m": ("mamba2-130m", {}), "internvl2-1b": ("internvl2-1b", {}),
         "qwen2-0.5b-padded": ("qwen2-0.5b", PADDED)}


def _cfg(arch, tp, **changes):
    from repro_torch.configs.base import get_config, pad_for_mesh

    base = dataclasses.replace(get_config(arch, reduced=True), dtype="float32", **changes)
    return base, pad_for_mesh(base, tp)


def _params(cfg, seed=0):
    """Weights drawn whole from ``seed`` (norm scales and biases perturbed
    away from 1/0), requiring grad."""
    from repro_torch.models import model as M

    params = M.init_params(cfg, torch.Generator().manual_seed(seed), "cpu")
    g = torch.Generator().manual_seed(seed + 100)
    with torch.no_grad():
        for name, p in params.named_parameters():
            if name.rsplit(".", 1)[-1] in PERTURBED:
                p.add_(0.1 * torch.randn(p.shape, generator=g))
    return params.requires_grad_(True)


def _batch(cfg, B, S, seed=1):
    rng = np.random.default_rng(seed)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S),
                                                     dtype=np.int32))}
    if cfg.frontend:
        batch["embeds"] = torch.from_numpy(
            rng.standard_normal((B, cfg.n_prefix, cfg.d_model)).astype(np.float32))
    return batch


def _full(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _rel(a, b) -> float:
    """max|a - b| over max|a|."""
    return float((a - b).abs().max() / a.abs().max().clamp(min=1e-30))


def _train(cfg0, cfg, mesh, B, S, steps, policy="default", lr=1e-3):
    """``steps`` steps one-device and through ``build_cell`` on ``mesh``:
    (one-device losses, mesh losses, worst leaf's max|Δ| over max|leaf|)."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.steps import build_cell, build_train, place
    from repro_torch.training.optimizer import OptimizerConfig, init_opt_state

    opt_cfg = OptimizerConfig(lr=lr, warmup_steps=2, decay_steps=100)
    shape = ShapeSpec("t", S, B, "train")
    batches = [_batch(cfg, B, S, seed=10 + i) for i in range(steps)]
    step1, _ = build_train(cfg, shape, device="cpu", opt_cfg=opt_cfg)
    p1 = _params(cfg)
    s1 = init_opt_state(p1)
    want = []
    for b in batches:
        p1, s1, m = step1(p1, s1, b)
        want.append(float(m["loss"]))
    stepm, (pspec, ospec, bspec), _ = build_cell(cfg0, shape, mesh, policy, opt_cfg=opt_cfg)
    pm = _params(cfg)
    sm = place(init_opt_state(pm), ospec, mesh)
    pm = place(pm, pspec, mesh)
    got = []
    for b in batches:
        pm, sm, m = stepm(pm, sm, place(b, bspec, mesh))
        got.append(float(m["loss"]))
    worst = max(_rel(a.detach(), _full(b).detach())
                for a, b in zip(p1.parameters(), pm.parameters()))
    return want, got, worst


def mesh24(**_):
    """On a (2, 4) mesh: the forward (qwen2 and recurrentgemma, and qwen2
    with heads and vocab that pad at tp 4), fsdp's loss, five default
    steps, one step of each dense family and of the padded qwen2, and
    qwen2's prefill and decode."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.distributed.sharding import use_rules
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.steps import build_cell, place
    from repro_torch.models import model as M

    mesh = make_test_mesh((2, 4), device_type="cpu")
    out = {"forward": {}, "families": {}}
    for name in ("qwen2-0.5b", "recurrentgemma-2b", "qwen2-0.5b-padded"):
        arch, changes = CASES[name]
        cfg0, cfg = _cfg(arch, 4, **changes)
        params = _params(cfg)
        tokens = _batch(cfg, 4, 32)["tokens"]
        _, (pspec, bspec), rules = build_cell(cfg0, ShapeSpec("p", 32, 4, "prefill"), mesh)
        with torch.no_grad():
            plain = M.forward(params, cfg, tokens)[..., :cfg.vocab_size]
            pm = place(_params(cfg), pspec, mesh)
            with use_rules(rules):
                sharded = _full(M.forward(pm, cfg, place(tokens, bspec["tokens"], mesh)))
        out["forward"][name] = _rel(plain, sharded[..., :cfg.vocab_size])

    cfg0, cfg = _cfg("qwen2-0.5b", 4)
    want, got, _ = _train(cfg0, cfg, mesh, 8, 64, 1, "fsdp")
    out["fsdp"] = (want[0], got[0])
    out["five"] = _train(cfg0, cfg, mesh, 8, 32, 5)

    for name, (arch, changes) in CASES.items():
        cfg0, cfg = _cfg(arch, 4, **changes)
        want, got, _ = _train(cfg0, cfg, mesh, 8, 64 if arch == "mamba2-130m" else 32, 1)
        out["families"][name] = (want[0], got[0])

    cfg0, cfg = _cfg("qwen2-0.5b", 4)
    tokens = _batch(cfg, 8, 16)["tokens"]
    errs = []
    with torch.no_grad():
        caches, p1 = None, _params(cfg)
        logits, caches = M.prefill(p1, cfg, tokens, cache_len=20)
        pf, (pspec, bspec), _ = build_cell(cfg0, ShapeSpec("p", 16, 8, "prefill"), mesh,
                                           cache_len=20)
        dec, (_, _, tspec), _ = build_cell(cfg0, ShapeSpec("d", 20, 8, "decode"), mesh)
        pm = place(_params(cfg), pspec, mesh)
        lm, cm = pf(pm, place({"tokens": tokens}, bspec, mesh))
        errs.append(_rel(logits, _full(lm)))
        tok = logits.argmax(-1).int()
        for i in range(4):
            logits, caches = M.decode_step(p1, cfg, tok, caches, 16 + i)
            lm, cm = dec(pm, cm, place(tok, tspec, mesh), 16 + i)
            errs.append(_rel(logits, _full(lm)))
            tok = logits.argmax(-1).int()
        errs.append(max(_rel(a.float(), _full(b).float()) for c, d in zip(caches, cm)
                        for a, b in zip(c.values(), d.values())))
    out["serve"] = errs
    return out


def uneven(**_):
    """On a (1, 3) mesh, query heads over KV heads in groups of 3 that the
    model axis cuts unevenly: heads 6 over KV 2 (2 heads a rank) and 12
    over 4 (4 a rank).  Each rank's KV selection, and the logits and
    gradients against one device."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.distributed.sharding import constrain, use_rules
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.steps import build_cell, place
    from repro_torch.models import attention as A
    from repro_torch.models import model as M

    mesh = make_test_mesh((1, 3), device_type="cpu")
    out = {}
    for heads, kv in ((6, 2), (12, 4)):
        cfg0, cfg = _cfg("qwen2-0.5b", 3, n_heads=heads, n_kv_heads=kv, d_head=16)
        batch = _batch(cfg, 2, 32)
        p1 = _params(cfg)
        logits = M.forward(p1, cfg, batch["tokens"]).detach()
        loss = M.loss_fn(p1, cfg, batch)
        grads = torch.autograd.grad(loss, list(p1.parameters()))
        _, (pspec, _, bspec), rules = build_cell(cfg0, ShapeSpec("t", 32, 2, "train"), mesh)
        pm = place(_params(cfg), pspec, mesh)
        bm = place(batch, bspec, mesh)
        with use_rules(rules):
            q = constrain(torch.zeros(2, 32, heads, 16), ("batch", None, "act_heads", None))
            k = constrain(torch.zeros(2, 32, kv, 16), ("batch", None, "act_kv", None))
            sel = A._local_kv(cfg, q, k)
            lm = _full(M.forward(pm, cfg, bm["tokens"]).detach())
            lossm = M.loss_fn(pm, cfg, bm)
            gm = torch.autograd.grad(lossm, list(pm.parameters()))
        sels = [None] * 3
        dist.all_gather_object(sels, sel)
        worst = max(float((a - _full(b)).abs().max() / (1e-4 * a.abs().max() + 1e-6))
                    for a, b in zip(grads, gm))
        out[f"{heads}/{kv}"] = {"sel": sels, "logits": _rel(logits, lm),
                                "loss": (float(loss), float(_full(lossm))),
                                "grad_share": worst}
    return out


def checkpoint(tmp):
    """On a (1, 2) mesh: ``launch.train.train`` for 4 steps with checkpoints
    at 2 and 4, then a resume from step 2 alone; and the files' leaves
    against a one-device run's."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.train import train

    mesh = make_test_mesh((1, 2), device_type="cpu")
    cfg = get_config("qwen2-0.5b", reduced=True)
    kw = dict(steps=4, batch=4, seq=16, device="cpu", log=lambda *a: None)
    a, b, one = (os.path.join(tmp, d) for d in ("a", "b", "one"))
    first = train(cfg, mesh=mesh, ckpt_dir=a, ckpt_every=2, **kw)
    if dist.get_rank() == 0:
        shutil.copytree(os.path.join(a, "step_000000002"), os.path.join(b, "step_000000002"))
    dist.barrier()
    second = train(cfg, mesh=mesh, ckpt_dir=b, **kw)
    equal = all(torch.equal(_full(x), _full(y)) for x, y in zip(first.params.parameters(),
                                                                 second.params.parameters()))
    moments = all(torch.equal(_full(first.opt_state.mu[n]), _full(second.opt_state.mu[n]))
                  for n in first.opt_state.mu)
    out = {"start": second.start, "losses": (first.losses[2:], second.losses),
           "params_equal": equal, "moments_equal": moments}
    train(cfg, ckpt_dir=one, ckpt_every=2, **kw)         # one device (rank 0 writes)
    if dist.get_rank() == 0:
        manifests = []
        for d in (a, one):
            with open(os.path.join(d, "step_000000004", "manifest.json")) as f:
                manifests.append(json.load(f)["leaves"])
        out["manifests_equal"] = manifests[0] == manifests[1]
    return out


def _grad_share(a, b) -> float:
    """max|a - b| over (1e-4 max|a| + 1e-6): at most 1 within
    ``tests/test_torch_training.py``'s gradient tolerance."""
    return float((a - b).abs().max() / (1e-4 * a.abs().max() + 1e-6))


def _moe_layer(cfg, mesh, policy, B=8, S=16):
    """``models.moe.apply_moe`` on ``mesh`` under ``policy``'s rules against
    its one-process oracle on the same weights and tokens: the all-to-all
    path against ``_moe_a2a`` with ``stacked_exchange`` (capacity per
    source shard), the others against ``apply_moe_local``.  (output's
    max|Δ| over max|out|, each gradient's share of its tolerance: the
    tokens, router and expert weights under loss = sum(out * r))."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.distributed.sharding import placements, use_rules
    from repro_torch.launch.steps import make_rules_for
    from repro_torch.models import moe as MoE

    rules = make_rules_for(mesh, B, policy)
    n = mesh.shape[mesh.mesh_dim_names.index("model")]
    g = torch.Generator().manual_seed(5)
    full = {k: v.detach().clone() for k, v in MoE.moe_init(g, cfg, torch.float32,
                                                            "cpu").items()}
    x = 0.5 * torch.randn((B, S, cfg.d_model), generator=g)
    r = torch.randn((B, S, cfg.d_model), generator=g)
    ref = {k: v.clone().requires_grad_(True) for k, v in full.items()}
    xr = x.clone().requires_grad_(True)
    if policy == "moe_a2a":
        xs = xr.view(B, n, S // n, -1).transpose(0, 1)
        want = MoE._moe_a2a(cfg, ref, xs, n, cfg.experts_p // n).transpose(0, 1)
        want = want.reshape(B, S, -1)
    else:
        want = MoE.apply_moe_local(ref, cfg, xr)
    (want * r).sum().backward()
    specs = MoE.moe_specs(cfg)
    pm = {k: distribute_tensor(v, mesh, placements(mesh, rules.pspec(specs[k])),
                               src_data_rank=None).requires_grad_(True)
          for k, v in full.items()}
    xm = distribute_tensor(x, mesh, placements(mesh, rules.pspec(("batch", "act_seq", None))),
                           src_data_rank=None).requires_grad_(True)
    with use_rules(rules):
        got = MoE.apply_moe(pm, cfg, xm)
        placed = list(got.placements) == list(xm.placements)
        (got * r).sum().full_tensor().backward()
    grads = {k: _grad_share(ref[k].grad, pm[k].grad.full_tensor()) for k in full}
    grads["x"] = _grad_share(xr.grad, xm.grad.full_tensor())
    return {"out": _rel(want.detach(), got.full_tensor().detach()), "grads": grads,
            "placed": placed}


def moe24(**_):
    """On a (2, 4) mesh: the reduced Granite and Qwen3-MoE under the four
    MoE policies (the forward's logits and 3 training steps against one
    device), the MoE layer with drops and with padded experts under each
    dispatch (output and gradients against its oracle), and ``decode_kv``
    on the reduced Qwen2 whose KV heads pad (``PADDED``: KV 2 -> 4, heads 6
    -> 12): prefill and decode against one device's run of the same
    padded config."""
    from repro_torch.configs.base import ShapeSpec, pad_for_mesh
    from repro_torch.distributed.sharding import use_rules
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.steps import build_cell, place
    from repro_torch.models import model as M

    mesh = make_test_mesh((2, 4), device_type="cpu")
    out = {"forward": {}, "train": {}, "layer": {}}
    for arch in MOE_ARCHS:
        cfg0, cfg = _cfg(arch, 4)
        tokens = _batch(cfg, 4, 32)["tokens"]
        with torch.no_grad():
            plain = M.forward(_params(cfg), cfg, tokens)
        for policy in MOE_POLICIES:
            _, (pspec, bspec), rules = build_cell(cfg0, ShapeSpec("p", 32, 4, "prefill"),
                                                  mesh, policy)
            with torch.no_grad(), use_rules(rules):
                pm = place(_params(cfg), pspec, mesh)
                sharded = _full(M.forward(pm, cfg, place(tokens, bspec["tokens"], mesh)))
            out["forward"][f"{arch}/{policy}"] = _rel(plain, sharded)
            out["train"][f"{arch}/{policy}"] = _train(cfg0, cfg, mesh, 8, 32, 3, policy)
    for name, changes in (("drops", DROPS), ("six", SIX)):
        _, cfg = _cfg("granite-moe-3b-a800m", 4, **changes)
        for policy in LAYER_POLICIES:
            out["layer"][f"{name}/{policy}"] = _moe_layer(cfg, mesh, policy)

    cfg0, _ = _cfg("qwen2-0.5b", 1, **PADDED)
    cfg = pad_for_mesh(cfg0, 4, pad_kv=True)
    tokens = _batch(cfg, 8, 16)["tokens"]
    errs = []
    with torch.no_grad():
        p1 = _params(cfg)
        logits, caches = M.prefill(p1, cfg, tokens, cache_len=20)
        pf, (pspec, bspec), _ = build_cell(cfg0, ShapeSpec("p", 16, 8, "prefill"), mesh,
                                           "decode_kv", cache_len=20)
        dec, (_, cspec, tspec), rules = build_cell(cfg0, ShapeSpec("d", 20, 8, "decode"),
                                                   mesh, "decode_kv")
        pm = place(_params(cfg), pspec, mesh)
        lm, cm = pf(pm, place({"tokens": tokens}, bspec, mesh))
        V = cfg.vocab_size
        errs.append(_rel(logits[:, :V], _full(lm)[:, :V]))
        tok = logits.argmax(-1).int()
        for i in range(4):
            logits, caches = M.decode_step(p1, cfg, tok, caches, 16 + i)
            lm, cm = dec(pm, cm, place(tok, tspec, mesh), 16 + i)
            errs.append(_rel(logits[:, :V], _full(lm)[:, :V]))
            tok = logits.argmax(-1).int()
        errs.append(max(_rel(a.float(), _full(b).float()) for c, d in zip(caches, cm)
                        for a, b in zip(c.values(), d.values())))
    out["decode_kv"] = {"errs": errs, "heads": [cfg.heads_p, cfg.kv_heads_p],
                        "cache_placements": [str(p) for p in cm[0]["k"].placements],
                        "wk_placements": [str(p) for p in pm.stack[0]["attn"]["wk"].placements]}
    return out


JOBS = {"mesh24": mesh24, "uneven": uneven, "checkpoint": checkpoint, "moe24": moe24}


def _rank(rank: int, world: int, store: str, job: str, tmp: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    try:
        result = JOBS[job](tmp=tmp)
        if rank == 0:
            with open(os.path.join(tmp, f"{job}.json"), "w") as f:
                json.dump(result, f)
    finally:
        dist.destroy_process_group()


def spawn(world: int, job: str, tmp) -> dict:
    tmp = str(tmp)
    mp.start_processes(_rank, args=(world, os.path.join(tmp, "store"), job, tmp),
                       nprocs=world, start_method="spawn")
    with open(os.path.join(tmp, f"{job}.json")) as f:
        return json.load(f)
