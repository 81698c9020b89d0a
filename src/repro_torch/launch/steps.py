"""Step-function and sharding assembly for the launchers.

Ports ``repro.launch.steps``.  Without a mesh, ``build_train`` returns the
one-device ``(train_step, (params, opt_state, batch))`` with the inputs'
abstract shapes on PyTorch's ``meta`` device (no allocation, no weights
drawn), and ``build_prefill`` / ``build_decode`` likewise.

With a ``DeviceMesh`` each ``build_*`` returns ``(step, abstract inputs,
rules)`` for an (arch config, shape, mesh) cell, as the reference does.
The abstract inputs are trees of ``TensorSpec`` (shape, dtype and DTensor
placements; placements ``None`` for the optimizer's step counter, a plain
tensor on every rank): the parameters by ``named_parameters()`` name, the
optimizer state (moments at their ZeRO placements, ``sharding.zero_specs``),
the batch, the caches.  ``place`` distributes full tensors to them: weights
are drawn whole from the seed's generator on every rank, then each rank
keeps its shard (no draw per rank, so the sharded parameters equal the
one-device ones bit for bit).  The step runs under the cell's ``Rules``
and returns its metrics as plain tensors, the same on every rank; it
raises if a parameter or moment is not at its placements.  The batch is
replicated (and ZeRO off) where the global batch does not divide the
data-parallel size.

``build_cell`` pads the config for the mesh's model axis
(``pad_for_mesh``, with ``pad_kv`` under ``decode_kv``, as the reference
does) and dispatches on the shape's kind.  Every family runs under each of
the reference's six policies (``_MESH_POLICIES``): ``default``, ``fsdp``,
``fsdp_ep``, ``moe_noseq``, ``moe_a2a`` (MoE layers through
``models.moe.apply_moe``'s expert parallelism) and ``decode_kv`` (KV heads
and caches sharded over ``model``).  A policy neither package knows raises
``KeyError`` in ``make_rules_for``; a mesh that is not a ``DeviceMesh``
raises ``TypeError``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch import resolve_device
from repro_torch.configs.base import pad_for_mesh
from repro_torch.distributed.sharding import (Rules, axis_sizes, constrain,
                                              make_decode_kv_rules, make_default_rules,
                                              make_fsdp_rules, make_moe_a2a_rules,
                                              make_moe_noseq_rules, placements, use_rules,
                                              zero_specs)
from repro_torch.models import model as M
from repro_torch.training.optimizer import OptimizerConfig, OptState, init_opt_state
from repro_torch.training.train_loop import make_train_step

__all__ = ["TensorSpec", "make_rules_for", "build_train", "build_prefill", "build_decode",
           "build_cell", "place"]

_MAKERS = {"default": make_default_rules, "fsdp": make_fsdp_rules,
           "fsdp_ep": lambda mp: make_fsdp_rules(mp, ep=True),
           "moe_noseq": make_moe_noseq_rules,
           "moe_a2a": make_moe_a2a_rules,
           "decode_kv": make_decode_kv_rules}
_MESH_POLICIES = tuple(_MAKERS)


class TensorSpec(NamedTuple):
    """An abstract input: shape, dtype and DTensor placements (``None``: a
    plain tensor, the same on every rank)."""

    shape: tuple
    dtype: torch.dtype
    placements: tuple | None


def make_rules_for(mesh, global_batch: int, policy: str = "default") -> Rules:
    """The policy's rules on ``mesh`` (a ``DeviceMesh``: its
    ``mesh_dim_names`` and shape).  Where ``global_batch`` does not divide
    the data-parallel size (pod x data, x model under ``fsdp``), the batch
    is replicated and ZeRO is off."""
    sizes = axis_sizes(mesh)
    multi_pod = "pod" in sizes
    rules = _MAKERS[policy](multi_pod)
    rules.mesh = mesh
    dp = sizes.get("data", 1) * sizes.get("pod", 1)
    if policy == "fsdp":
        dp *= sizes.get("model", 1)
    if global_batch % dp != 0:
        # cannot shard the batch evenly (e.g. B=1 long-context): replicate
        rules.table = dict(rules.table)
        rules.table["batch"] = None
        rules.table["opt"] = None
    return rules


def _abstract_batch(cfg, global_batch: int, seq_len: int) -> dict:
    """The batch's tensors on the meta device: tokens (B, S) int32 and, for
    a config with a frontend, embeds (B, n_prefix, d) float32."""
    meta = torch.device("meta")
    batch = {"tokens": torch.empty((global_batch, seq_len), dtype=torch.int32, device=meta)}
    if cfg.frontend is not None:
        batch["embeds"] = torch.empty((global_batch, cfg.n_prefix, cfg.d_model),
                                      dtype=torch.float32, device=meta)
    return batch


def _spec(t: torch.Tensor, mesh, rules, axes) -> TensorSpec:
    return TensorSpec(tuple(t.shape), t.dtype, placements(mesh, rules.pspec(axes)))


def _batch_axes(name: str) -> tuple:
    return ("batch", None) if name == "tokens" else ("batch", None, None)


def _abstract_params(cfg, mesh, rules) -> dict:
    meta = M.init_params(cfg, torch.Generator(), device="meta")
    specs = M.named_param_specs(cfg)
    return {n: _spec(p, mesh, rules, specs[n]) for n, p in meta.named_parameters()}


def _abstract_caches(cfg, batch: int, cache_len: int, mesh, rules) -> list:
    caches = M.cache_init(cfg, batch, cache_len, device="meta")
    return [{k: _spec(t, mesh, rules, specs[k]) for k, t in cache.items()}
            for cache, specs in zip(caches, M.layer_cache_specs(cfg))]


def place(tree, spec_tree, mesh):
    """Full tensors -> the same tree at ``spec_tree``'s placements on
    ``mesh``: an ``nn.Module``'s parameters are replaced in place by DTensor
    parameters (``requires_grad`` kept) and the module returned; every rank
    keeps its shard of the tensor it holds (no communication)."""
    if isinstance(tree, nn.Module):
        for name, p in list(tree.named_parameters()):
            owner, _, leaf = name.rpartition(".")
            d = place(p.detach(), spec_tree[name], mesh)
            tree.get_submodule(owner)[leaf] = nn.Parameter(d, requires_grad=p.requires_grad)
        return tree
    if isinstance(tree, OptState):
        return OptState(*(place(t, s, mesh) for t, s in zip(tree, spec_tree)))
    if isinstance(tree, dict):
        return {k: place(v, spec_tree[k], mesh) for k, v in tree.items()}
    if isinstance(tree, list):
        return [place(v, s, mesh) for v, s in zip(tree, spec_tree)]
    if tuple(tree.shape) != tuple(spec_tree.shape) or tree.dtype != spec_tree.dtype:
        raise ValueError(f"{tuple(tree.shape)} {tree.dtype} is not {spec_tree}")
    if spec_tree.placements is None:
        return tree
    return distribute_tensor(tree, mesh, spec_tree.placements, src_data_rank=None)


def _check_placed(tensors: dict, specs: dict, what: str) -> None:
    for name, t in tensors.items():
        want = specs[name].placements
        if not isinstance(t, DTensor) or tuple(t.placements) != want:
            got = t.placements if isinstance(t, DTensor) else "a plain tensor"
            raise ValueError(f"{what} {name} is {got}, not at {want}: use launch.steps.place")


def _plain(metrics: dict) -> dict:
    return {k: v.full_tensor() if isinstance(v, DTensor) else v for k, v in metrics.items()}


def build_train(cfg, shape, mesh=None, *, device="cuda", n_microbatches: int = 1,
                opt_cfg: OptimizerConfig | None = None, policy: str = "default"):
    """The training step of an (arch config, shape) cell: ``shape`` has
    ``global_batch`` and ``seq_len`` (a ``configs.base.ShapeSpec``).

    Without a mesh: ``(train_step, (params, opt_state, batch))`` for one
    device, the inputs on the meta device; ``train_step`` runs on
    ``device``'s tensors (resolved here, so a missing card raises now).
    With a mesh: ``(step, (params, opt_state, batch), rules)``, the inputs
    as ``TensorSpec`` trees (``place`` puts full tensors there); ``device``
    is the mesh's.  ``n_microbatches`` must divide each rank's batch."""
    opt_cfg = opt_cfg or OptimizerConfig()
    if mesh is None:
        resolve_device(device)
        if shape.global_batch % n_microbatches:
            raise ValueError(f"batch {shape.global_batch} not divisible by {n_microbatches} "
                             f"microbatches")
        params = M.init_params(cfg, torch.Generator(), device="meta")
        step_fn = make_train_step(cfg, opt_cfg, n_microbatches)
        return step_fn, (params, init_opt_state(params),
                         _abstract_batch(cfg, shape.global_batch, shape.seq_len))
    rules = make_rules_for(mesh, shape.global_batch, policy)
    params = _abstract_params(cfg, mesh, rules)
    pspecs = M.named_param_specs(cfg)
    zspecs = zero_specs(pspecs, {n: s.shape for n, s in params.items()}, rules, mesh)
    moments = {n: TensorSpec(s.shape, torch.float32,
                             placements(mesh, rules.pspec(zspecs[n])))
               for n, s in params.items()}
    opt = OptState(step=TensorSpec((), torch.int32, None), mu=moments, nu=dict(moments))
    batch = {k: _spec(t, mesh, rules, _batch_axes(k))
             for k, t in _abstract_batch(cfg, shape.global_batch, shape.seq_len).items()}
    step_fn = make_train_step(cfg, opt_cfg, n_microbatches)

    def train_step(params_, opt_state, batch_):
        _check_placed(dict(params_.named_parameters()), params, "parameter")
        _check_placed(opt_state.mu, moments, "first moment")
        _check_placed(opt_state.nu, moments, "second moment")
        with use_rules(rules):
            params_, opt_state, metrics = step_fn(params_, opt_state, batch_)
        return params_, opt_state, _plain(metrics)

    return train_step, (params, opt, batch), rules


def build_prefill(cfg, shape, mesh=None, *, device="cuda", policy: str = "default",
                  cache_len: int | None = None):
    """The prompt step: ``prefill(params, batch) -> (logits (B, V) f32,
    caches of cache_len slots)``, ``cache_len`` by default the prompt's
    ``shape.seq_len`` (a longer cache leaves room for ``build_decode``'s
    steps).  Without a mesh ``(prefill, (params, batch))`` on the meta
    device; with one ``(prefill, (params, batch), rules)``, logits at
    ("batch", "vocab") and caches at their specs' placements."""
    cache_len = cache_len or shape.seq_len
    if mesh is None:
        resolve_device(device)

        def prefill(params, batch):
            return M.prefill(params, cfg, batch["tokens"], cache_len=cache_len,
                             embeds=batch.get("embeds"))

        return prefill, (M.init_params(cfg, torch.Generator(), device="meta"),
                         _abstract_batch(cfg, shape.global_batch, shape.seq_len))
    rules = make_rules_for(mesh, shape.global_batch, policy)
    params = _abstract_params(cfg, mesh, rules)
    batch = {k: _spec(t, mesh, rules, _batch_axes(k))
             for k, t in _abstract_batch(cfg, shape.global_batch, shape.seq_len).items()}

    def prefill(params_, batch_):
        _check_placed(dict(params_.named_parameters()), params, "parameter")
        with use_rules(rules):
            logits, caches = M.prefill(params_, cfg, batch_["tokens"], cache_len=cache_len,
                                       embeds=batch_.get("embeds"))
            return constrain(logits, ("batch", "vocab")), caches

    return prefill, (params, batch), rules


def build_decode(cfg, shape, mesh=None, *, device="cuda", policy: str = "default"):
    """serve_step: ONE new token against caches of shape.seq_len slots,
    ``decode(params, caches, token (B,), pos: int) -> (logits (B, V) f32,
    caches)``, the caches updated in place.  Without a mesh ``(decode,
    (params, caches, token))`` on the meta device; with one ``(decode,
    (params, caches, token), rules)``."""
    B = shape.global_batch
    if mesh is None:
        resolve_device(device)

        def decode(params, caches, token, pos: int):
            return M.decode_step(params, cfg, token, caches, pos)

        return decode, (M.init_params(cfg, torch.Generator(), device="meta"),
                        M.cache_init(cfg, B, shape.seq_len, device="meta"),
                        torch.empty((B,), dtype=torch.int32, device="meta"))
    rules = make_rules_for(mesh, B, policy)
    params = _abstract_params(cfg, mesh, rules)
    caches = _abstract_caches(cfg, B, shape.seq_len, mesh, rules)
    token = TensorSpec((B,), torch.int32, placements(mesh, rules.pspec(("batch",))))

    def decode(params_, caches_, token_, pos: int):
        _check_placed(dict(params_.named_parameters()), params, "parameter")
        with use_rules(rules):
            logits, caches_ = M.decode_step(params_, cfg, token_, caches_, pos)
            return constrain(logits, ("batch", "vocab")), caches_

    return decode, (params, caches, token), rules


def build_cell(cfg, shape, mesh=None, policy: str = "default", **kw):
    """The step of a cell: ``cfg`` padded for the mesh's model axis (KV
    heads too under ``decode_kv``), then ``build_train`` /
    ``build_prefill`` / ``build_decode`` by ``shape.kind``."""
    if mesh is not None:
        cfg = pad_for_mesh(cfg, axis_sizes(mesh).get("model", 1),
                           pad_kv=(policy == "decode_kv"))
    if shape.kind == "train":
        return build_train(cfg, shape, mesh, policy=policy, **kw)
    if shape.kind == "prefill":
        return build_prefill(cfg, shape, mesh, policy=policy, **kw)
    return build_decode(cfg, shape, mesh, policy=policy, **kw)
