"""Logical-axis sharding on ``torch.distributed``'s DeviceMesh and DTensor.

Ports ``repro.distributed.sharding``: one rule table maps model-space axis
names to mesh axes (GSPMD style, as in MaxText/T5X).  Model code annotates
tensors with *logical* axes (``batch``, ``seq``, ``heads``, ``ff``,
``experts``, ``vocab`` ...); the active ``Rules`` (a contextvar, installed
by the ``build_*`` functions of ``launch.steps`` around a step) resolve them to
mesh axes.  With no rules installed every annotation returns its input
itself, so the same model code runs the one-device path (the card's kernels
and bits unchanged) and a mesh.

Meshes (``launch.mesh``): single-pod ``(16, 16) = ("data", "model")``;
multi-pod ``(2, 16, 16) = ("pod", "data", "model")``.  ``batch`` maps to
``("pod", "data")`` so the pod axis shards the global batch across pods.

A spec (the reference's ``PartitionSpec``) is a plain tuple, one entry per
tensor dim: ``None``, a mesh axis name, or a tuple of them.
``placements(mesh, spec)`` turns it into DTensor placements: for each mesh
dim ``Shard(d)`` where that axis appears in entry ``d``, else
``Replicate()``.  A tuple of axes on one dim shards it over each of them in
mesh order (DTensor's nesting, which is jax's ``P(("data", "model"))``
where the tuple is in mesh order; another order raises).

Under rules with a mesh, ``use_rules`` also enters DTensor's implicit
replication, so a plain tensor meeting a DTensor (positions, masks, rotary
tables) counts as replicated, as jax treats an unsharded constant.
``constrain`` redistributes a DTensor to its rule's placements (the
counterpart of ``with_sharding_constraint``); the framework inserts the
collectives.  Code that must see plain tensors (the CUDA kernels take
``data_ptr()``s) runs on local shards through ``local_region``.

Not ported, by design: ``shard_map`` (the reference's shim over jax's two
spellings); its one caller, MoE's expert-parallel path
(``models.moe.apply_moe``), runs on local shards through ``local_region``
with ``Partial`` outputs and an all-to-all.  Under every policy the
expert weights sit at ``("experts", "fsdp", None)``: the reference's
``P("model", "data", None)``.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from dataclasses import dataclass, field

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

__all__ = ["Rules", "DEFAULT_RULES", "make_default_rules", "make_fsdp_rules",
           "make_moe_noseq_rules", "make_moe_a2a_rules", "make_decode_kv_rules",
           "use_rules", "current_rules", "constrain", "logical_to_pspec", "named_sharding",
           "placements", "pspec_of", "axis_sizes", "tree_pspecs", "tree_shardings",
           "zero_specs", "shapes_of", "local_region", "shard_range", "like", "replicated"]


@dataclass
class Rules:
    """logical axis -> mesh axis (or tuple of mesh axes, or None).

    ``mesh`` (optional) is the ``DeviceMesh`` the specs resolve onto."""

    table: dict = field(default_factory=dict)
    mesh: object = None

    def resolve(self, logical: str | None):
        if logical is None:
            return None
        return self.table.get(logical)

    def pspec(self, logical_axes: tuple) -> tuple:
        return tuple(self.resolve(a) for a in logical_axes)


def make_default_rules(multi_pod: bool = False, *, seq_shard: bool = False) -> Rules:
    batch_axes = ("pod", "data") if multi_pod else ("data",)
    table = {
        "batch": batch_axes if len(batch_axes) > 1 else batch_axes[0],
        "batch_noshard": None,          # long-context B=1 cells
        "seq": "model" if seq_shard else None,  # SP for activations between blocks
        "act_seq": "model",             # residual-stream seq sharding (activation ZeRO)
        "embed": None,                  # d_model replicated
        "heads": "model",               # attention head dim (padded if uneven)
        "kv_heads": None,               # few KV heads (<=8) -> replicate
        "kv_seq": "model",              # decode KV-cache sequence sharding
        "ff": "model",                  # MLP hidden TP axis
        "experts": "model",             # expert parallelism
        "vocab": "model",               # embedding/logits TP
        "embed_tbl": "model",           # untied input table: d_model-sharded
        "opt": batch_axes if len(batch_axes) > 1 else batch_axes[0],  # ZeRO axis
        "fsdp": "data",                 # ZeRO-3 weight sharding (MoE experts)
        "ssm_inner": None,              # Mamba-2 runs pure-DP
        "lru": "model",                 # RG-LRU width TP
        # activation-side TP axes (split from the weight axes so policies
        # like FSDP can unshard activations while weights stay sharded)
        "act_heads": "model",
        "act_kv": None,
        "act_ff": "model",
        "act_vocab": "model",
        "act_lru": "model",
    }
    return Rules(table)


def make_fsdp_rules(multi_pod: bool = False, ep: bool = False) -> Rules:
    """ZeRO-3/FSDP policy: the batch shards over both mesh axes, weights keep
    their model-axis shards and are gathered at each use (again in the
    backward under remat); activations carry only the batch shard."""
    rules = make_default_rules(multi_pod)
    table = dict(rules.table)
    if ep:
        # MoE variant ("fsdp_ep"): the model axis keeps the experts, so the
        # batch stays on pod x data
        table["batch"] = ("pod", "data") if multi_pod else "data"
    else:
        table["batch"] = (("pod", "data", "model") if multi_pod
                          else ("data", "model"))
    table["act_seq"] = None        # no TP regions -> no seq sharding needed
    for a in ("act_heads", "act_kv", "act_ff", "act_lru"):
        table[a] = None
    # loss: vocab-parallel only when the model axis is free (ep variant)
    table["act_vocab"] = "model" if ep else None
    rules.table = table
    return rules


def make_moe_noseq_rules(multi_pod: bool = False) -> Rules:
    """MoE train policy: keep TP/EP, drop the sequence-sharded residual."""
    rules = make_default_rules(multi_pod)
    table = dict(rules.table)
    table["act_seq"] = None
    rules.table = table
    return rules


def make_moe_a2a_rules(multi_pod: bool = False) -> Rules:
    """MoE train policy: all-to-all token dispatch in the expert region."""
    rules = make_default_rules(multi_pod)
    table = dict(rules.table)
    table["moe_dispatch"] = "a2a"
    rules.table = table
    return rules


def make_decode_kv_rules(multi_pod: bool = False) -> Rules:
    """Decode policy: shard KV *heads* (padded up to the model axis) instead
    of the cache sequence."""
    rules = make_default_rules(multi_pod)
    table = dict(rules.table)
    table["kv_heads"] = "model"
    table["act_kv"] = "model"
    table["kv_seq"] = None
    rules.table = table
    return rules


DEFAULT_RULES = make_default_rules()

_active_rules: contextvars.ContextVar[Rules | None] = contextvars.ContextVar(
    "repro_torch_sharding_rules", default=None)


@contextlib.contextmanager
def _implicit_replication():
    """DTensor's implicit replication on, then back to what it was (its own
    ``experimental.implicit_replication`` switches it off on exit, also
    when nested, as a checkpoint's recompute nests ``use_rules``)."""
    dispatcher = DTensor._op_dispatcher
    before = dispatcher._allow_implicit_replication
    dispatcher._allow_implicit_replication = True
    try:
        yield
    finally:
        dispatcher._allow_implicit_replication = before


@contextlib.contextmanager
def use_rules(rules: Rules | None):
    """Install ``rules`` for the block; with a mesh, plain tensors that meet
    DTensors in it count as replicated."""
    token = _active_rules.set(rules)
    try:
        if rules is not None and rules.mesh is not None:
            with _implicit_replication():
                yield rules
        else:
            yield rules
    finally:
        _active_rules.reset(token)


def current_rules() -> Rules | None:
    return _active_rules.get()


def axis_sizes(mesh) -> dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` (or any object with
    ``mesh_dim_names`` and a ``shape`` tuple)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        raise TypeError(f"a mesh is a DeviceMesh with named dims, not {mesh!r}")
    return dict(zip(names, mesh.shape))


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements(mesh, spec: tuple) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: one per mesh dim.  A mesh
    axis of one device shards nothing: it stays ``Replicate()`` (the same
    bytes on the rank, and no layout DTensor must reason about)."""
    names = tuple(mesh.mesh_dim_names)
    sizes = dict(zip(names, getattr(mesh, "shape", ())))
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        axes = _axes(entry)
        dims = []
        for a in axes:
            if a not in names:
                raise ValueError(f"spec {spec}: no mesh axis {a!r} in {names}")
            if sizes.get(a) == 1:
                continue
            m = names.index(a)
            if out[m] != Replicate():
                raise ValueError(f"spec {spec}: mesh axis {a!r} used twice")
            out[m] = Shard(d)
            dims.append(m)
        if dims != sorted(dims):
            raise ValueError(f"spec {spec}: axes {axes} of dim {d} are not in mesh "
                             f"order {names}")
    return tuple(out)


def pspec_of(mesh, pl, ndim: int) -> tuple:
    """The spec of placements ``pl`` for a tensor of ``ndim`` dims (the
    inverse of ``placements``; a one-axis tuple comes back as its name)."""
    per_dim = [[] for _ in range(ndim)]
    for name, p in zip(mesh.mesh_dim_names, pl):
        if isinstance(p, Shard):
            per_dim[p.dim].append(name)
        elif not isinstance(p, Replicate):
            raise ValueError(f"{p} has no spec")
    return tuple(None if not a else a[0] if len(a) == 1 else tuple(a) for a in per_dim)


def _fit(rules: Rules, logical_axes: tuple, shape) -> tuple:
    """The mesh spec of ``logical_axes`` for a tensor of ``shape``: a dim of
    size 1, or one its mesh axes do not divide, left unsharded."""
    sizes = axis_sizes(rules.mesh)
    return tuple(None if n == 1 or n % math.prod(sizes[a] for a in _axes(e)) else e
                 for e, n in zip(rules.pspec(logical_axes), shape))


def constrain(x, logical_axes: tuple):
    """Annotate an activation with logical axes: ``x`` itself without rules
    (or without a mesh); under rules with a mesh, ``x`` (a plain tensor
    counts as replicated) redistributed to the axes' placements.  A dim of
    size 1 (a decode step's sequence), or one its mesh axes do not divide,
    stays unsharded: jax pads it over the shards, and DTensor could not
    view an uneven or size-1 shard away in a product."""
    rules = current_rules()
    if rules is None:
        return x
    if x.ndim != len(logical_axes):
        raise ValueError(f"rank {x.ndim} vs logical axes {logical_axes}")
    if rules.mesh is None:
        return x
    pl = placements(rules.mesh, _fit(rules, logical_axes, x.shape))
    if isinstance(x, DTensor) and tuple(x.placements) == pl:
        return x
    return _as_dtensor(x, rules.mesh).redistribute(rules.mesh, pl)


def logical_to_pspec(logical_axes: tuple, rules: Rules | None = None) -> tuple:
    rules = rules or current_rules() or DEFAULT_RULES
    return rules.pspec(logical_axes)


def named_sharding(mesh, logical_axes: tuple, rules: Rules | None = None) -> tuple:
    """Placements of ``logical_axes`` on ``mesh`` (the reference's
    ``NamedSharding``)."""
    return placements(mesh, logical_to_pspec(logical_axes, rules))


# ---------------------------------------------------------------------------
# tree-level helpers (used by ``launch.steps``)
# ---------------------------------------------------------------------------

def _tree_map(fn, tree, *rest):
    """``fn`` over the tuple leaves of nested dicts and lists."""
    if isinstance(tree, tuple):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    raise TypeError(f"not a spec tree: {type(tree).__name__}")


def tree_pspecs(spec_tree, rules: Rules):
    """Logical spec tree -> spec tree of mesh axes."""
    return _tree_map(rules.pspec, spec_tree)


def tree_shardings(mesh, spec_tree, rules: Rules):
    """Logical spec tree -> tree of placements on ``mesh``."""
    return _tree_map(lambda s: placements(mesh, rules.pspec(s)), spec_tree)


def zero_specs(spec_tree, shape_tree, rules: Rules, mesh, *, min_size=2**16):
    """ZeRO: give each large parameter's optimizer moments an extra sharded
    dim: the first one that is unsharded in the parameter's spec and
    divisible by the ``opt`` rule's mesh size.  Leaves below ``min_size``
    elements (norm scales, biases), and leaves already sharded on the
    ``opt`` axes (FSDP), keep the parameter's spec.  Returns a logical spec
    tree for the f32 moments."""
    opt_axes = _axes(rules.resolve("opt"))
    if not opt_axes:
        return spec_tree
    sizes = axis_sizes(mesh)
    divisor = math.prod(sizes[a] for a in opt_axes)

    def per_leaf(spec, shape):
        if math.prod(shape) < min_size:
            return spec
        used = {a for s in spec for a in _axes(rules.resolve(s))}
        if used & set(opt_axes):
            return spec
        for d, (s, size) in enumerate(zip(spec, shape)):
            if s is None and size % divisor == 0:
                return spec[:d] + ("opt",) + spec[d + 1:]
        return spec

    return _tree_map(per_leaf, spec_tree, shape_tree)


def shapes_of(tree):
    """A tree of tensors (dicts, lists, ``nn.Module``s by parameter name) ->
    the same tree of shape tuples."""
    if isinstance(tree, torch.nn.Module):
        return {n: tuple(p.shape) for n, p in tree.named_parameters()}
    if isinstance(tree, dict):
        return {k: shapes_of(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [shapes_of(v) for v in tree]
    return tuple(tree.shape)


# ---------------------------------------------------------------------------
# local shards: what the kernels see
# ---------------------------------------------------------------------------

def _as_dtensor(x, mesh) -> DTensor:
    if isinstance(x, DTensor):
        return x
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim, run_check=False)


def like(x, ref):
    """``x`` at ``ref``'s placements: ``x`` itself unless ``ref`` is a
    DTensor."""
    if not isinstance(ref, DTensor):
        return x
    return _as_dtensor(x, ref.device_mesh).redistribute(ref.device_mesh, ref.placements)


def replicated(x, dims: tuple):
    """``x`` with tensor ``dims`` replicated (every other dim keeps its
    shard); ``x`` itself for a plain tensor."""
    if not isinstance(x, DTensor):
        return x
    pl = tuple(Replicate() if isinstance(p, Shard) and p.dim in dims else p
               for p in x.placements)
    return x if pl == tuple(x.placements) else x.redistribute(x.device_mesh, pl)


def shard_range(x: DTensor, dim: int, pl=None) -> tuple[int, int]:
    """(offset, length) of this rank's shard of ``x`` along ``dim`` at its
    placements (or at ``pl``), for an even split (DTensor's nesting: mesh
    dims left to right)."""
    mesh, size = x.device_mesh, x.shape[dim]
    coord = mesh.get_coordinate()
    offset, length = 0, size
    for m, p in enumerate(x.placements if pl is None else pl):
        if isinstance(p, Shard) and p.dim == dim:
            n = mesh.size(m)
            if length % n:
                raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split evenly "
                                 f"over {x.placements}")
            length //= n
            offset += coord[m] * length
    return offset, length


def local_region(fn, args, in_axes, out_axes, out_placements=None, in_placements=None):
    """``fn`` on the local shards of ``args``: plain tensors, never DTensors.

    Without rules (or a mesh) ``fn(*args)`` as it is.  Otherwise each arg
    (``None`` passes through) is redistributed to the placements of its
    logical axes in ``in_axes`` (``constrain``'s rule: a dim of size 1 or
    one its mesh axes do not divide stays unsharded), or to its entry of
    ``in_placements`` where that is not ``None``, and its local shard
    handed to ``fn``; each output of ``fn`` (a tensor or a tuple) is
    wrapped as a DTensor at the placements of ``out_axes`` (an axis some
    input could not shard left unsharded), or at the explicit
    ``out_placements`` (which may hold ``Partial()``: each rank's output a
    term of the sum).  The region is differentiable: on a mesh dim where
    an input is replicated but an output is sharded or partial, the work
    is split over that dim, so the input's gradient there is a partial sum
    (``Partial``)."""
    rules = current_rules()
    if rules is None or rules.mesh is None:
        if any(isinstance(a, DTensor) for a in args):
            raise RuntimeError("local_region got DTensors with no mesh rules active (a "
                               "recompute outside use_rules?): fn needs local shards")
        return fn(*args)
    mesh = rules.mesh
    single = not isinstance(out_axes, list)
    in_placements = in_placements or [None] * len(args)
    pls, dropped = [], set()
    for a, axes, given in zip(args, in_axes, in_placements):
        if a is None or given is not None:
            pls.append(given)
            continue
        spec = _fit(rules, axes, a.shape)
        dropped |= {name for name, e, f in zip(axes, rules.pspec(axes), spec)
                    if e is not None and f is None}
        pls.append(placements(mesh, spec))
    out_pl = out_placements or [
        placements(mesh, rules.pspec(tuple(None if n in dropped else n for n in axes)))
        for axes in ([out_axes] if single else out_axes)]
    split = {m for pl in out_pl for m, p in enumerate(pl) if not isinstance(p, Replicate)}
    local = []
    for a, pl in zip(args, pls):
        if a is None:
            local.append(None)
            continue
        grad_pl = [Partial() if isinstance(p, Replicate) and m in split else p
                   for m, p in enumerate(pl)]
        d = _as_dtensor(a, mesh)
        if tuple(d.placements) != tuple(pl):
            d = d.redistribute(mesh, pl)
        local.append(d.to_local(grad_placements=grad_pl))
    outs = fn(*local)
    outs = (outs,) if single else outs
    wrapped = tuple(DTensor.from_local(o, mesh, pl, run_check=False)
                    for o, pl in zip(outs, out_pl))
    return wrapped[0] if single else wrapped
