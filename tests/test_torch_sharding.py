"""The port's logical-axis sharding tables against the JAX package's, on the CPU.

``repro_torch.distributed.sharding`` and ``launch.steps.make_rules_for``
hold data: rule tables, specs resolved through them, and the ZeRO specs of
the optimizer moments.  Each is compared with the reference's on the same
inputs, exactly.  Meshes are stand-ins carrying only what the functions
read: the reference's ``make_rules_for`` and ``zero_specs`` read
``.axis_names`` and ``.shape`` (a dict), the port's the ``DeviceMesh``
attributes ``.mesh_dim_names`` and ``.shape`` (a tuple), so no process
group is needed for the (16, 16) and (2, 16, 16) meshes.  A spec from the
reference (a ``PartitionSpec``) is compared as ``tuple(spec)``.
"""

from types import SimpleNamespace

import jax
import pytest
import torch
from jax.sharding import PartitionSpec as P
from torch.distributed.tensor import Replicate, Shard

from repro.configs.base import get_config as jax_get_config
from repro.configs.base import pad_for_mesh as jax_pad_for_mesh
from repro.distributed import sharding as JS
from repro.launch import steps as jax_steps
from repro.models import model as JM
from repro_torch.configs.base import get_config, list_configs, pad_for_mesh
from repro_torch.distributed import sharding as TS
from repro_torch.launch import steps as torch_steps
from repro_torch.models import model as TM

MESHES = [(1, 1), (2, 4), (16, 16), (2, 16, 16)]
POLICIES = ["default", "fsdp", "fsdp_ep", "moe_noseq", "moe_a2a", "decode_kv"]
MAKERS = {"default": (JS.make_default_rules, TS.make_default_rules),
          "default_seq": (lambda mp: JS.make_default_rules(mp, seq_shard=True),
                          lambda mp: TS.make_default_rules(mp, seq_shard=True)),
          "fsdp": (JS.make_fsdp_rules, TS.make_fsdp_rules),
          "fsdp_ep": (lambda mp: JS.make_fsdp_rules(mp, ep=True),
                      lambda mp: TS.make_fsdp_rules(mp, ep=True)),
          "moe_noseq": (JS.make_moe_noseq_rules, TS.make_moe_noseq_rules),
          "moe_a2a": (JS.make_moe_a2a_rules, TS.make_moe_a2a_rules),
          "decode_kv": (JS.make_decode_kv_rules, TS.make_decode_kv_rules)}


def _names(shape):
    return ("pod", "data", "model") if len(shape) == 3 else ("data", "model")


def _meshes(shape):
    """(the reference's stand-in, the port's stand-in) of one mesh shape."""
    names = _names(shape)
    return (SimpleNamespace(axis_names=names, shape=dict(zip(names, shape))),
            SimpleNamespace(mesh_dim_names=names, shape=tuple(shape)))


def _plain(tree):
    """The reference's tree with every ``PartitionSpec`` as a tuple."""
    return jax.tree.map(tuple, tree, is_leaf=lambda x: isinstance(x, P))


# -- the rule tables -------------------------------------------------------------------

def test_every_reference_name_is_ported_but_shard_map():
    assert set(JS.__all__) - {"shard_map"} <= set(TS.__all__)
    assert not hasattr(TS, "shard_map")


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("maker", sorted(MAKERS))
def test_every_rule_table_equals_the_reference(maker, multi_pod):
    want, got = (make(multi_pod) for make in MAKERS[maker])
    assert got.table == want.table
    assert got.mesh is None and want.mesh is None


def test_default_rules_and_resolve():
    assert TS.DEFAULT_RULES.table == JS.DEFAULT_RULES.table
    rules = TS.make_default_rules()
    assert rules.resolve(None) is None and rules.resolve("no such axis") is None
    assert rules.pspec(("batch", None, "heads")) == ("data", None, "model")
    assert TS.logical_to_pspec(("vocab", "embed")) == tuple(JS.logical_to_pspec(("vocab",
                                                                                 "embed")))


@pytest.mark.parametrize("batch", [1, 8, 256])
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
def test_make_rules_for_equals_the_reference(shape, policy, batch):
    jmesh, tmesh = _meshes(shape)
    want = jax_steps.make_rules_for(jmesh, batch, policy)
    got = torch_steps.make_rules_for(tmesh, batch, policy)
    assert got.table == want.table
    assert got.mesh is tmesh


# -- specs of the trees ----------------------------------------------------------------

TREE_CASES = [pytest.param(arch, tp, id=f"{arch}-tp{tp}")
              for arch in list_configs() for tp in (1, 4, 16)]


@pytest.mark.parametrize("arch,tp", TREE_CASES)
def test_tree_pspecs_and_zero_specs_equal_the_reference(arch, tp):
    """Every registered config, published width, padded at tp: the resolved
    parameter and cache specs under each dense policy, and the moments'
    ZeRO specs on the reference's stacked shapes, on (16, 16) and
    (2, 16, 16)."""
    jcfg = jax_pad_for_mesh(jax_get_config(arch), tp)
    tcfg = pad_for_mesh(get_config(arch), tp)
    specs, cspecs = JM.param_specs(jcfg), JM.cache_specs(jcfg)
    assert TM.param_specs(tcfg) == specs and TM.cache_specs(tcfg) == cspecs
    shapes = jax.eval_shape(lambda: JM.init_params(jax.random.PRNGKey(0), jcfg))
    shapes = JS.shapes_of(shapes)
    for shape in [(16, 16), (2, 16, 16)]:
        jmesh, tmesh = _meshes(shape)
        for policy in ("default", "fsdp"):
            jrules = jax_steps.make_rules_for(jmesh, 256, policy)
            trules = torch_steps.make_rules_for(tmesh, 256, policy)
            assert TS.tree_pspecs(specs, trules) == _plain(JS.tree_pspecs(specs, jrules))
            assert TS.tree_pspecs(cspecs, trules) == _plain(JS.tree_pspecs(cspecs, jrules))
            want = JS.zero_specs(specs, shapes, jrules, jmesh)
            assert TS.zero_specs(specs, shapes, trules, tmesh) == want


MOE_CASES = [pytest.param(arch, policy, id=f"{arch}-{policy}")
             for arch in ("granite-moe-3b-a800m", "qwen3-moe-235b-a22b") for policy in POLICIES]


@pytest.mark.parametrize("arch,policy", MOE_CASES)
def test_expert_placements_under_every_policy_equal_the_reference(arch, policy):
    """The MoE configs at published width, padded for a model axis of 16
    (with ``pad_kv`` under ``decode_kv``, as ``build_cell`` pads): every
    parameter and cache spec and the moments' ZeRO specs equal the
    reference's under each policy; the expert weights resolve to the
    reference's ``shard_map`` in-spec ``P("model", "data", None)`` (the
    ``pod`` axis left out) and the router to ``P(None, None)``, and their
    DTensor placements shard experts over ``model`` and d over ``data``."""
    pad_kv = policy == "decode_kv"
    jcfg = jax_pad_for_mesh(jax_get_config(arch), 16, pad_kv=pad_kv)
    tcfg = pad_for_mesh(get_config(arch), 16, pad_kv=pad_kv)
    specs, cspecs = JM.param_specs(jcfg), JM.cache_specs(jcfg)
    shapes = JS.shapes_of(jax.eval_shape(lambda: JM.init_params(jax.random.PRNGKey(0), jcfg)))
    named = TM.named_param_specs(tcfg)
    for shape in [(16, 16), (2, 16, 16)]:
        jmesh, tmesh = _meshes(shape)
        jrules = jax_steps.make_rules_for(jmesh, 256, policy)
        trules = torch_steps.make_rules_for(tmesh, 256, policy)
        assert TS.tree_pspecs(specs, trules) == _plain(JS.tree_pspecs(specs, jrules))
        assert TS.tree_pspecs(cspecs, trules) == _plain(JS.tree_pspecs(cspecs, jrules))
        assert TS.zero_specs(specs, shapes, trules, tmesh) == JS.zero_specs(specs, shapes,
                                                                            jrules, jmesh)
        experts = {n: trules.pspec(s) for n, s in named.items() if n.endswith(
            ("ffn.w_gate", "ffn.w_up", "ffn.w_down"))}
        routers = {n: trules.pspec(s) for n, s in named.items() if n.endswith("ffn.router")}
        assert len(experts) == 3 * tcfg.n_layers and len(routers) == tcfg.n_layers
        assert set(experts.values()) == {("model", "data", None)}
        assert set(routers.values()) == {(None, None)}
        pl = TS.placements(tmesh, ("model", "data", None))
        assert pl[-1] == Shard(0) and pl[-2] == Shard(1)
        assert all(p == Replicate() for p in pl[:-2])


def test_zero_specs_of_the_ports_named_parameters():
    """On the port's per-layer tensors: a large leaf gets ``opt`` on its
    first unsharded dim divisible by the data axes, a small one or one
    already on them keeps its spec, and no ``opt`` without the rule."""
    cfg = get_config("qwen2-0.5b")
    meta = TM.init_params(cfg, torch.Generator(), device="meta")
    specs = TM.named_param_specs(cfg)
    shapes = TS.shapes_of(meta)
    assert set(specs) == set(shapes)
    _, mesh = _meshes((16, 16))
    rules = torch_steps.make_rules_for(mesh, 256, "default")
    zero = TS.zero_specs(specs, shapes, rules, mesh)
    assert zero["stack.0.ffn.w_up"] == ("opt", "ff")                   # (896, 4864)
    assert zero["stack.0.attn.wo"] == ("heads", "opt", None)           # (14, 64, 896)
    assert zero["final_norm.scale"] == ("embed",)                      # 896 < 2**16
    fsdp = torch_steps.make_rules_for(mesh, 256, "fsdp")
    assert TS.zero_specs(specs, shapes, fsdp, mesh)["stack.0.ffn.w_up"] == ("opt", "ff")
    off = torch_steps.make_rules_for(mesh, 1, "default")               # batch 1: no ZeRO
    assert TS.zero_specs(specs, shapes, off, mesh) == specs


def test_shapes_of_trees_and_modules():
    params = TM.init_params(get_config("mamba2-130m", reduced=True), torch.Generator(),
                            device="meta")
    shapes = TS.shapes_of(params)
    assert shapes == {n: tuple(p.shape) for n, p in params.named_parameters()}
    tree = {"a": [torch.zeros(2, 3), {"b": torch.zeros(())}]}
    assert TS.shapes_of(tree) == {"a": [(2, 3), {"b": ()}]}


# -- placements ------------------------------------------------------------------------

def _all_resolved_specs():
    out = set()
    for arch in list_configs():
        cfg = pad_for_mesh(get_config(arch), 16)
        for policy in POLICIES:
            rules = torch_steps.make_rules_for(_meshes((2, 16, 16))[1], 256, policy)
            for tree in (TM.named_param_specs(cfg), TM.layer_cache_specs(cfg)):
                leaves = tree.values() if isinstance(tree, dict) else [
                    s for layer in tree for s in layer.values()]
                out.update(rules.pspec(s) for s in leaves)
    return sorted(out, key=repr)


def test_placements_round_trip_through_specs():
    """Every spec the registered configs resolve to under every policy
    (which fit the mesh) goes to placements and back; a one-axis tuple
    comes back as its name."""
    mesh = SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    seen = 0
    for spec in _all_resolved_specs():
        try:
            pl = TS.placements(mesh, spec)
        except ValueError:
            continue                 # fsdp's batch and a model-sharded dim: the mesh axis twice
        seen += 1
        assert len(pl) == 3
        norm = tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in spec)
        assert TS.pspec_of(mesh, pl, len(spec)) == norm
    assert seen > 15


def test_placements_of_specs():
    mesh = SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    assert TS.placements(mesh, (("pod", "data"), None, "model")) == (Shard(0), Shard(0),
                                                                      Shard(2))
    assert TS.placements(mesh, (None, None)) == (Replicate(),) * 3
    assert TS.named_sharding(mesh, ("batch", "vocab"),
                             TS.make_default_rules(True)) == (Shard(0), Shard(0), Shard(1))
    with pytest.raises(ValueError, match="twice"):
        TS.placements(mesh, ("model", "model"))
    with pytest.raises(ValueError, match="no mesh axis"):
        TS.placements(mesh, ("expert",))
    with pytest.raises(ValueError, match="mesh order"):
        TS.placements(mesh, (("data", "pod"),))


# -- rules in context ------------------------------------------------------------------

def test_constrain_returns_its_input_without_rules():
    x = torch.randn(2, 3, 4)
    assert TS.current_rules() is None
    assert TS.constrain(x, ("batch", "act_seq", None)) is x
    with TS.use_rules(TS.make_default_rules()):          # rules, but no mesh
        assert TS.constrain(x, ("batch", "act_seq", None)) is x
        with pytest.raises(ValueError, match="rank 3"):
            TS.constrain(x, ("batch", None))
    assert TS.constrain(x, ("batch",)) is x              # no rules: no check either
    assert TS.like(x, torch.zeros(1)) is x and TS.replicated(x, (0,)) is x
    assert TS.local_region(lambda a: a * 2, (x,), (("batch", None, None),),
                           ("batch", None, None)).equal(x * 2)


def test_use_rules_nests_and_restores():
    a, b = TS.make_default_rules(), TS.make_fsdp_rules()
    with TS.use_rules(a):
        assert TS.current_rules() is a
        with TS.use_rules(b):
            assert TS.current_rules() is b
            assert TS.logical_to_pspec(("batch",)) == (("data", "model"),)
        assert TS.current_rules() is a
    assert TS.current_rules() is None


def test_mesh_module_touches_no_device_state_on_import():
    import importlib

    import torch.distributed as dist

    from repro_torch.launch import mesh

    before = dist.is_initialized()
    importlib.reload(mesh)
    assert dist.is_initialized() == before
