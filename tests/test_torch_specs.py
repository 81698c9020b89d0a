"""The port's ``*_specs`` helpers against the JAX package's, on the CPU.

Every helper returns the reference's tree of logical sharding axes (plain
tuples of axis names) on every registered config, published and reduced,
unpadded and padded (``pad_for_mesh`` at tp 4, and at tp 8 with
``pad_kv``), and ``attention.cache_specs`` with and without a window.  Then
the specs fit the port's trees: with the leading (layer) axis of a
``groups`` spec dropped, every parameter and cache tensor of the port
(drawn on the ``meta`` device at published width) has a spec of its rank,
and every spec a tensor.
"""

import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.configs.base import pad_for_mesh as jax_pad_for_mesh
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import model as JM
from repro.models import moe as JMoE
from repro.models import rglru as JR
from repro.models import ssm as JS
from repro.models import transformer as JT
from repro_torch.configs.base import get_config, list_configs, pad_for_mesh
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import moe as TMoE
from repro_torch.models import rglru as TR
from repro_torch.models import ssm as TS
from repro_torch.models import transformer as TT

PADDINGS = [(0, False), (4, False), (8, True)]
CASES = [pytest.param(arch, small, tp, kv,
                      id=f"{arch}-{'reduced' if small else 'published'}"
                         + (f"-tp{tp}{'kv' if kv else ''}" if tp else ""))
         for arch in list_configs() for small in (False, True) for tp, kv in PADDINGS]


def _cfgs(arch, small, tp, kv):
    want, got = jax_get_config(arch, reduced=small), get_config(arch, reduced=small)
    if tp:
        want, got = jax_pad_for_mesh(want, tp, kv), pad_for_mesh(got, tp, kv)
    return want, got


@pytest.mark.parametrize("arch,small,tp,kv", CASES)
def test_every_specs_helper_equals_the_reference(arch, small, tp, kv):
    want, got = _cfgs(arch, small, tp, kv)
    assert TM.param_specs(got) == JM.param_specs(want)
    assert TM.cache_specs(got) == JM.cache_specs(want)
    assert TT.stack_specs(got) == JT.stack_specs(want)
    assert TT.stack_cache_specs(got) == JT.stack_cache_specs(want)
    for kind in set(got.block_pattern) | set(got.tail_pattern):
        assert TT.block_specs(got, kind) == JT.block_specs(want, kind), kind
        assert TT.block_cache_specs(got, kind) == JT.block_cache_specs(want, kind), kind
    assert TA.attention_specs(got) == JA.attention_specs(want)
    assert TL.mlp_specs(got) == JL.mlp_specs(want)
    assert TL.embedding_specs(got) == JL.embedding_specs(want)
    assert TL.norm_specs(got.norm_type) == JL.norm_specs(want.norm_type)
    assert TMoE.moe_specs(got) == JMoE.moe_specs(want)
    assert TS.ssm_specs(got) == JS.ssm_specs(want)
    assert TS.ssm_cache_specs(got) == JS.ssm_cache_specs(want)
    assert TR.rglru_specs(got) == JR.rglru_specs(want)
    assert TR.rglru_cache_specs(got) == JR.rglru_cache_specs(want)


@pytest.mark.parametrize("window", [0, 16, 2_048])
def test_cache_specs_with_and_without_a_window(window):
    assert TA.cache_specs(window) == JA.cache_specs(window)
    assert TA.cache_specs(window)["k"][1] == (None if window else "kv_seq")


@pytest.mark.parametrize("norm_type", ["rms", "layer"])
def test_norm_specs_both_norms(norm_type):
    assert TL.norm_specs(norm_type) == JL.norm_specs(norm_type)


def _layer_spec(stack_specs, cfg, layer: int) -> dict:
    """The spec tree of the port's layer ``layer``: its group's spec with
    the leading layer axis dropped, or its tail entry."""
    P = len(cfg.block_pattern)
    if layer < cfg.n_groups * P:
        i = layer % P
        tree = stack_specs["groups"][f"b{i}_{cfg.block_pattern[i]}"]
        return _drop_lead(tree)
    return stack_specs["tail"][layer - cfg.n_groups * P]


def _drop_lead(tree):
    if isinstance(tree, dict):
        return {k: _drop_lead(v) for k, v in tree.items()}
    assert tree[0] is None, tree                      # the layer axis is unsharded
    return tree[1:]


def _port_specs(cfg, specs) -> dict:
    """The port's ``{parameter name: spec}`` from the reference-shaped tree."""
    out = {f"{top}.{k}": s for top in ("embedding", "final_norm") for k, s in specs[top].items()}
    for layer in range(cfg.n_layers):
        for grp, leaves in _layer_spec(specs["stack"], cfg, layer).items():
            out.update({f"stack.{layer}.{grp}.{k}": s for k, s in leaves.items()})
    return out


@pytest.mark.parametrize("arch,small,tp,kv", CASES)
def test_specs_fit_the_ports_trees(arch, small, tp, kv):
    _, cfg = _cfgs(arch, small, tp, kv)
    params = TM.init_params(cfg, torch.Generator(), device="meta")
    specs = _port_specs(cfg, TM.param_specs(cfg))
    shapes = {n: p.shape for n, p in params.named_parameters()}
    assert set(specs) == set(shapes)
    for name, shape in shapes.items():
        assert len(specs[name]) == len(shape), (name, specs[name], tuple(shape))
    caches = TM.cache_init(cfg, 2, 64, device="meta")
    cspecs = TM.cache_specs(cfg)
    assert len(caches) == cfg.n_layers
    for layer, cache in enumerate(caches):
        spec = _layer_spec(cspecs, cfg, layer)
        assert set(spec) == set(cache), layer
        for name, t in cache.items():
            assert len(spec[name]) == t.dim(), (layer, name, spec[name], tuple(t.shape))
