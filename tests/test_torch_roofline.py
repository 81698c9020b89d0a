"""The port's analytic roofline (``repro_torch.roofline``) against the JAX
package's, on the CPU.

``model_flops`` equals the reference's on every registered config, padded
or not, x every ``SHAPES`` entry x 1 and 256 devices; ``extrapolate``
equals it on the same costs; ``roofline_terms`` equals it with the port's
``HW`` patched to the reference's v5e figures, and gives the H100's
arithmetic unpatched; ``tree_local_bytes`` over the port's parameters on
the ``meta`` device equals the reference's over ``jax.eval_shape`` of its
own (the same shapes and dtypes, published widths, padded too); and the
report's ``load``, ``table`` and ``main`` print the reference's text for
one directory of synthetic dry-run records (OK, SKIP and FAIL rows).
"""

import dataclasses
import io
import json
import sys
from contextlib import redirect_stdout

import jax
import pytest
import torch

from repro.configs.base import SHAPES as JAX_SHAPES
from repro.configs.base import get_config as jax_get_config
from repro.configs.base import pad_for_mesh as jax_pad_for_mesh
from repro.models import model as JM
from repro.roofline import analysis as JR
from repro.roofline import report as JREP
from repro_torch.configs.base import SHAPES, get_config, list_configs, pad_for_mesh
from repro_torch.models import model as TM
from repro_torch.roofline import analysis as TR
from repro_torch.roofline import report as TREP

V5E = {"peak_flops": 197e12, "hbm_bw": 819e9, "link_bw": 50e9}     # the reference's HW
COSTS = [
    (dict(flops=1.5e15, bytes_accessed=2.0e12, collective_bytes=3.0e10,
          collectives={"all-gather": 1e10, "all-reduce": 2e10, "total": 3e10,
                       "wire_total": 4e10, "wire_bf16adj": 3e10}), 7.5e11),
    (dict(flops=2.0e12, bytes_accessed=9.0e12, collective_bytes=0.0,
          collectives={"total": 0.0, "wire_total": 0.0}), 0.0),
    (dict(flops=1e9, bytes_accessed=1e9, collective_bytes=5e12,
          collectives={"all-to-all": 5e12, "total": 5e12, "wire_total": 6e12}), 1e15),
]


@pytest.mark.parametrize("n_devices", [1, 256])
@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("arch", list_configs())
def test_model_flops_equals_the_reference(arch, shape, n_devices):
    assert dataclasses.astuple(SHAPES[shape]) == dataclasses.astuple(JAX_SHAPES[shape])
    for pad in (None, 8):
        want_cfg, got_cfg = jax_get_config(arch), get_config(arch)
        if pad:
            want_cfg, got_cfg = jax_pad_for_mesh(want_cfg, pad), pad_for_mesh(got_cfg, pad)
        assert TR.model_flops(got_cfg, SHAPES[shape], n_devices) == JR.model_flops(
            want_cfg, JAX_SHAPES[shape], n_devices)


@pytest.mark.parametrize("n_groups", [1, 2, 24])
def test_extrapolate_equals_the_reference(n_groups):
    (base, _), (plus, _) = COSTS[0], COSTS[2]
    got = TR.extrapolate(TR.CellCost(**base), TR.CellCost(**plus), n_groups)
    want = JR.extrapolate(JR.CellCost(**base), JR.CellCost(**plus), n_groups)
    for field in ("flops", "bytes_accessed", "collective_bytes", "collectives"):
        assert getattr(got, field) == getattr(want, field), field


@pytest.mark.parametrize("cost,floor", COSTS)
def test_roofline_terms_equal_the_reference_on_v5e(cost, floor, monkeypatch):
    monkeypatch.setattr(TR, "HW", dict(TR.HW, **V5E))
    got = TR.roofline_terms(TR.CellCost(**cost), floor)
    want = JR.roofline_terms(JR.CellCost(**cost), floor)
    assert got == want


@pytest.mark.parametrize("cost,floor", COSTS)
def test_roofline_terms_use_the_h100(cost, floor):
    got = TR.roofline_terms(TR.CellCost(**cost), floor)
    assert TR.HW == {"peak_flops": 989e12, "tf32_flops": 495e12, "f32_flops": 67e12,
                     "hbm_bw": 3.35e12, "link_bw": 450e9}
    assert got["compute_s"] == cost["flops"] / 989e12
    assert got["memory_s"] == cost["bytes_accessed"] / 3.35e12
    assert got["memory_floor_s"] == floor / 3.35e12
    assert got["collective_s"] == cost["collective_bytes"] / 450e9
    assert got["collective_wire_s"] == cost["collectives"]["wire_total"] / 450e9
    terms = {k: got[k] for k in ("compute_s", "memory_s", "collective_s")}
    assert got["bottleneck"] == max(terms, key=terms.get)[:-2]
    assert got["step_lower_bound_s"] == max(terms.values())


@pytest.mark.parametrize("pad", [None, 8])
@pytest.mark.parametrize("arch", list_configs())
def test_tree_local_bytes_over_meta_equals_the_reference(arch, pad):
    want_cfg, got_cfg = jax_get_config(arch), get_config(arch)
    if pad:
        want_cfg, got_cfg = jax_pad_for_mesh(want_cfg, pad), pad_for_mesh(got_cfg, pad)
    sds = jax.eval_shape(lambda k: JM.init_params(k, want_cfg), jax.random.PRNGKey(0))
    params = TM.init_params(got_cfg, torch.Generator(), device="meta")
    assert TR.tree_local_bytes(params) == JR.tree_local_bytes(sds)
    # a plain tree of meta tensors, a 0-d one included
    tree = {"a": [torch.empty((3, 5), dtype=torch.bfloat16, device="meta")],
            "b": torch.empty((), dtype=torch.int32, device="meta")}
    assert TR.tree_local_bytes(tree) == 3 * 5 * 2 + 4


def _records():
    ok = {"status": "OK", "useful_flops_ratio": 0.81,
          "single_pod": {"compile_s": 41.2, "memory": {"argument_size_in_bytes": 3.2e10}},
          "multi_pod": {"compile_s": 77.9}}
    recs = []
    for i, (arch, shape) in enumerate([("qwen2-0.5b", "decode_32k"), ("qwen2-0.5b", "train_4k"),
                                       ("glm4-9b", "prefill_32k"), ("mamba2-130m", "long_500k")]):
        cost, floor = COSTS[i % len(COSTS)]
        roof = JR.roofline_terms(JR.CellCost(**cost), floor)
        recs.append(dict(ok, arch=arch, shape=shape, roofline=roof))
    recs.append({"arch": "qwen2-0.5b", "shape": "long_500k", "status": "SKIP"})
    recs.append({"arch": "glm4-9b", "shape": "decode_32k", "status": "FAIL"})
    no_multi = dict(recs[1], arch="granite-moe-3b-a800m")
    del no_multi["multi_pod"]
    return recs + [no_multi]


def test_report_table_prints_the_references_text(tmp_path, monkeypatch):
    recs = _records()
    for i, r in enumerate(recs):
        (tmp_path / f"cell{i:02d}.json").write_text(json.dumps(r))
    got, want = TREP.load(str(tmp_path)), JREP.load(str(tmp_path))
    assert got == want and [r["arch"] for r in got] == sorted(r["arch"] for r in got)
    assert TREP.table(got) == JREP.table(want)
    assert "SKIP(full-attention)" in TREP.table(got) and "| FAIL |" in TREP.table(got)
    monkeypatch.setattr(sys, "argv", ["report", str(tmp_path)])
    outs = []
    for mod in (TREP, JREP):
        buf = io.StringIO()
        with redirect_stdout(buf):
            mod.main()
        outs.append(buf.getvalue())
    assert outs[0] == outs[1] and "5 OK, 1 SKIP, 1 FAIL / 7" in outs[0]
