"""The port's dry run (``repro_torch.launch.dryrun``) against the reference's
own code, without compiling.

The oracle is the JAX package: its configs (``supports_shape``, parameter
counts), ``roofline.analysis.model_flops`` and its ``build_cell`` on a
``jax.sharding.AbstractMesh`` of the production shape (Auto axes; no
devices, no compile), whose abstract inputs give the reference's
``_memory_floor``.  Importing ``repro.launch.dryrun`` sets ``XLA_FLAGS`` to
512 host devices, so the import runs under a monkeypatch that restores it.
Cells run at published width and 2 layers, on fake process groups of 256
(16, 16) and 512 (2, 16, 16) ranks, or of 1 and 4 for the data-parallel
identities.  The checks:

* status, SKIP reason, ``params_b`` and ``active_params_b`` of all 40
  (arch × shape) pairs (the step itself stubbed: ``run_cell``'s record
  logic alone), and ``run_cell`` refusing a process group it did not make;
* the memory floor and argument bytes of three cells on both meshes equal
  to the reference's (every sharded dim divides there);
* one full record (Qwen2-0.5B ``train_4k``): status, keys, ``kernel_calls``
  as the layers imply, ``model_flops_per_dev`` equal to the reference's,
  the ratio and the collectives' keys;
* K3's and K4's share of the count equal to ``roofline.kernels``' work at
  the local shapes the layers give them;
* per-device FLOPs on a (4, 1) data-parallel mesh x 4 equal to the (1, 1)
  mesh's, exactly, and no collective on (1, 1); one layer group's
  collectives on (4, 1) equal to a count derived from its parameters'
  shapes;
* ``main`` in-process on three cheap runs (an OK cell, a SKIP, the
  multi-pod mesh under ``decode_kv``), its JSON rendered by the port's
  report exactly as by the reference's.

16.3 s on one CPU worker (this file alone, imports included).
"""

import dataclasses
import math
import os

import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh, AxisType
from torch.distributed.device_mesh import init_device_mesh

from repro.configs.base import SHAPES as JAX_SHAPES
from repro.configs.base import get_config as jax_get_config
from repro.launch.steps import build_cell as jax_build_cell
from repro.roofline import analysis as JR
from repro.roofline import report as JREP
from repro_torch.configs.base import SHAPES, ShapeSpec, get_config, list_configs, pad_for_mesh
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import build_cell
from repro_torch.models import model as M
from repro_torch.roofline import kernels as K
from repro_torch.roofline import report as TREP
from repro_torch.roofline.counter import CostCounter

LAYERS = 2
PAIRS = [(arch, shape) for arch in list_configs() for shape in SHAPES]
CELLS = [("qwen2-0.5b", "train_4k"), ("mamba2-130m", "prefill_32k"),
         ("granite-moe-3b-a800m", "decode_32k")]
# the reference's record keys (src/repro/launch/dryrun.py:74-133)
RECORD_KEYS = {"arch", "shape", "kind", "policy", "params_b", "active_params_b", "status",
               "single_pod", "cost", "roofline", "model_flops_per_dev", "useful_flops_ratio"}
COLLECTIVE_KINDS = {"all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                    "collective-permute"}


@pytest.fixture(scope="module")
def jax_dryrun():
    """The reference's dry-run module, ``XLA_FLAGS`` restored after the
    import (it sets 512 host devices for any later jax process)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))
        import repro.launch.dryrun as mod
    return mod


@pytest.fixture
def two_layers(monkeypatch):
    monkeypatch.setattr(D, "get_config",
                        lambda arch: dataclasses.replace(get_config(arch), n_layers=LAYERS))


def _jax_cfg(arch):
    return dataclasses.replace(jax_get_config(arch), n_layers=LAYERS)


def _abstract_mesh(multi_pod):
    shape, axes = ((2, 16, 16), ("pod", "data", "model")) if multi_pod else (
        (16, 16), ("data", "model"))
    return AbstractMesh(shape, axes, axis_types=(AxisType.Auto,) * len(axes))


@pytest.mark.parametrize("arch,shape_name", PAIRS)
def test_status_and_counts_match_the_reference(arch, shape_name, monkeypatch):
    def no_step(cfg, shape, mesh, label, policy="default"):
        return {"label": label}, CostCounter()

    monkeypatch.setattr(D, "compile_cell", no_step)
    rec = D.run_cell(arch, shape_name, analysis=False, skip_multipod=True)
    jcfg = jax_get_config(arch)
    ok, why = jcfg.supports_shape(JAX_SHAPES[shape_name])
    assert rec["status"] == ("OK" if ok else "SKIP")
    assert rec.get("why") == (None if ok else why)
    assert (rec["arch"], rec["shape"], rec["kind"], rec["policy"]) == (
        arch, shape_name, JAX_SHAPES[shape_name].kind, "default")
    assert rec["params_b"] == jcfg.param_count() / 1e9
    assert rec["active_params_b"] == jcfg.active_param_count() / 1e9
    assert not dist.is_initialized()


def test_run_cell_refuses_a_group_it_did_not_make():
    with D.fake_world(4):
        with pytest.raises(RuntimeError, match="already initialized"):
            D.run_cell("qwen2-0.5b", "long_500k")
        with pytest.raises(RuntimeError, match="already initialized"):
            with D.fake_world(256):
                pass
        assert dist.get_world_size() == 4       # the caller's group untouched
    assert not dist.is_initialized()


def test_eight_full_attention_configs_skip_long_500k():
    skips = [(a, s) for a, s in PAIRS if not get_config(a).supports_shape(SHAPES[s])[0]]
    assert len(PAIRS) == 40 and len(skips) == 8
    assert {s for _, s in skips} == {"long_500k"}


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch,shape_name", CELLS)
def test_memory_floor_matches_the_reference(arch, shape_name, multi_pod, jax_dryrun):
    _, sds, _ = jax_build_cell(_jax_cfg(arch), JAX_SHAPES[shape_name],
                               _abstract_mesh(multi_pod))
    cfg = dataclasses.replace(get_config(arch), n_layers=LAYERS)
    shape = SHAPES[shape_name]
    with D.fake_world(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        _, specs, _ = build_cell(cfg, shape, mesh)
        assert D._memory_floor(shape, specs, mesh) == jax_dryrun._memory_floor(
            JAX_SHAPES[shape_name], sds)
        # the reference's decode inputs end with the position, a Python int here
        assert D._mem_stats(specs, mesh) == {
            "argument_size_in_bytes": JR.tree_local_bytes(sds[:len(specs)])}


def _kernel_calls(cfg, kind):
    """K3/K4 calls of a step at ``cfg``'s layers (no tail in these
    configs): a forward a layer, twice under a recomputing remat in
    training, and a backward a layer."""
    name = "ssd_scan" if cfg.block_pattern == ("ssm",) else "flash_attention"
    if kind == "decode":
        return {}
    if kind == "prefill":
        return {name: cfg.n_layers}
    return {name: cfg.n_layers * (1 if cfg.remat == "none" else 2),
            name + "_bwd": cfg.n_layers}


@pytest.fixture(scope="module")
def qwen_train_record():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(D, "get_config",
                   lambda arch: dataclasses.replace(get_config(arch), n_layers=LAYERS))
        return D.run_cell("qwen2-0.5b", "train_4k", skip_multipod=True)


def test_a_training_cell_record(qwen_train_record, jax_dryrun):
    rec = qwen_train_record
    assert rec["status"] == "OK", rec.get("traceback")
    assert RECORD_KEYS | {"kernel_calls"} <= set(rec) and "multi_pod" not in rec
    cfg = dataclasses.replace(get_config("qwen2-0.5b"), n_layers=LAYERS)
    assert cfg.remat == "full"
    assert rec["kernel_calls"] == _kernel_calls(cfg, "train") == {
        "flash_attention": 4, "flash_attention_bwd": 2}
    pod = rec["single_pod"]
    assert set(pod) == {"label", "compile_s", "memory", "memory_floor_bytes"}
    assert set(pod["memory"]) == {"argument_size_in_bytes"}
    _, sds, _ = jax_build_cell(_jax_cfg("qwen2-0.5b"), JAX_SHAPES["train_4k"],
                               _abstract_mesh(False))
    assert pod["memory_floor_bytes"] == jax_dryrun._memory_floor(JAX_SHAPES["train_4k"], sds)
    mf = JR.model_flops(_jax_cfg("qwen2-0.5b"), JAX_SHAPES["train_4k"], 256)
    assert rec["model_flops_per_dev"] == mf
    cost = rec["cost"]
    assert rec["useful_flops_ratio"] == mf / cost["flops_per_dev"]
    coll = cost["collectives"]
    assert set(coll) - {"total", "wire_total", "wire_bf16adj"} <= COLLECTIVE_KINDS
    assert coll["total"] == sum(v for k, v in coll.items() if k in COLLECTIVE_KINDS)
    assert coll["total"] == cost["collective_bytes_per_dev"] > 0
    assert coll["wire_bf16adj"] == coll["wire_total"] > 0
    assert set(rec["roofline"]) == set(JR.roofline_terms(JR.CellCost(collectives={}), 1.0))


def test_kernel_share_equals_the_kernels_work():
    """K3's and K4's share of a cell's count on the (16, 16) mesh, at the
    local shapes the layers hand them: Qwen2-0.5B's train step (B 256 / 16
    data shards; 14 heads padded to 16, one a model shard, with the one of
    its 2 replicated KV heads it reads; lse written), Mamba2-130M's prefill
    (B 32 / 16; the SSM runs data-parallel, whole over the model axis)."""
    qwen = dataclasses.replace(get_config("qwen2-0.5b"), n_layers=LAYERS)
    mamba = dataclasses.replace(get_config("mamba2-130m"), n_layers=LAYERS)
    with D.fake_world(256):
        mesh = make_production_mesh(device_type="cpu")
        _, k3 = D.compile_cell(qwen, SHAPES["train_4k"], mesh, "k3")
        _, k4 = D.compile_cell(mamba, SHAPES["prefill_32k"], mesh, "k4")
    heads = pad_for_mesh(qwen, 16).heads_p // 16
    bh = bkv = 256 // 16 * heads
    fwd = K.flash_attention_work(bh, bkv, 4096, qwen.head_dim, 2, with_lse=True)
    bwd = K.flash_attention_bwd_work(bh, bkv, 4096, qwen.head_dim, 2)
    assert k3.kernel_calls == {"flash_attention": 4, "flash_attention_bwd": 2}
    assert k3.kernel_work == {"flash_attention": [4 * fwd[0], 4 * fwd[1]],
                              "flash_attention_bwd": [2 * bwd[0], 2 * bwd[1]]}
    h = mamba.ssm_expand * mamba.d_model // mamba.ssm_head_dim
    work = K.ssd_scan_work(32 // 16, 32768, h, mamba.ssm_head_dim, mamba.ssm_state, False)
    assert k4.kernel_calls == {"ssd_scan": LAYERS}
    assert k4.kernel_work == {"ssd_scan": [LAYERS * work[0], LAYERS * work[1]]}
    for counter in (k3, k4):
        assert counter.flops > sum(w[0] for w in counter.kernel_work.values())


DP_SHAPE = ShapeSpec("dp", 256, 8, "train")


@pytest.fixture(scope="module")
def dp_counts():
    """Qwen2-0.5B's train step under remat "none" at 8 x 256 tokens: one
    layer group on (1, 1) and on (4, 1), two groups on (4, 1)."""
    base = dataclasses.replace(get_config("qwen2-0.5b"), n_layers=LAYERS)
    out = {}
    for dims, groups in (((1, 1), 1), ((4, 1), 1), ((4, 1), 2)):
        with D.fake_world(math.prod(dims)):
            mesh = init_device_mesh("cpu", dims, mesh_dim_names=("data", "model"))
            _, out[dims, groups] = D.compile_cell(D._unrolled_cfg(base, groups), DP_SHAPE,
                                                  mesh, "dp")
    return out


def test_per_device_flops_split_exactly_over_data(dp_counts):
    one, four = dp_counts[(1, 1), 1], dp_counts[(4, 1), 1]
    assert four.flops * 4 == one.flops
    assert {k: [4 * w for w in v] for k, v in four.kernel_work.items()} == one.kernel_work
    assert one.cost().collectives == {"total": 0, "wire_total": 0.0, "wire_bf16adj": 0.0}
    assert one.cost().collective_bytes == 0


def test_data_parallel_collectives_follow_the_parameters(dp_counts):
    """One layer group's collectives on (4, 1) (two groups' less one's):
    the layer's activations stay on their batch shard, so only its
    parameters' f32 gradients move, each a Partial sum over the 4 data
    shards.  The global norm squares each one whole: an all-reduce of 4n
    bytes.  AdamW's update takes it to the moments' placements: where ZeRO
    shards them (n >= 2^16 and a dim divisible by 4) a reduce-scatter of
    4n bytes and an all-gather of the new bf16 parameter's shard, 2n / 4
    bytes; else an all-reduce of 4n.  Wire: all-reduce 2x(g-1)/g,
    reduce-scatter x(g-1)/g, all-gather of a shard x(g-1)."""
    cfg = D._unrolled_cfg(dataclasses.replace(get_config("qwen2-0.5b"), n_layers=LAYERS), 2)
    params = M.init_params(cfg, torch.Generator(), device="meta")
    want = {"all-reduce": 0.0, "reduce-scatter": 0.0, "all-gather": 0.0}
    wire, g = 0.0, 4
    for name, p in params.named_parameters():
        if not name.startswith("stack.1."):
            continue
        n = p.numel()
        want["all-reduce"] += 4 * n
        wire += 2 * 4 * n * (g - 1) / g
        if n >= 2 ** 16 and any(d % g == 0 for d in p.shape):
            want["reduce-scatter"] += 4 * n
            want["all-gather"] += 2 * n / g
            wire += 4 * n * (g - 1) / g + 2 * n / g * (g - 1)
        else:
            want["all-reduce"] += 4 * n
            wire += 2 * 4 * n * (g - 1) / g
    one, two = dp_counts[(4, 1), 1].cost(), dp_counts[(4, 1), 2].cost()
    got = {k: two.collectives.get(k, 0.0) - one.collectives.get(k, 0.0)
           for k in set(two.collectives) | set(one.collectives)}
    assert got == {**want, "total": sum(want.values()), "wire_total": wire,
                   "wire_bf16adj": wire}


def test_main_writes_records_the_report_renders(tmp_path, capsys, two_layers):
    out = str(tmp_path)
    D.main(["--arch", "mamba2-130m", "--shape", "long_500k", "--skip-multipod", "--out", out])
    D.main(["--arch", "qwen2-0.5b", "--shape", "long_500k", "--no-analysis", "--out", out])
    D.main(["--arch", "mamba2-130m", "--shape", "long_500k", "--policy", "decode_kv",
            "--out", out])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "=== mamba2-130m × long_500k"
    assert lines[1].startswith("    -> OK bottleneck=")
    assert lines[2:6] == ["SUMMARY: 1 OK, 0 SKIP, 0 FAIL / 1", "=== qwen2-0.5b × long_500k",
                          "    -> SKIP", "SUMMARY: 0 OK, 1 SKIP, 0 FAIL / 1"]
    assert lines[6] == "=== mamba2-130m × long_500k" and lines[7].startswith("    -> OK ")
    assert lines[8:] == ["SUMMARY: 1 OK, 0 SKIP, 0 FAIL / 1"]
    assert sorted(os.listdir(out)) == ["mamba2-130m__long_500k.json",
                                       "mamba2-130m__long_500k__decode_kv.json",
                                       "qwen2-0.5b__long_500k.json"]
    recs = TREP.load(out)
    assert [(r["status"], r["policy"]) for r in recs] == [
        ("OK", "default"), ("OK", "decode_kv"), ("SKIP", "default")]
    assert recs[0]["kernel_calls"] == {} and "multi_pod" not in recs[0]
    assert set(recs[1]["multi_pod"]) == {"label", "compile_s", "memory", "memory_floor_bytes"}
    assert "cost" not in recs[2] and recs[2]["why"]
    assert TREP.table(recs) == JREP.table(JREP.load(out))
    assert "| mamba2-130m | long_500k | OK |" in TREP.table(recs)
