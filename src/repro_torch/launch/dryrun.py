"""Multi-pod dry run: build and trace every (architecture × input-shape)
cell on the production meshes, on PyTorch's ``meta`` device, and derive
the roofline terms.

Ports ``repro.launch.dryrun``.  The reference lowers and compiles each
cell with XLA on 512 placeholder host devices; the port traces it on the
``meta`` device under a fake process group
(``torch.testing._internal.distributed.fake_pg``, backend ``"fake"``) of
256 ranks for the single-pod (16, 16) mesh and 512 for the multi-pod
(2, 16, 16) mesh, both ``launch.mesh.make_production_mesh(...,
device_type="cpu")``.  It touches no device: no tensor holds data, no
collective moves any, no kernel launches, and CUDA is never initialized.
Run as a module:

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch glm4-9b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out results/dryrun
    PYTHONPATH=src python -m repro_torch.roofline.report results/dryrun

Per cell this produces:
  * the proof that the cell builds and runs: ``launch.steps.build_cell``
    with the config as registered (full depth, published widths, its
    ``remat``) on the single-pod mesh and (unless ``--skip-multipod``) the
    multi-pod mesh, every input taken to its placements by
    ``launch.steps.place`` from ``init_params(..., device="meta")`` (or the
    meta optimizer state, caches, batch and token), and the step run once
    under ``roofline.counter.CostCounter``.  K3, K4 and their backwards
    take their shape-only path there (their checks run: an OK cell's
    shapes are shapes the card's kernels take); ``kernel_calls`` counts
    those calls by name (the single-pod proof's).  ``compile_s`` is the
    seconds to build, place and trace the step on meta (no compiler runs).
    ``memory`` holds ``argument_size_in_bytes`` alone: the step inputs'
    per-device bytes (``tree_local_bytes`` of params, optimizer state and
    batch, or of params, caches and token).  XLA's ``memory_analysis`` has
    no torch counterpart, and no peak is estimated.  A decode step runs at
    ``pos`` = seq_len - 1, so it attends over every cache slot, as the
    reference's compiled step does for any position;
  * the costs (single-pod): per-device FLOPs, bytes and collective bytes
    (``roofline.counter``'s rule) under ``remat="none"``, the reference's
    definition (``_unrolled_cfg``), extrapolated from passes over one and
    two layer groups with ``roofline.analysis.extrapolate``.  The port's
    layers are not stacked, so a full-depth pass would count the same
    numbers (equal on the cells measured, PERF.md §6), but it traces every
    layer: the two short passes keep ``--all`` in minutes;
  * the roofline terms, ``model_flops_per_dev`` and the ratio
    ``useful_flops_ratio`` = model FLOPs / counted FLOPs.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch.configs.base import SHAPES, get_config, list_configs, pad_for_mesh
from repro_torch.distributed.sharding import axis_sizes
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import _MESH_POLICIES, build_cell, place
from repro_torch.models import model as M
from repro_torch.roofline.analysis import (extrapolate, model_flops, roofline_terms,
                                           tree_local_bytes)
from repro_torch.roofline.counter import CostCounter
from repro_torch.training.optimizer import init_opt_state

__all__ = ["run_cell", "compile_cell", "fake_world", "main"]

_WORLD = {False: 256, True: 512}        # ranks of the single- and multi-pod meshes


@contextlib.contextmanager
def fake_world(world_size: int):
    """A fake process group of ``world_size`` ranks (this process rank 0)
    for the block, destroyed after it.  Raises if a process group is
    already initialized: the dry run never tears down a group it did not
    make."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError(f"a process group of {dist.get_world_size()} ranks is already "
                           f"initialized; the dry run makes and destroys its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _mem_stats(inputs, mesh) -> dict:
    return {"argument_size_in_bytes": int(tree_local_bytes(inputs, mesh))}


def _unrolled_cfg(cfg, n_groups: int):
    n_layers = len(cfg.block_pattern) * n_groups + len(cfg.tail_pattern)
    return dataclasses.replace(cfg, n_layers=n_layers, scan_layers=False, remat="none")


def _memory_floor(shape, specs, mesh) -> float:
    """Sharding-exact per-device bytes that must cross HBM once per step."""
    if shape.kind == "train":
        params, opt, batch = specs
        # params: fwd read + bwd read + update write; moments: read + write
        return (3 * tree_local_bytes(params, mesh) + 2 * tree_local_bytes(opt, mesh)
                + tree_local_bytes(batch, mesh))
    if shape.kind == "prefill":
        params, batch = specs
        return tree_local_bytes(params, mesh) + tree_local_bytes(batch, mesh)
    params, caches, token = specs       # decode
    return (tree_local_bytes(params, mesh) + tree_local_bytes(caches, mesh)
            + tree_local_bytes(token, mesh))


def _meta(spec_tree):
    """A meta tensor of each ``TensorSpec``'s shape and dtype."""
    if isinstance(spec_tree, dict):
        return {k: _meta(v) for k, v in spec_tree.items()}
    return torch.empty(spec_tree.shape, dtype=spec_tree.dtype, device="meta")


def _inputs(cfg, shape, mesh, policy: str, specs):
    """The step's inputs on meta at their placements (``place``)."""
    cfg = pad_for_mesh(cfg, axis_sizes(mesh).get("model", 1), pad_kv=(policy == "decode_kv"))
    params = M.init_params(cfg, torch.Generator(), device="meta")
    if shape.kind == "train":
        params.requires_grad_(True)
        opt = init_opt_state(params)
        return (place(params, specs[0], mesh), place(opt, specs[1], mesh),
                place(_meta(specs[2]), specs[2], mesh))
    if shape.kind == "prefill":
        return place(params, specs[0], mesh), place(_meta(specs[1]), specs[1], mesh)
    caches = M.cache_init(cfg, shape.global_batch, shape.seq_len, device="meta")
    token = torch.empty(specs[2].shape, dtype=specs[2].dtype, device="meta")
    return (place(params, specs[0], mesh), place(caches, specs[1], mesh),
            place(token, specs[2], mesh))


def compile_cell(cfg, shape, mesh, label: str, policy: str = "default"):
    """Build, place and trace one step of the cell on ``mesh`` under a
    ``CostCounter``: (info, the counter)."""
    t0 = time.perf_counter()
    step, specs, _rules = build_cell(cfg, shape, mesh, policy=policy)
    inputs = _inputs(cfg, shape, mesh, policy, specs)
    counter = CostCounter()
    with counter:
        if shape.kind == "decode":
            step(*inputs, shape.seq_len - 1)
        else:
            step(*inputs)
    info = {"label": label, "compile_s": round(time.perf_counter() - t0, 1),
            "memory": _mem_stats(specs, mesh),
            "memory_floor_bytes": _memory_floor(shape, specs, mesh)}
    return info, counter


def run_cell(arch: str, shape_name: str, *, analysis: bool = True,
             skip_multipod: bool = False, policy: str = "default") -> dict:
    """The record of one cell (the reference's keys, plus ``kernel_calls``).
    Each mesh runs in a fake group of its own, made and destroyed here."""
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized; run_cell makes its own")
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    rec = {"arch": arch, "shape": shape_name, "kind": shape.kind, "policy": policy,
           "params_b": cfg.param_count() / 1e9,
           "active_params_b": cfg.active_param_count() / 1e9}
    ok, why = cfg.supports_shape(shape)
    if not ok:
        rec["status"] = "SKIP"
        rec["why"] = why
        return rec
    try:
        with fake_world(_WORLD[False]):
            # 1) the step at full depth, single-pod
            mesh1 = make_production_mesh(multi_pod=False, device_type="cpu")
            info1, counter1 = compile_cell(cfg, shape, mesh1, "single_pod", policy)
            rec["single_pod"] = info1
            rec["kernel_calls"] = dict(sorted(counter1.kernel_calls.items()))
            # 2) costs from one- and two-group passes under remat "none"
            if analysis:
                _, g1 = compile_cell(_unrolled_cfg(cfg, 1), shape, mesh1, "g1", policy)
                _, g2 = compile_cell(_unrolled_cfg(cfg, 2), shape, mesh1, "g2", policy)
                cost = extrapolate(g1.cost(), g2.cost(), cfg.n_groups)
        # 3) the step at full depth, multi-pod (the 512-device proof)
        if not skip_multipod:
            with fake_world(_WORLD[True]):
                mesh2 = make_production_mesh(multi_pod=True, device_type="cpu")
                rec["multi_pod"], _ = compile_cell(cfg, shape, mesh2, "multi_pod", policy)
        if analysis:
            n_dev = _WORLD[False]
            terms = roofline_terms(cost, memory_floor_bytes=info1["memory_floor_bytes"])
            mf = model_flops(cfg, shape, n_dev)
            rec["cost"] = {"flops_per_dev": cost.flops,
                           "bytes_per_dev": cost.bytes_accessed,
                           "collective_bytes_per_dev": cost.collective_bytes,
                           "collectives": cost.collectives}
            rec["roofline"] = terms
            rec["model_flops_per_dev"] = mf
            rec["useful_flops_ratio"] = (mf / cost.flops) if cost.flops else 0.0
        rec["status"] = "OK"
    except Exception as e:  # noqa: BLE001 — record failures per cell
        rec["status"] = "FAIL"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--no-analysis", action="store_true")
    ap.add_argument("--skip-multipod", action="store_true")
    ap.add_argument("--out", default=None, help="directory for per-cell JSON")
    ap.add_argument("--policy", default="default", choices=list(_MESH_POLICIES))
    args = ap.parse_args(argv)

    if args.all:
        cells = [(arch, shape) for arch in list_configs() for shape in SHAPES]
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        ap.error("--arch/--shape or --all")

    results = []
    for arch, shape in cells:
        print(f"=== {arch} × {shape}", flush=True)
        rec = run_cell(arch, shape, analysis=not args.no_analysis,
                       skip_multipod=args.skip_multipod, policy=args.policy)
        results.append(rec)
        status = rec["status"]
        extra = ""
        if status == "OK" and "roofline" in rec:
            r = rec["roofline"]
            extra = (f" bottleneck={r['bottleneck']}"
                     f" compute={r['compute_s']:.4f}s"
                     f" mem={r['memory_s']:.4f}s coll={r['collective_s']:.4f}s")
        elif status == "FAIL":
            extra = f" {rec['error']}"
        print(f"    -> {status}{extra}", flush=True)
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            suffix = "" if args.policy == "default" else f"__{args.policy}"
            with open(os.path.join(args.out, f"{arch}__{shape}{suffix}.json"), "w") as f:
                json.dump(rec, f, indent=1)
    n_ok = sum(r["status"] == "OK" for r in results)
    n_skip = sum(r["status"] == "SKIP" for r in results)
    n_fail = sum(r["status"] == "FAIL" for r in results)
    print(f"SUMMARY: {n_ok} OK, {n_skip} SKIP, {n_fail} FAIL / {len(results)}")


if __name__ == "__main__":
    main()
