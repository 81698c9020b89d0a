"""Analytic roofline terms of an (arch x shape x mesh) cell, H100 constants.

Ports the analytic part of ``repro.roofline.analysis``: ``CellCost`` (its
fields), ``extrapolate``, ``roofline_terms``, ``tree_local_bytes`` and
``model_flops``.  Three terms per cell, each the least time one device
could take for the cell's work:

    compute    = FLOPs per device / HW["peak_flops"]      (bf16 tensor cores)
    memory     = bytes per device / HW["hbm_bw"]          (HBM)
    collective = collective bytes per device / HW["link_bw"]   (NVLink)

The reference fills a ``CellCost`` from XLA (``CellCost.from_compiled``:
``cost_analysis`` and the compiled HLO's collectives through
``parse_collective_bytes``); neither has a torch input, so neither is
ported.  The port's dry run fills one from its own counters.

``HW`` holds NVIDIA's published H100 SXM5 peaks (the H100 data sheet;
dense rates, no sparsity, at the 700 W power limit): ``peak_flops`` bf16
989e12, ``tf32_flops`` 495e12, ``f32_flops`` 67e12 (outside the tensor
cores), ``hbm_bw`` 3.35e12 B/s, and ``link_bw`` NVLink 4's 450e9 B/s a
direction (900 GB/s a GPU both ways, the same data sheet).  Every peak the
port states elsewhere (``chip_smoke.py``'s bounds) is read from here.
"""

from __future__ import annotations

from dataclasses import dataclass, field

__all__ = ["HW", "CellCost", "extrapolate", "roofline_terms", "tree_local_bytes",
           "model_flops"]

HW = dict(peak_flops=989e12, tf32_flops=495e12, f32_flops=67e12, hbm_bw=3.35e12,
          link_bw=450e9)


@dataclass
class CellCost:
    flops: float = 0.0
    bytes_accessed: float = 0.0
    collective_bytes: float = 0.0
    collectives: dict = field(default_factory=dict)


def extrapolate(base: CellCost, plus_one: CellCost, n_groups: int) -> CellCost:
    """``base`` the cost of one layer group, ``plus_one`` of two: the exact
    per-group delta x (n_groups - 1) on top of ``base``."""
    k = n_groups - 1
    coll = {key: base.collectives.get(key, 0.0)
            + k * (plus_one.collectives.get(key, 0.0) - base.collectives.get(key, 0.0))
            for key in sorted(set(base.collectives) | set(plus_one.collectives))}
    return CellCost(
        flops=base.flops + k * (plus_one.flops - base.flops),
        bytes_accessed=base.bytes_accessed
        + k * (plus_one.bytes_accessed - base.bytes_accessed),
        collective_bytes=max(coll.get("total", 0.0), 0.0),
        collectives=coll,
    )


def roofline_terms(cost: CellCost, memory_floor_bytes: float = 0.0) -> dict:
    """The three terms and their bottleneck, and two calibrations:
    ``memory_floor_s``, the bytes that must cross HBM once a step (params,
    caches, optimizer state) in place of the counted bytes, and the
    collectives' ring-algorithm wire bytes (``collectives["wire_total"]``,
    ``["wire_bf16adj"]``) in place of their operand bytes.  The reference's
    output keys."""
    compute_s = cost.flops / HW["peak_flops"]
    memory_s = cost.bytes_accessed / HW["hbm_bw"]
    memory_floor_s = memory_floor_bytes / HW["hbm_bw"]
    collective_s = cost.collective_bytes / HW["link_bw"]
    wire_s = (cost.collectives or {}).get("wire_total", 0.0) / HW["link_bw"]
    wire_adj_s = (cost.collectives or {}).get("wire_bf16adj", wire_s) / HW["link_bw"]
    terms = {"compute_s": compute_s, "memory_s": memory_s, "collective_s": collective_s}
    bottleneck = max(terms, key=terms.get)
    total = max(compute_s, memory_s, collective_s)
    cal = {"compute_s": compute_s, "memory_floor_s": memory_floor_s,
           "collective_wire_s": wire_adj_s}
    cal_bottleneck = max(cal, key=cal.get)
    cal_total = max(cal.values())
    return {**terms, "memory_floor_s": memory_floor_s,
            "collective_wire_s": wire_s,
            "collective_wire_bf16adj_s": wire_adj_s,
            "bottleneck": bottleneck.replace("_s", ""),
            "bottleneck_calibrated": cal_bottleneck.replace("_s", ""),
            "step_lower_bound_s": total,
            "step_bound_calibrated_s": cal_total,
            "compute_fraction": compute_s / total if total > 0 else 0.0,
            "compute_fraction_calibrated": compute_s / cal_total if cal_total > 0 else 0.0}


def _leaves(tree):
    if hasattr(tree, "placements"):         # a DTensor, or a launch.steps.TensorSpec
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif tree is not None:
        yield tree


def _local_shape(leaf, mesh) -> tuple:
    """The shape of the shard rank 0 holds: a DTensor's own local shard; a
    ``TensorSpec`` split by its placements on ``mesh`` (a dim sharded over
    mesh dims in mesh order, each split by ceiling, as DTensor splits an
    uneven dim: rank 0 holds the largest shard); a plain tensor whole."""
    from torch.distributed.tensor import DTensor, Shard

    if isinstance(leaf, DTensor):
        return tuple(leaf.to_local().shape)
    shape = list(leaf.shape)
    placements = getattr(leaf, "placements", None)
    if placements is None:
        return tuple(shape)
    if mesh is None:
        raise ValueError(f"{leaf} is placed on a mesh: pass the mesh")
    for size, p in zip(mesh.shape, placements):
        if isinstance(p, Shard):
            shape[p.dim] = -(-shape[p.dim] // size)
    return tuple(shape)


def tree_local_bytes(tree, mesh=None) -> float:
    """Per-device bytes of every tensor in a tree of dicts, lists, tuples
    and tensors (a ``torch.nn.Module``'s parameters included), as the
    reference's counts a tree of sharded ``ShapeDtypeStruct``s: a DTensor
    by its local shard, a ``launch.steps.TensorSpec`` by its placements on
    ``mesh`` (``_local_shape``), a plain or ``meta`` tensor whole.  A 0-d
    tensor counts one element."""
    if hasattr(tree, "parameters"):
        tree = list(tree.parameters())
    total = 0.0
    for leaf in _leaves(tree):
        n = 1
        for dim in _local_shape(leaf, mesh):
            n *= int(dim)
        total += float(n) * leaf.dtype.itemsize
    return total


def model_flops(cfg, shape, n_devices: int) -> float:
    """Analytic useful FLOPs per device: 6·N_active·tokens (train) or
    2·N_active·tokens (a forward: prefill, or one decode token a sequence).
    N counts the logical (unpadded) parameters; attention's score products
    are not in it."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        total = 6.0 * n_active * shape.global_batch * shape.seq_len
    elif shape.kind == "prefill":
        total = 2.0 * n_active * shape.global_batch * shape.seq_len
    else:  # decode: one token per sequence
        total = 2.0 * n_active * shape.global_batch
    return total / n_devices
