"""Device meshes over ``torch.distributed``.

Ports ``repro.launch.mesh``.  Defined as functions (never module-level
constants), so importing this module touches no device state and starts no
process group.  A mesh is built by ``init_device_mesh`` over the process
group that is already initialized: ``init_world_of_one`` in-process (tests,
``chip_smoke.py``), ``torchrun``'s environment, or spawned ranks with a
``FileStore``.

    init_world_of_one("cuda")                         # nccl, rank 0 of 1
    mesh = make_test_mesh((1, 1), device_type="cuda")
"""

from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

__all__ = ["make_production_mesh", "make_test_mesh", "init_world_of_one", "backend_for"]


def backend_for(device_type: str) -> str:
    """``nccl`` for ``cuda``, ``gloo`` for ``cpu``; raises when that backend
    is missing (no quiet change of backend)."""
    if device_type == "cuda":
        if not dist.is_nccl_available():
            raise RuntimeError("torch.distributed has no nccl backend: a cuda mesh needs it")
        return "nccl"
    if device_type == "cpu":
        if not dist.is_gloo_available():
            raise RuntimeError("torch.distributed has no gloo backend: a cpu mesh needs it")
        return "gloo"
    raise ValueError(f"no process-group backend for device type {device_type!r}")


def init_world_of_one(device_type: str = "cuda") -> str:
    """Initialize the default process group as a world of one in this
    process (an in-memory ``HashStore``, rank 0, world size 1: no TCP port),
    over ``backend_for(device_type)``.  Returns the backend.  Raises if a
    group of another size or backend is already initialized."""
    backend = backend_for(device_type)
    if dist.is_initialized():
        have = dist.get_backend()
        if dist.get_world_size() != 1 or have != backend:
            raise RuntimeError(f"a process group of {dist.get_world_size()} ranks on "
                               f"{have} is already initialized; wanted 1 on {backend}")
        return backend
    dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    return backend


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """Single pod: (16, 16), axes (data, model).  Multi-pod: (2, 16, 16),
    axes (pod, data, model): the pod axis shards the global batch across
    pods (gradient all-reduce only between them)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_test_mesh(shape=(2, 4), axes=("data", "model"), device_type: str = "cuda"):
    """A small mesh over however many ranks the process group has."""
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axes))
