"""Checkpoint/restart: save/restore of a tree of tensors, with async writes.

Ports ``repro.training.checkpoint`` with its on-disk layout: one directory
``step_<9 digits>`` holding ``arrays.npz`` (every leaf, keyed by its path)
and ``manifest.json`` (step, each leaf's key, shape and dtype), written
under ``<dir>.tmp`` and published by an atomic rename, so a failure during
a write never corrupts the latest checkpoint.  bfloat16 leaves are stored
as their raw 16 bits (uint16), since npz cannot hold bfloat16.

A tree is a dict whose values are tensors, ``nn.Module``s (their
``state_dict`` names: ``stack.0.attn.wq``), ``OptState``-like named tuples,
dicts or lists of these; a leaf's key joins the path with ``/``
(``params/stack.0.attn.wq``, ``opt/mu/stack.0.attn.wq``, ``opt/step``).
``restore_checkpoint`` copies the stored values into the tensors of
``tree_like`` in place (on their devices and dtypes), so a module keeps its
parameters' identity, and returns that tree.

Under a mesh a leaf may be a DTensor: it is saved as its full tensor (a
collective, so every rank saves at the same steps), which makes the files
those of the one-device path, and only rank 0 writes them; a restore
copies each rank's shard of the stored value into the leaf, at its
placements.  ``CheckpointManager.wait`` ends with a barrier over the
ranks, so a restore after it reads a complete checkpoint.

``CheckpointManager`` takes a host snapshot of every tensor on the
caller's thread (the training loop may then overwrite its tensors in
place) before a background ``threading.Thread`` writes it; at most one
write is outstanding, and ``wait`` joins it.  Nothing else is shared with
the writer, so it needs no lock.
"""

from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor, distribute_tensor

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step", "CheckpointManager"]


def _flatten(tree, prefix: str = "") -> dict[str, torch.Tensor]:
    """``{key: tensor}`` of every leaf of ``tree``, in its order."""
    if isinstance(tree, torch.Tensor):
        return {prefix: tree}
    if isinstance(tree, nn.Module):
        items = tree.state_dict(keep_vars=True).items()
    elif isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        raise TypeError(f"{prefix or 'tree'}: cannot checkpoint a {type(tree).__name__}")
    out = {}
    for name, sub in items:
        out.update(_flatten(sub, f"{prefix}/{name}" if prefix else str(name)))
    return out


def _to_numpy(t: torch.Tensor) -> tuple[np.ndarray, str]:
    """A host copy of ``t`` (a DTensor's full tensor) and its dtype's name;
    bfloat16 as uint16 bits."""
    if isinstance(t, DTensor):
        t = t.detach().full_tensor()
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    return t.numpy(), str(t.dtype).removeprefix("torch.")


def _snapshot(tree) -> dict[str, tuple[np.ndarray, str]]:
    return {key: _to_numpy(t) for key, t in _flatten(tree).items()}


def _write(ckpt_dir: str, step: int, arrays: dict[str, tuple[np.ndarray, str]]) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:09d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": int(step),
                "leaves": [{"key": key, "shape": list(arr.shape), "dtype": dtype}
                           for key, (arr, dtype) in arrays.items()]}
    np.savez(os.path.join(tmp, "arrays.npz"), **{key: arr for key, (arr, _) in arrays.items()})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)                      # atomic publish
    return final


def _ranks() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _writes() -> bool:
    """Whether this process writes checkpoints: rank 0, or no group."""
    return not dist.is_initialized() or dist.get_rank() == 0


def save_checkpoint(ckpt_dir: str, step: int, tree) -> str:
    """Write ``tree`` as step ``step`` under ``ckpt_dir`` (rank 0 writes;
    every rank must call); returns its path."""
    arrays = _snapshot(tree)
    path = os.path.join(ckpt_dir, f"step_{step:09d}")
    if _writes():
        _write(ckpt_dir, step, arrays)
    if _ranks() > 1:
        dist.barrier()
    return path


def _steps(ckpt_dir: str) -> list[int]:
    return sorted(int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
                  if d.startswith("step_") and not d.endswith(".tmp"))


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = _steps(ckpt_dir)
    return steps[-1] if steps else None


@torch.no_grad()
def restore_checkpoint(ckpt_dir: str, tree_like, step: int | None = None):
    """Copy step ``step`` (default: the latest) into the tensors of
    ``tree_like`` in place; returns (tree_like, step).  Raises on a missing
    leaf or a shape that differs."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:09d}")
    with open(os.path.join(path, "manifest.json")) as f:
        dtypes = {leaf["key"]: leaf["dtype"] for leaf in json.load(f)["leaves"]}
    with np.load(os.path.join(path, "arrays.npz")) as data:
        for key, t in _flatten(tree_like).items():
            if key not in data:
                raise KeyError(f"checkpoint missing leaf {key}")
            arr = data[key]
            if list(arr.shape) != list(t.shape):
                raise ValueError(f"{key}: checkpoint shape {arr.shape} != {tuple(t.shape)}")
            src = torch.from_numpy(arr.copy())          # 0-d stays 0-d
            if dtypes.get(key) == "bfloat16":
                src = src.view(torch.int16).view(torch.bfloat16)
            if isinstance(t, DTensor):                  # this rank's shard of it
                src = distribute_tensor(src.to(t.device), t.device_mesh, t.placements,
                                        src_data_rank=None)
            t.copy_(src)
    return tree_like, step


class CheckpointManager:
    """Async, retention-managed checkpointing."""

    def __init__(self, ckpt_dir: str, keep: int = 3, async_write: bool = True):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self.async_write = async_write
        self._thread: threading.Thread | None = None

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if _ranks() > 1:
            dist.barrier()

    def save(self, step: int, tree) -> None:
        self.wait()                             # one outstanding write max
        arrays = _snapshot(tree)                # on this thread, before it returns
        if not _writes():
            return

        def write():
            _write(self.ckpt_dir, step, arrays)
            self._gc()

        if self.async_write:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()
        else:
            write()

    def _gc(self) -> None:
        for s in _steps(self.ckpt_dir)[:-self.keep]:
            shutil.rmtree(os.path.join(self.ckpt_dir, f"step_{s:09d}"), ignore_errors=True)

    def restore_latest(self, tree_like):
        self.wait()
        return restore_checkpoint(self.ckpt_dir, tree_like)
