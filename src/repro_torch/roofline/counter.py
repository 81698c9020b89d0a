"""Per-device FLOPs, bytes and collective bytes of a step traced on ``meta``.

The port's counterpart of XLA's ``cost_analysis()`` and of the
reference's ``parse_collective_bytes`` (``repro.roofline.analysis``), which
read a compiled module that torch does not have.  ``CostCounter`` is one
``TorchDispatchMode``: run a step under it, on meta tensors and meta
DTensors over a fake process group (``launch.dryrun``), and ``cost()``
gives the ``CellCost`` of one device.

**The one rule for per-device FLOPs.**  A DTensor op counts
``torch.utils.flop_counter``'s formula at global shapes, divided by the
product of the mesh-dim sizes on which the op's (first) output is
``Shard`` or ``Partial``; a replicated output is computed whole on every
device.  A plain tensor's op counts as it is: that covers code inside
``local_region`` and DTensor's own redistribution internals.  The mode
applies the rule by letting DTensor run (it returns ``NotImplemented`` for
a DTensor op, as ``CommDebugMode`` does): DTensor then computes the op on
this rank's local shards, which arrive here as plain-tensor ops and are
counted at their shapes.  Where every sharded dim divides, the local op's
count is the rule's quotient exactly; where DTensor splits a dim unevenly,
it is rank 0's share, the largest (the fake group's rank is 0).  Ops
without a formula count no FLOPs; the ops DTensor runs on fake tensors to
propagate its shardings are not the step's and are skipped.

**Bytes** (``bytes_accessed``) are the counterpart of XLA's unfused "bytes
accessed": each counted op's tensor operands and results at their local
bytes.  Views, allocations (``empty``) and a collective's ``wait`` move no
data and are not counted; collectives count under ``collectives``.

**The kernels.**  K3, K4 and their backwards launch nothing on meta: while
a ``CostCounter`` is on the dispatch-mode stack (``active()``), their
wrappers run the kernels' checks, return outputs of the kernels' shapes
and dtypes, and ``add_kernel`` their work (``roofline.kernels``: the FLOPs
over the visible pairs and chunks as the kernel computes them, operands
read once and results written once).  ``kernel_calls`` counts those
shape-only calls by name; the launch counters stay untouched.

**Collectives** come from the ``_c10d_functional`` ops' local tensors and
group sizes, with the reference's keys and formulas: each kind's operand
bytes (``all-gather`` its input, ``reduce-scatter`` its full input,
``all-reduce`` and ``all-to-all`` their input), ``total`` their sum, and
``wire_total`` the ring algorithm's bytes on a device's busiest link
(all-reduce 2·x·(g−1)/g, all-gather and reduce-scatter x·(g−1)/g with x
the full buffer, all-to-all x).  ``wire_bf16adj`` equals ``wire_total``:
the reference's adjustment undoes XLA-CPU's bf16→f32 upcast before its
collectives, and the port's tensors carry the card's own dtypes.  A
collective over a group of one moves nothing and is not counted.  On a CPU
mesh DTensor turns a shard-dim all-to-all into an all-gather and a chunk
(torch's own fallback for gloo); the mode counts what runs, so such a
redistribution counts as an all-gather.
"""

from __future__ import annotations

import functools

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode, _get_current_dispatch_mode_stack
from torch.utils.flop_counter import flop_registry

from repro_torch.roofline.analysis import CellCost

__all__ = ["CostCounter", "active", "shape_only"]

_F = torch.ops._c10d_functional
# the functional collectives DTensor and the port issue -> the reference's
# kind; any other raises rather than count as a plain op
_COLLECTIVES = {_F.all_gather_into_tensor: "all-gather",
                _F.reduce_scatter_tensor: "reduce-scatter",
                _F.all_reduce: "all-reduce",
                _F.all_to_all_single: "all-to-all"}
_NO_DATA = {torch.ops.aten.empty, torch.ops.aten.empty_strided, torch.ops.aten.empty_like,
            torch.ops.aten.new_empty, torch.ops.aten.new_empty_strided,
            _F.wait_tensor, _F._wrap_tensor_autograd}


def _tensors(tree) -> list:
    """The tensors of an op's arguments or results (tuples, lists, dicts)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _tensors(x)]
    return []


def _nbytes(tensors) -> float:
    return float(sum(t.numel() * t.element_size() for t in tensors))


@functools.cache
def _is_view(func) -> bool:
    """An op whose result aliases an input without writing it."""
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


def _group_size(func, args, kwargs) -> int:
    names = [a.name for a in func._schema.arguments]
    bound = dict(zip(names, args), **kwargs)
    if "group_size" in bound:
        return int(bound["group_size"])
    group = bound["group_name"]
    if isinstance(group, str):
        group = dist.distributed_c10d._resolve_process_group(group)
    return group.size()


class CostCounter(TorchDispatchMode):
    """Counts the ops run under it (see the module's docstring for the
    rule); ``cost()`` is the ``CellCost`` of one device."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes_accessed = 0.0
        self.collectives: dict[str, float] = {}
        self.wire = 0.0
        self.kernel_calls: dict[str, int] = {}
        self.kernel_work: dict[str, list[float]] = {}   # name -> [FLOPs, bytes]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented       # DTensor runs it on the local shards, counted below
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        if packet in _NO_DATA or _is_view(func):
            return out
        tensors = _tensors((args, kwargs)) + _tensors(out)
        if any(isinstance(t, FakeTensor) for t in tensors):
            return out
        kind = _COLLECTIVES.get(packet)
        if kind is not None:
            self._collective(kind, _group_size(func, args, kwargs), _nbytes(_tensors(args)))
            return out
        if func.namespace == "_c10d_functional":
            raise NotImplementedError(f"no byte rule for the collective {func}")
        formula = flop_registry.get(packet)
        if formula is not None:
            self.flops += float(formula(*args, **kwargs, out_val=out))
        self.bytes_accessed += _nbytes(tensors)
        return out

    def _collective(self, kind: str, g: int, x: float) -> None:
        """A collective of ``kind`` over ``g`` devices on local operands of
        ``x`` bytes (an all-gather's input, a reduce-scatter's full input)."""
        if g <= 1:
            return
        self.collectives[kind] = self.collectives.get(kind, 0.0) + x
        if kind == "all-gather":
            self.wire += x * g * (g - 1) / g
        elif kind == "reduce-scatter":
            self.wire += x * (g - 1) / g
        elif kind == "all-reduce":
            self.wire += 2.0 * x * (g - 1) / g
        else:                           # all-to-all
            self.wire += x

    def add_kernel(self, name: str, flops: float, nbytes: float) -> None:
        """One shape-only call of the hand-written kernel ``name``, its work
        from ``roofline.kernels``."""
        self.flops += flops
        self.bytes_accessed += nbytes
        self.kernel_calls[name] = self.kernel_calls.get(name, 0) + 1
        work = self.kernel_work.setdefault(name, [0.0, 0.0])
        work[0] += flops
        work[1] += nbytes

    def cost(self) -> CellCost:
        coll = dict(sorted(self.collectives.items()))
        coll["total"] = sum(self.collectives.values())
        coll["wire_total"] = self.wire
        coll["wire_bf16adj"] = self.wire
        return CellCost(flops=self.flops, bytes_accessed=self.bytes_accessed,
                        collective_bytes=coll["total"], collectives=coll)


def active() -> CostCounter | None:
    """The ``CostCounter`` on the current dispatch-mode stack, or None.
    The stack is thread-local state that autograd carries into a backward,
    so a kernel's backward sees the counter its forward saw."""
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if isinstance(mode, CostCounter):
            return mode
    return None


def shape_only(t: torch.Tensor) -> bool:
    """A meta tensor inside a count: the kernels' wrappers return its
    results' shapes and count their work, with no data and no launch."""
    return t.device.type == "meta" and active() is not None
