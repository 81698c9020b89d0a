"""Pass 3 — DES discipline.

* **negative-delay** — ``schedule``/``schedule_fast``/``call_later`` must
  never receive a (statically evident) negative delay: the DES core raises
  at runtime, but a negative constant in source is a bug that deserves to
  fail before any simulation runs.  Only constant/unary-minus-constant
  first arguments are decidable statically; runtime values stay guarded by
  ``Simulator.schedule``'s check.
* **slots** — per-event record classes in the manifest's hot modules
  (heap entries, broker messages, metric columns...) must declare
  ``__slots__``: the DES mints one per event, and a ``__dict__`` per
  record measurably moves the reference-cell benchmarks.  Satisfied by a
  literal ``__slots__``, ``@dataclass(slots=True)``, or a ``NamedTuple``
  base (tuple subclasses carry no ``__dict__`` for their fields).

Event handlers reading the wall clock are covered by the purity pass —
every sim-path scope is wall-clock-free, handlers included.
"""

from __future__ import annotations

import ast
import re

from repro_torch.analysis._astutil import FileContext, ScopedVisitor, decorator_name

__all__ = ["run_des_pass"]

_SCHEDULE_METHODS = frozenset({"schedule", "schedule_fast", "call_later"})


def _static_negative(node: ast.AST) -> bool:
    if isinstance(node, ast.Constant) and isinstance(node.value, (int, float)):
        return node.value < 0
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub) \
            and isinstance(node.operand, ast.Constant) \
            and isinstance(node.operand.value, (int, float)):
        return node.operand.value > 0
    return False


def _declares_slots(node: ast.ClassDef) -> bool:
    for stmt in node.body:
        targets = []
        if isinstance(stmt, ast.Assign):
            targets = stmt.targets
        elif isinstance(stmt, ast.AnnAssign):
            targets = [stmt.target]
        for t in targets:
            if isinstance(t, ast.Name) and t.id == "__slots__":
                return True
    return False


def _dataclass_slots(node: ast.ClassDef) -> bool:
    for dec in node.decorator_list:
        if decorator_name(dec).split(".")[-1] != "dataclass":
            continue
        if isinstance(dec, ast.Call):
            for kw in dec.keywords:
                if kw.arg == "slots" and isinstance(kw.value, ast.Constant) \
                        and kw.value.value is True:
                    return True
    return False


def _namedtuple_base(node: ast.ClassDef) -> bool:
    return any("NamedTuple" in ast.dump(base) for base in node.bases)


class _DesVisitor(ScopedVisitor):
    def __init__(self, ctx: FileContext) -> None:
        super().__init__(ctx)
        self._record_re = re.compile(ctx.manifest.record_class_re)
        self._hot = ctx.manifest.is_hot(ctx.path)

    def visit_Call(self, node: ast.Call) -> None:
        name = None
        if isinstance(node.func, ast.Attribute):
            name = node.func.attr
        elif isinstance(node.func, ast.Name):
            name = node.func.id
        if name in _SCHEDULE_METHODS and node.args \
                and _static_negative(node.args[0]):
            self.ctx.report(
                "negative-delay", node.lineno,
                f"{name}() called with a negative delay — DES events may "
                f"only be scheduled at or after the current virtual time",
                self.scope_lines)
        self.generic_visit(node)

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        if self._hot and self._record_re.search(node.name) \
                and not (_declares_slots(node) or _dataclass_slots(node)
                         or _namedtuple_base(node)):
            self.ctx.report(
                "slots", node.lineno,
                f"hot-path record class '{node.name}' must declare "
                f"__slots__ (directly, dataclass(slots=True), or as a "
                f"NamedTuple) — one __dict__ per event is measurable at "
                f"DES event rates", self.scope_lines)
        self._enter(node)


def run_des_pass(ctx: FileContext) -> None:
    _DesVisitor(ctx).visit(ctx.tree)
