"""Pass 4 — test audit (the suite's manual wall-clock audit, automated).

The suite's wall-clock hygiene rules, as machine checks:

* **test-wall** — test modules NOT listed in the manifest's
  ``wall_test_files`` are sim-classified: they must be entirely
  wall-clock-free (no ``time.*`` reads/sleeps, no ``datetime.now``).
  This is the ROADMAP caveat — "wall-clock adaptation tests assert only
  clock-independent facts ... keep it that way" — enforced;
* **test-sleep** — even in wall-classified test modules, a bare
  ``time.sleep`` is a flake seed: every wait must be a *condition with a
  deadline* through ``conftest.wait_until``.  (A sleep that is genuinely
  a workload, not a wait, takes a justified pragma.)
* **test-slow-wait** — inside a ``@pytest.mark.slow`` test body, ANY
  direct wall-clock access is flagged: slow tests reach wall time only
  through ``conftest.wait_until``.

``conftest.py`` itself (the wait primitive) is exempt via the manifest.
"""

from __future__ import annotations

import ast

from repro_torch.analysis._astutil import FileContext, ScopedVisitor, decorator_name
from repro_torch.analysis.purity import WALL_CLOCK_NAMES

__all__ = ["run_test_audit"]


def _is_slow_marker(dec: ast.AST) -> bool:
    name = decorator_name(dec)
    return name.endswith("mark.slow") or name == "slow"


def _module_slow(tree: ast.Module) -> bool:
    """True when a module-level ``pytestmark`` carries the slow marker."""
    for stmt in tree.body:
        if isinstance(stmt, ast.Assign) \
                and any(isinstance(t, ast.Name) and t.id == "pytestmark"
                        for t in stmt.targets):
            values = (stmt.value.elts
                      if isinstance(stmt.value, (ast.List, ast.Tuple))
                      else [stmt.value])
            if any(_is_slow_marker(v) for v in values):
                return True
    return False


class _TestAuditVisitor(ScopedVisitor):
    def __init__(self, ctx: FileContext) -> None:
        super().__init__(ctx)
        self._wall_file = ctx.manifest.is_wall_test(ctx.path)
        self._slow_depth = 1 if _module_slow(ctx.tree) else 0
        self._seen: set[tuple[str, int]] = set()

    def enter_scope(self, node) -> None:
        if not isinstance(node, ast.ClassDef) \
                and any(_is_slow_marker(d) for d in node.decorator_list):
            self._slow_depth += 1
            node._simlint_slow = True

    def exit_scope(self, node) -> None:
        if getattr(node, "_simlint_slow", False):
            self._slow_depth -= 1

    def _flag(self, rule: str, node: ast.AST, message: str) -> None:
        key = (rule, node.lineno)
        if key in self._seen:
            return
        self._seen.add(key)
        self.ctx.report(rule, node.lineno, message, self.scope_lines)

    def _check(self, node: ast.AST) -> None:
        dotted = self.imports.resolve(node)
        if dotted not in WALL_CLOCK_NAMES:
            return
        if not self._wall_file:
            self._flag("test-wall", node,
                       f"sim-classified test module uses {dotted} — sim "
                       f"tests assert clock-independent facts only (or "
                       f"move the file to the manifest's wall_test_files)")
        elif self._slow_depth > 0:
            self._flag("test-slow-wait", node,
                       f"slow-marked test reaches wall time via {dotted} — "
                       f"slow tests wait only through conftest.wait_until")
        elif dotted == "time.sleep":
            self._flag("test-sleep", node,
                       "bare time.sleep in a test — wait on a condition "
                       "with a deadline via conftest.wait_until")

    def visit_Attribute(self, node: ast.Attribute) -> None:
        self._check(node)
        self.generic_visit(node)

    def visit_Name(self, node: ast.Name) -> None:
        if isinstance(node.ctx, ast.Load):
            self._check(node)


def run_test_audit(ctx: FileContext) -> None:
    _TestAuditVisitor(ctx).visit(ctx.tree)
