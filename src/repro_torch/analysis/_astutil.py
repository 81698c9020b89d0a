"""Shared AST machinery: import-alias resolution and scoped visiting.

Every static pass works on the same primitives:

* ``ImportMap`` — resolves ``Name``/``Attribute`` nodes to dotted module
  paths through the file's import aliases (``import time as t`` →
  ``t.sleep`` resolves to ``"time.sleep"``), so rules match *semantics*,
  not spelling.
* ``ScopedVisitor`` — an ``ast.NodeVisitor`` that maintains the dotted
  qualname of the enclosing class/function stack plus the header line of
  each enclosing scope (where a scope-level pragma may sit).
* ``FileContext`` — per-file state: source, pragmas, manifest, and the
  ``report()`` sink that applies pragma suppression.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field

from repro_torch.analysis.manifest import Manifest
from repro_torch.analysis.pragmas import Pragma
from repro_torch.analysis.report import Finding

__all__ = ["ImportMap", "ScopedVisitor", "FileContext", "decorator_name"]


class ImportMap:
    """File-scoped import alias table (collected over the whole tree —
    function-local imports count; shadowing is rare enough to ignore)."""

    def __init__(self, tree: ast.AST) -> None:
        self.modules: dict[str, str] = {}   # local name -> module path
        self.members: dict[str, str] = {}   # local name -> "module.attr"
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    if alias.asname:
                        self.modules[alias.asname] = alias.name
                    else:
                        root = alias.name.split(".")[0]
                        self.modules[root] = root
            elif isinstance(node, ast.ImportFrom) and node.module \
                    and node.level == 0:
                for alias in node.names:
                    self.members[alias.asname or alias.name] = \
                        f"{node.module}.{alias.name}"

    def resolve(self, node: ast.AST) -> str | None:
        """Dotted path for a Name/Attribute chain, or None."""
        if isinstance(node, ast.Name):
            return self.members.get(node.id) or self.modules.get(node.id)
        if isinstance(node, ast.Attribute):
            base = self.resolve(node.value)
            if base is not None:
                return f"{base}.{node.attr}"
        return None


@dataclass
class FileContext:
    path: str                      # repo-relative posix path
    tree: ast.AST
    manifest: Manifest
    pragmas: dict[int, Pragma]
    findings: list[Finding] = field(default_factory=list)

    def report(self, rule: str, line: int, message: str,
               scope_lines: tuple[int, ...] = ()) -> None:
        """Record a finding unless a pragma on the offending line — or on
        an enclosing def/class header — covers the rule."""
        for ln in (line, *scope_lines):
            p = self.pragmas.get(ln)
            if p is not None and p.covers(rule):
                p.used = True
                return
        self.findings.append(Finding(self.path, line, rule, message))


class ScopedVisitor(ast.NodeVisitor):
    """NodeVisitor tracking the enclosing qualname and scope header lines."""

    def __init__(self, ctx: FileContext) -> None:
        self.ctx = ctx
        self.imports = ImportMap(ctx.tree)
        self._names: list[str] = []
        self._scope_lines: list[int] = []

    @property
    def qualname(self) -> str:
        return ".".join(self._names)

    @property
    def scope_lines(self) -> tuple[int, ...]:
        return tuple(self._scope_lines)

    def _enter(self, node) -> None:
        self._names.append(node.name)
        self._scope_lines.append(node.lineno)
        self.enter_scope(node)
        self.generic_visit(node)
        self.exit_scope(node)
        self._names.pop()
        self._scope_lines.pop()

    # subclass hooks
    def enter_scope(self, node) -> None:  # noqa: B027 — optional hook
        pass

    def exit_scope(self, node) -> None:  # noqa: B027 — optional hook
        pass

    visit_FunctionDef = _enter
    visit_AsyncFunctionDef = _enter
    visit_ClassDef = _enter


def decorator_name(dec: ast.AST) -> str:
    """Dotted spelling of a decorator expression ('pytest.mark.slow')."""
    if isinstance(dec, ast.Call):
        return decorator_name(dec.func)
    if isinstance(dec, ast.Attribute):
        return f"{decorator_name(dec.value)}.{dec.attr}"
    if isinstance(dec, ast.Name):
        return dec.id
    return ""
