"""Pass 2a — static lock-site extraction.

Finds every ``threading.Lock`` / ``RLock`` / ``Condition`` constructor in
the scanned sources and requires it to be registered in the manifest's
``known_locks`` — with a note stating the lock's role and its place in the
acquisition order.  New concurrency therefore cannot land silently: the
author of (say) a multiprocess engine must extend the manifest, and the
registry doubles as the human-readable lock-order documentation that the
runtime shim (``lockwatch``) verifies is acyclic in practice.
"""

from __future__ import annotations

import ast

from repro_torch.analysis._astutil import FileContext, ScopedVisitor

__all__ = ["run_lock_pass", "extract_lock_sites"]

_LOCK_CTORS = {
    "threading.Lock": "Lock",
    "threading.RLock": "RLock",
    "threading.Condition": "Condition",
}


class _LockVisitor(ScopedVisitor):
    def __init__(self, ctx: FileContext) -> None:
        super().__init__(ctx)
        self.sites: list[tuple[str, str, int]] = []   # (kind, qualname, line)

    def visit_Call(self, node: ast.Call) -> None:
        dotted = self.imports.resolve(node.func)
        kind = _LOCK_CTORS.get(dotted or "")
        if kind is not None:
            self.sites.append((kind, self.qualname, node.lineno))
            if not self.ctx.manifest.lock_registered(self.ctx.path,
                                                     self.qualname):
                self.ctx.report(
                    "lock-site", node.lineno,
                    f"unregistered threading.{kind} constructed in "
                    f"'{self.qualname or '<module>'}' — add a LockSite "
                    f"entry (with an acquisition-order note) to the "
                    f"manifest's known_locks", self.scope_lines)
        self.generic_visit(node)


def run_lock_pass(ctx: FileContext) -> None:
    _LockVisitor(ctx).visit(ctx.tree)


def extract_lock_sites(ctx: FileContext) -> list[tuple[str, str, int]]:
    """(kind, qualname, line) for every lock constructor in the file —
    the informational inventory the CLI's ``--locks`` mode prints."""
    quiet = FileContext(ctx.path, ctx.tree, ctx.manifest, ctx.pragmas)
    v = _LockVisitor(quiet)
    v.visit(ctx.tree)
    return v.sites
