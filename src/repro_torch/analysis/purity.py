"""Pass 1 — sim-path purity.

Code the manifest classifies ``sim`` must be deterministic given a seed:

* **wall-clock** — no ``time.time``/``perf_counter``/``monotonic``/
  ``sleep``/``datetime.now`` (reads *or* references: storing
  ``time.perf_counter`` as a default clock leaks the wall clock just as
  surely as calling it);
* **global-random** — no module-level ``random.*`` and no legacy global
  ``np.random.*`` (``np.random.seed``/``rand``/...); randomness flows
  through seeded ``np.random.default_rng`` / ``Generator`` instances
  (``Simulator.rng`` is the canonical stream);
* **salted-hash** — no builtin ``hash()``: string hashing is salted per
  process (PYTHONHASHSEED), which makes key→partition routing
  nondeterministic across the experiment pool's workers; route with
  ``broker.stable_hash`` (crc32).

The classification is scope-granular: ``streaming/engine.py`` is sim by
default while its ``ThreadedStreamingEngine``/``_WallTicker`` classes are
wall-classified in the manifest and skipped here.
"""

from __future__ import annotations

import ast

from repro_torch.analysis._astutil import FileContext, ScopedVisitor

__all__ = ["run_purity_pass", "WALL_CLOCK_NAMES"]

WALL_CLOCK_NAMES = frozenset({
    "time.time", "time.time_ns", "time.perf_counter", "time.perf_counter_ns",
    "time.monotonic", "time.monotonic_ns", "time.process_time",
    "time.process_time_ns", "time.sleep",
    "datetime.datetime.now", "datetime.datetime.utcnow",
    "datetime.datetime.today", "datetime.date.today",
})

# np.random members that are seeded-generator constructors, not global state
_NP_RANDOM_ALLOWED = frozenset({
    "default_rng", "Generator", "SeedSequence", "BitGenerator",
    "PCG64", "PCG64DXSM", "Philox", "MT19937", "SFC64",
})
_RANDOM_ALLOWED = frozenset({"Random"})     # explicit seeded instance


class _PurityVisitor(ScopedVisitor):
    def __init__(self, ctx: FileContext) -> None:
        super().__init__(ctx)
        self._cls_stack = [ctx.manifest.classify(ctx.path, "")]
        self._seen: set[tuple[str, int]] = set()

    def enter_scope(self, node) -> None:
        self._cls_stack.append(
            self.ctx.manifest.classify(self.ctx.path, self.qualname))

    def exit_scope(self, node) -> None:
        self._cls_stack.pop()

    @property
    def _sim(self) -> bool:
        return self._cls_stack[-1] == "sim"

    def _flag(self, rule: str, node: ast.AST, message: str) -> None:
        key = (rule, node.lineno)
        if key in self._seen:
            return
        self._seen.add(key)
        self.ctx.report(rule, node.lineno, message, self.scope_lines)

    def _check_dotted(self, node: ast.AST) -> None:
        dotted = self.imports.resolve(node)
        if dotted is None:
            return
        if dotted in WALL_CLOCK_NAMES:
            self._flag("wall-clock", node,
                       f"sim-path scope '{self.qualname or '<module>'}' "
                       f"references {dotted} — sim code runs on the "
                       f"virtual clock only")
            return
        if dotted.startswith("random."):
            member = dotted.split(".", 1)[1].split(".")[0]
            if member not in _RANDOM_ALLOWED:
                self._flag("global-random", node,
                           f"sim-path use of global {dotted} — draw from a "
                           f"seeded np.random.default_rng stream instead")
        elif dotted.startswith("numpy.random."):
            member = dotted.split(".")[2]
            if member not in _NP_RANDOM_ALLOWED:
                self._flag("global-random", node,
                           f"sim-path use of legacy global {dotted} — use "
                           f"a seeded np.random.default_rng stream")

    def visit_Attribute(self, node: ast.Attribute) -> None:
        if self._sim:
            self._check_dotted(node)
        self.generic_visit(node)

    def visit_Name(self, node: ast.Name) -> None:
        # catches from-imports: ``from time import sleep; sleep(...)``
        if self._sim and isinstance(node.ctx, ast.Load):
            self._check_dotted(node)

    def visit_Call(self, node: ast.Call) -> None:
        if self._sim and isinstance(node.func, ast.Name) \
                and node.func.id == "hash":
            self._flag("salted-hash", node,
                       "builtin hash() is PYTHONHASHSEED-salted per "
                       "process — use broker.stable_hash (crc32) for "
                       "any routing/bucketing decision")
        self.generic_visit(node)


def run_purity_pass(ctx: FileContext) -> None:
    _PurityVisitor(ctx).visit(ctx.tree)
