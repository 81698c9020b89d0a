"""The port's determinism & concurrency manifest: its contract as data.

This file IS the contract the analyzer enforces on ``src/repro_torch/``
and the port's tests.  Every module (and, where one file hosts both
worlds, every class/function) is classified:

* ``sim`` — code on the simulation path: the DES core and its fast
  replay, the broker and sim engine, the sim backends, the autoscale tick,
  USL fitting, the Mini-App, StreamInsight and the what-if tournaments.
  Sim-path code must be deterministic given a seed: no wall clock, no
  unseeded global random state, no salted builtin ``hash()`` routing.
  The paper's USL claims are measured on this substrate, so
  nondeterminism here silently corrupts the science.
* ``wall`` — code that legitimately lives on the wall clock: the threaded
  engine, the real (local/torchdevice) backends, the wall-clock producers,
  the launch tooling.  The purity rules do not apply.
* ``neutral`` — everything else (models, kernels, configs...): unchecked.

Classification is first-match-wins over ``overrides`` (path glob +
qualname glob), then ``sim_modules`` / ``wall_modules`` path globs, then
``neutral``.  Globs are ``fnmatch`` patterns against repo-relative posix
paths and dotted qualnames ("" is module level).

**Scope.**  The scan walks ``src/`` and ``tests/`` like the JAX package's
simlint; ``exclude`` drops that package (``src/repro/``) and its tests
(every ``tests/test_*.py`` not named ``test_torch_*``), which keep their
own manifest.  What is left is the port, its ``test_torch_*`` files and
the ``tests/_*.py`` helpers they share; ``conftest.py`` and the
hypothesis shim stay exempt, and the known-bad corpus stays excluded.

**Lock sites.**  The port's three locks are registered below with their
place in the acquisition order.  Each also carries a ``lock-site``
pragma, because the JAX package's manifest, which the repo-wide gate
(``tests/test_static_analysis.py``) applies to every file, does not list
them.

**Extending the manifest**: add a new sim module to ``sim_modules``, its
wall classes to ``overrides`` (or ``wall_modules``), and register every
new ``threading`` lock in ``known_locks`` with a note stating its place in
the acquisition order.  ``tests/test_torch_static_analysis.py`` fails
until the manifest and the code agree — which is the point.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from fnmatch import fnmatch

__all__ = ["LockSite", "Manifest", "DEFAULT_MANIFEST"]


def _match_path(path: str, pattern: str) -> bool:
    """fnmatch that treats ``*/x/y.py`` as suffix-anchored: it matches both
    ``repo/x/y.py`` and the repo-relative ``x/y.py`` (where the leading
    ``*`` would otherwise require a component to consume)."""
    return fnmatch(path, pattern) or fnmatch("/" + path, pattern)


@dataclass(frozen=True)
class LockSite:
    """One registered lock constructor site.

    ``note`` documents the lock's role and its place in the acquisition
    order — the runtime shim (``lockwatch``) verifies the order is acyclic,
    this registry is where a human reads what the order *is*.
    """

    path: str        # path glob, e.g. "*/repro/streaming/broker.py"
    qualname: str    # qualname glob of the constructing scope
    kind: str        # "Lock" | "RLock" | "Condition"
    note: str

    def matches(self, path: str, qualname: str) -> bool:
        return _match_path(path, self.path) \
            and fnmatch(qualname, self.qualname)


@dataclass(frozen=True)
class Manifest:
    # -- sim-path purity ----------------------------------------------------
    sim_modules: tuple[str, ...] = ()
    wall_modules: tuple[str, ...] = ()
    # (path glob, qualname glob, classification) — checked before the
    # module lists, first match wins; this is the class/function-level
    # escape for files hosting both worlds (streaming/engine.py).
    overrides: tuple[tuple[str, str, str], ...] = ()
    # -- DES discipline -----------------------------------------------------
    hot_modules: tuple[str, ...] = ()
    # class-name regex: classes matching this in a hot module are per-event
    # records and must declare __slots__ (directly, dataclass(slots=True),
    # or by being a NamedTuple)
    record_class_re: str = r"(Message|Event|Record|State|Scheduled|Column)$"
    # -- concurrency --------------------------------------------------------
    known_locks: tuple[LockSite, ...] = ()
    # -- test audit ---------------------------------------------------------
    test_globs: tuple[str, ...] = ("*/tests/*.py",)
    # test files that may touch the wall clock (threaded-engine suites);
    # every other test file is sim-classified: wall-clock-free by contract
    wall_test_files: tuple[str, ...] = ()
    # files the test audit never applies to (the wait primitive itself)
    test_exempt: tuple[str, ...] = ()
    # -- scanning -----------------------------------------------------------
    exclude: tuple[str, ...] = ()
    max_pragmas: int = 10

    def classify(self, path: str, qualname: str) -> str:
        """'sim' | 'wall' | 'neutral' for a scope at ``path::qualname``."""
        for pg, qg, cls in self.overrides:
            if _match_path(path, pg) and fnmatch(qualname, qg):
                return cls
        for pg in self.sim_modules:
            if _match_path(path, pg):
                return "sim"
        for pg in self.wall_modules:
            if _match_path(path, pg):
                return "wall"
        return "neutral"

    def is_hot(self, path: str) -> bool:
        return any(_match_path(path, pg) for pg in self.hot_modules)

    def is_test_exempt(self, path: str) -> bool:
        return any(_match_path(path, pg) for pg in self.test_exempt)

    def is_test_file(self, path: str) -> bool:
        if self.is_test_exempt(path):
            return False
        return any(_match_path(path, pg) for pg in self.test_globs)

    def is_wall_test(self, path: str) -> bool:
        return any(_match_path(path, pg) for pg in self.wall_test_files)

    def is_excluded(self, path: str) -> bool:
        return any(_match_path(path, pg) for pg in self.exclude)

    def lock_registered(self, path: str, qualname: str) -> bool:
        return any(site.matches(path, qualname) for site in self.known_locks)


DEFAULT_MANIFEST = Manifest(
    sim_modules=(
        "*/repro_torch/sim/*.py",
        "*/repro_torch/streaming/*.py",   # broker/producer/engine (sim side)
        "*/repro_torch/core/usl.py",
        "*/repro_torch/core/autoscale.py",
        "*/repro_torch/core/metrics.py",
        "*/repro_torch/core/miniapp.py",
        "*/repro_torch/core/streaminsight.py",
        # the what-if tournament: pure expand/dedupe/reduce around
        # streaminsight.run_cells, seed-deterministic reducers, no locks
        "*/repro_torch/core/whatif.py",
        "*/repro_torch/pilot/api.py",
        "*/repro_torch/pilot/backends/hpcsim.py",
        "*/repro_torch/pilot/backends/serverless.py",
        # the federation composes sim backends on one shared Simulator and
        # is lock-free: health/breaker/placement decisions are pure
        # functions of the virtual clock and CU completions
        "*/repro_torch/pilot/backends/federated.py",
        # the analytic roofline and its report: pure functions of their
        # inputs (records read in sorted order), no clock, no locks
        "*/repro_torch/roofline/*.py",
        # the logical-axis rule tables and placements: pure functions of
        # the rules, the specs and the mesh's shape; no clock, no locks
        # (a process group's collectives take none either)
        "*/repro_torch/distributed/*.py",
    ),
    wall_modules=(
        "*/repro_torch/pilot/backends/local.py",
        "*/repro_torch/pilot/backends/torchdevice.py",
        # the launchers, launch/mesh.py's process groups and meshes included
        "*/repro_torch/launch/*.py",
    ),
    overrides=(
        # streaming/engine.py hosts both engines: the threaded engine and
        # its ticker live on the wall clock by design
        ("*/repro_torch/streaming/engine.py", "ThreadedStreamingEngine*",
         "wall"),
        ("*/repro_torch/streaming/engine.py", "_WallTicker*", "wall"),
        # Timer is the wall-clock duration context manager
        ("*/repro_torch/core/metrics.py", "Timer*", "wall"),
        # miniapp's wall-clock adaptation path (threaded producer + runner)
        ("*/repro_torch/core/miniapp.py", "_WallClockProducer*", "wall"),
        ("*/repro_torch/core/miniapp.py", "_run_adaptation_threaded*",
         "wall"),
        # self-timing of the refit's wall cost (last_refit_wall_s, reported
        # to operators); no sim decision reads it
        ("*/repro_torch/core/autoscale.py", "OnlineUSLEstimator.refit",
         "wall"),
    ),
    hot_modules=(
        "*/repro_torch/sim/des.py",
        "*/repro_torch/streaming/broker.py",
        "*/repro_torch/streaming/engine.py",
        "*/repro_torch/streaming/producer.py",
        "*/repro_torch/core/metrics.py",
    ),
    # acquisition order: all three are leaves — none of them is ever held
    # while another of the three is taken, so no edge may join two of them
    known_locks=(
        LockSite("*/repro_torch/streaming/broker.py", "Broker.__init__",
                 "RLock", "broker state (topics/commits/counters); leaf on "
                 "the append path — subscribers run OUTSIDE it"),
        LockSite("*/repro_torch/streaming/engine.py", "_EngineCore.__init__",
                 "Lock", "shared accounting counters; leaf — never held "
                 "across a broker or pilot call"),
        LockSite("*/repro_torch/pilot/backends/local.py",
                 "LocalBackend.__init__", "Condition",
                 "admission gate: pool threads wait for a slot that "
                 "scale_to/preempt/restore/finish move; leaf — no call out "
                 "under it"),
    ),
    # the port's tests assert clock-independent facts only: none is a wall
    # test file, so every one is sim-classified
    wall_test_files=(),
    test_exempt=(
        "*/tests/conftest.py",              # implements wait_until
        "*/tests/_hypothesis_compat.py",    # vendored shim
    ),
    exclude=(
        "*simlint_fixtures*",               # known-bad corpus, tested apart
        "*/src/repro/*",                    # the JAX package: its own gate
        # the JAX package's tests: every tests/test_*.py whose name does not
        # start with test_torch_ (fnmatch has no negative lookahead, so the
        # prefix is refused one character at a time; no ".py" after the
        # "*", so names that end inside the prefix, test_t.py or
        # test_torch.py, are refused too)
        "*/tests/test_[!t]*",
        "*/tests/test_t[!o]*",
        "*/tests/test_to[!r]*",
        "*/tests/test_tor[!c]*",
        "*/tests/test_torc[!h]*",
        "*/tests/test_torch[!_]*",
    ),
    max_pragmas=10,
)
