"""Finding/report types shared by every simlint pass.

A ``Finding`` is one rule violation anchored to a source line; an
``AnalysisReport`` is the outcome of one analyzer run over a file set.
Findings are plain, orderable data so the CLI, the tier-1 test gate and
the fixtures-corpus tests all consume the same objects.
"""

from __future__ import annotations

from dataclasses import dataclass, field

__all__ = ["Finding", "AnalysisReport", "RULES"]

# Every rule the analyzer can emit, with the one-line contract it enforces.
# ``pragmas.py`` validates ``simlint: allow[...]`` rule ids against this
# table, so a typo'd pragma is itself a finding instead of a silent no-op.
RULES: dict[str, str] = {
    "wall-clock": "sim-path code must not read or wait on the wall clock "
                  "(time.time/perf_counter/sleep/datetime.now): all timing "
                  "flows through the virtual clock",
    "global-random": "sim-path code must not touch unseeded global random "
                     "state (random.*, legacy np.random.*): draw through a "
                     "seeded Generator (np.random.default_rng)",
    "salted-hash": "sim-path code must not route on builtin hash(): string "
                   "hashing is PYTHONHASHSEED-salted per process — use "
                   "broker.stable_hash (crc32)",
    "negative-delay": "DES discipline: schedule/schedule_fast/call_later "
                      "must never be given a negative delay",
    "slots": "hot-path record classes (per-event/per-message objects in "
             "the hot modules) must declare __slots__",
    "lock-site": "every threading.Lock/RLock/Condition constructor must be "
                 "registered in the manifest's KNOWN_LOCKS with an ordering "
                 "note — the lock-order shim keys its graph on these sites",
    "test-sleep": "tests must not call time.sleep directly: wall waits go "
                  "through conftest.wait_until (condition with a deadline)",
    "test-slow-wait": "slow-marked tests may only reach wall time through "
                      "conftest.wait_until",
    "test-wall": "sim-classified test modules must stay wall-clock-free "
                 "(assert clock-independent facts only)",
    "pragma": "simlint pragmas must name a known rule and carry a "
              "non-empty justification, within the repo-wide budget",
    "parse": "source file failed to parse",
}


@dataclass(frozen=True, order=True)
class Finding:
    """One rule violation at ``path:line``."""

    path: str          # repo-relative posix path
    line: int
    rule: str
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


@dataclass
class AnalysisReport:
    findings: list[Finding] = field(default_factory=list)
    files_scanned: int = 0
    pragma_count: int = 0

    @property
    def ok(self) -> bool:
        return not self.findings

    def render(self) -> str:
        lines = [f.render() for f in sorted(self.findings)]
        lines.append(
            f"simlint: {len(self.findings)} finding(s), "
            f"{self.pragma_count} pragma(s) across "
            f"{self.files_scanned} file(s)")
        return "\n".join(lines)
