"""simlint for the port — determinism & concurrency analysis of
``src/repro_torch/`` and its tests.

The port's invariants (sim-path purity, lock ordering, DES discipline,
test wall-clock hygiene) as machine-checked rules, with the JAX package's
rules and a manifest of the port's own.  Stdlib only: it imports neither
``torch`` nor ``jax``.  Run with ``python -m repro_torch.analysis`` or the
``repro-torch-lint`` console script; the gate is
``tests/test_torch_static_analysis.py``.
"""

from repro_torch.analysis.cli import analyze_file, iter_source_files, run_analysis
from repro_torch.analysis.lockwatch import LockWatch
from repro_torch.analysis.manifest import DEFAULT_MANIFEST, LockSite, Manifest
from repro_torch.analysis.report import RULES, AnalysisReport, Finding

__all__ = [
    "AnalysisReport",
    "DEFAULT_MANIFEST",
    "Finding",
    "LockSite",
    "LockWatch",
    "Manifest",
    "RULES",
    "analyze_file",
    "iter_source_files",
    "run_analysis",
]
