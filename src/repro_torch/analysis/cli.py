"""simlint entry point: walk the repo, run every pass, render the verdict.

``python -m repro_torch.analysis`` (or the ``repro-torch-lint`` console
script) scans ``src/`` and ``tests/`` under the repo root, minus what the
port manifest excludes (the JAX package and its tests), and exits non-zero
on any finding.  ``tests/test_torch_static_analysis.py`` runs the same
:func:`run_analysis` in-process as the port's gate.
"""

from __future__ import annotations

import argparse
import ast
import os

from repro_torch.analysis._astutil import FileContext
from repro_torch.analysis.des_rules import run_des_pass
from repro_torch.analysis.locks import extract_lock_sites, run_lock_pass
from repro_torch.analysis.manifest import DEFAULT_MANIFEST, Manifest
from repro_torch.analysis.pragmas import scan_pragmas
from repro_torch.analysis.purity import run_purity_pass
from repro_torch.analysis.report import AnalysisReport, Finding
from repro_torch.analysis.testaudit import run_test_audit

__all__ = ["run_analysis", "analyze_file", "iter_source_files", "main"]

_SCAN_DIRS = ("src", "tests")


def _relpath(path: str, root: str) -> str:
    rel = os.path.relpath(path, root)
    return rel.replace(os.sep, "/")


def iter_source_files(root: str,
                      manifest: Manifest = DEFAULT_MANIFEST) -> list[str]:
    """Absolute paths of every ``.py`` file under root's scan dirs,
    manifest exclusions applied, sorted for stable output."""
    out: list[str] = []
    for sub in _SCAN_DIRS:
        base = os.path.join(root, sub)
        for dirpath, dirnames, filenames in os.walk(base):
            dirnames[:] = sorted(d for d in dirnames
                                 if d not in ("__pycache__", ".git"))
            for fn in sorted(filenames):
                if not fn.endswith(".py"):
                    continue
                full = os.path.join(dirpath, fn)
                if manifest.is_excluded(_relpath(full, root)):
                    continue
                out.append(full)
    return out


def analyze_file(path: str, rel: str, manifest: Manifest,
                 source: str | None = None) -> FileContext:
    """Run every applicable pass over one file; returns its FileContext
    (findings, pragmas) — test files get the test audit, everything else
    gets purity + DES + lock passes."""
    if source is None:
        with open(path, encoding="utf-8") as f:
            source = f.read()
    pragmas, pragma_findings = scan_pragmas(rel, source)
    try:
        tree = ast.parse(source, filename=rel)
    except SyntaxError as exc:
        ctx = FileContext(rel, ast.Module(body=[], type_ignores=[]),
                          manifest, pragmas)
        ctx.findings.extend(pragma_findings)
        ctx.findings.append(Finding(rel, exc.lineno or 1, "parse",
                                    f"syntax error: {exc.msg}"))
        return ctx
    ctx = FileContext(rel, tree, manifest, pragmas)
    ctx.findings.extend(pragma_findings)
    if manifest.is_test_file(rel):
        run_test_audit(ctx)
    elif not manifest.is_test_exempt(rel):
        # conftest/_hypothesis_compat are exempt from EVERY pass, not
        # just the test audit: they are harness plumbing
        run_purity_pass(ctx)
        run_des_pass(ctx)
        run_lock_pass(ctx)
    return ctx


def run_analysis(root: str,
                 manifest: Manifest = DEFAULT_MANIFEST) -> AnalysisReport:
    report = AnalysisReport()
    pragma_sites: list[tuple[str, int]] = []
    for path in iter_source_files(root, manifest):
        rel = _relpath(path, root)
        ctx = analyze_file(path, rel, manifest)
        report.findings.extend(ctx.findings)
        report.files_scanned += 1
        pragma_sites.extend((rel, p.line) for p in ctx.pragmas.values())
    report.pragma_count = len(pragma_sites)
    if report.pragma_count > manifest.max_pragmas:
        listing = ", ".join(f"{p}:{ln}" for p, ln in sorted(pragma_sites))
        report.findings.append(Finding(
            "<repo>", 0, "pragma",
            f"pragma budget exceeded: {report.pragma_count} > "
            f"{manifest.max_pragmas} ({listing}) — fix violations instead "
            f"of suppressing them, or raise max_pragmas deliberately"))
    return report


def _print_lock_inventory(root: str, manifest: Manifest) -> None:
    print("lock constructor sites (static):")
    for path in iter_source_files(root, manifest):
        rel = _relpath(path, root)
        ctx = analyze_file(path, rel, manifest)
        for kind, qualname, line in extract_lock_sites(ctx):
            reg = "registered" if manifest.lock_registered(rel, qualname) \
                else "UNREGISTERED"
            print(f"  {rel}:{line}: {kind} in "
                  f"'{qualname or '<module>'}' [{reg}]")
    print()
    print("manifest known_locks (the documented acquisition order):")
    for site in manifest.known_locks:
        print(f"  {site.kind:9s} {site.path}::{site.qualname or '<module>'}"
              f" — {site.note}")


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="repro-torch-lint",
        description="simlint: determinism & concurrency rules for the "
                    "streaming-USL repro's PyTorch port, machine-checked")
    parser.add_argument("--root", default=None,
                        help="repo root (default: auto-detect from this "
                             "package's location)")
    parser.add_argument("--locks", action="store_true",
                        help="print the static lock inventory and the "
                             "manifest's documented order, then exit")
    args = parser.parse_args(argv)
    root = args.root
    if root is None:
        # src/repro_torch/analysis/cli.py -> repo root holds src/
        here = os.path.dirname(os.path.abspath(__file__))
        root = os.path.dirname(os.path.dirname(os.path.dirname(here)))
    if args.locks:
        _print_lock_inventory(root, DEFAULT_MANIFEST)
        return 0
    report = run_analysis(root)
    print(report.render())
    return 0 if report.ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
