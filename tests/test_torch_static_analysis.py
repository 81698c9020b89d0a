"""simlint on the port: ``repro_torch.analysis`` against ``repro.analysis``.

* **The corpus** — every file of ``tests/simlint_fixtures/`` gives the
  reference's findings under the reference test's ``FIXTURE_MANIFEST`` and
  under a port ``Manifest`` built from the same fields.
* **The whole repo** — the port's ``run_analysis`` under the reference's
  manifest (converted field by field, here and nowhere in the package)
  gives the reference's report: findings, files scanned, pragma count.
* **The port gate** — the port's own manifest over its own scope (the
  port, its ``test_torch_*`` files and the ``tests/_*.py`` helpers) gives
  0 findings; the CLI exits 0; the package loads neither torch, jax nor
  anything of ``repro``.
* **The gap it closes** — a wall-clock read planted in a copy of a port
  sim module is flagged by the port manifest and not by the reference's;
  the one allowance the port needs (``OnlineUSLEstimator.refit``'s
  self-timing) is a manifest override, not a pragma.
* **The runtime shim** — the reference's ``LockWatch`` unit tests, each run
  under both shims (one after the other, never nested) with the same
  result; and a slow subprocess that runs the port's streaming, sim-engine
  and ``local://`` adaptation tests under the port's shim and holds the
  lock graph acyclic, free of cross-component waits and holding all three
  of the port's registered lock sites.

This module is sim-classified under both manifests: it reads no clock.
"""

import dataclasses
import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import pytest

import repro.analysis as ref
import repro_torch.analysis as port
from repro_torch.analysis.locks import extract_lock_sites

from test_static_analysis import FIXTURE_MANIFEST

REPO_ROOT = str(Path(__file__).resolve().parent.parent)
FIXTURES = Path(__file__).resolve().parent / "simlint_fixtures"
FIXTURE_FILES = sorted(p.name for p in FIXTURES.glob("*.py"))
TEST_FILES = sorted(p.name for p in Path(__file__).resolve().parent.glob("test_*.py"))
SUBPROCESS_ENV = {**{k: v for k, v in os.environ.items() if k != ref.lockwatch.ENV_OUT},
                  "PYTHONPATH": os.path.join(REPO_ROOT, "src")}


def to_port(m) -> port.Manifest:
    """The port ``Manifest`` with the same fields as the reference's ``m``."""
    fields = {f.name: getattr(m, f.name) for f in dataclasses.fields(m)}
    fields["known_locks"] = tuple(port.LockSite(s.path, s.qualname, s.kind, s.note)
                                  for s in m.known_locks)
    return port.Manifest(**fields)


def as_tuples(findings) -> list:
    return [(f.path, f.line, f.rule, f.message) for f in findings]


def lint(analyze_file, path: Path, rel: str, manifest) -> list:
    return as_tuples(analyze_file(str(path), rel, manifest).findings)


# -- the corpus ---------------------------------------------------------------

def test_fixture_corpus_is_whole():
    assert len(FIXTURE_FILES) >= 12
    assert {n for n in FIXTURE_FILES if n.startswith("bad_")} >= {
        "bad_wallclock.py", "bad_global_random.py", "bad_hash_routing.py",
        "bad_negative_delay.py", "bad_missing_slots.py", "bad_lock_site.py",
        "bad_slow_sleep.py", "bad_sim_testfile.py", "bad_pragma.py"}


@pytest.mark.parametrize("name", FIXTURE_FILES)
def test_fixture_findings_equal_reference(name):
    path, rel = FIXTURES / name, f"tests/simlint_fixtures/{name}"
    want = lint(ref.analyze_file, path, rel, FIXTURE_MANIFEST)
    assert lint(port.analyze_file, path, rel, FIXTURE_MANIFEST) == want
    assert lint(port.analyze_file, path, rel, to_port(FIXTURE_MANIFEST)) == want
    if name.startswith("bad_"):
        assert want, f"{name} must trip its rule"
    elif name.startswith("clean_"):
        assert want == []


def test_pragma_scan_equals_reference():
    from repro.analysis.pragmas import scan_pragmas as ref_scan
    from repro_torch.analysis.pragmas import scan_pragmas as port_scan

    for name in FIXTURE_FILES:
        src = (FIXTURES / name).read_text()
        (rp, rf), (pp, pf) = ref_scan(name, src), port_scan(name, src)
        assert as_tuples(pf) == as_tuples(rf)
        assert {k: (p.rules, p.reason) for k, p in pp.items()} == \
            {k: (p.rules, p.reason) for k, p in rp.items()}


# -- the whole repo -----------------------------------------------------------

def test_whole_repo_report_equals_reference_under_its_manifest():
    want = ref.run_analysis(REPO_ROOT)
    got = port.run_analysis(REPO_ROOT, to_port(ref.DEFAULT_MANIFEST))
    assert as_tuples(got.findings) == as_tuples(want.findings)
    assert (got.files_scanned, got.pragma_count) == (want.files_scanned, want.pragma_count)
    assert got.render() == want.render()


def test_reference_budget_is_unchanged():
    report = ref.run_analysis(REPO_ROOT)
    assert report.ok, "\n" + report.render()
    assert report.pragma_count == 8 <= ref.DEFAULT_MANIFEST.max_pragmas


# -- the port gate ------------------------------------------------------------

def test_port_repo_has_zero_findings():
    report = port.run_analysis(REPO_ROOT)
    assert report.ok, "\n" + report.render()
    assert report.files_scanned > 100
    # the three lock-site pragmas the reference gate needs; nothing else
    assert report.pragma_count == 3 <= port.DEFAULT_MANIFEST.max_pragmas


def test_port_cli_exits_zero_on_clean_repo():
    proc = subprocess.run([sys.executable, "-m", "repro_torch.analysis", "--root", REPO_ROOT],
                          capture_output=True, text=True, env=SUBPROCESS_ENV, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "0 finding(s)" in proc.stdout


def test_port_cli_lock_inventory_is_registered():
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--root", REPO_ROOT, "--locks"],
        capture_output=True, text=True, env=SUBPROCESS_ENV, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    src_sites = [ln for ln in proc.stdout.splitlines() if ln.startswith("  src/repro_torch/")]
    assert len(src_sites) == 3 and all(ln.endswith("[registered]") for ln in src_sites)


def test_the_package_loads_no_torch_jax_or_reference():
    code = ("import sys\n"
            "import repro_torch.analysis, repro_torch.analysis.cli\n"
            "import repro_torch.analysis.lockwatch\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('torch', 'jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=SUBPROCESS_ENV, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_scope_holds_the_port_tests_only():
    wrong = [name for name in TEST_FILES
             if port.DEFAULT_MANIFEST.is_excluded(f"tests/{name}")
             is name.startswith("test_torch_")]
    assert not wrong
    assert not [name for name in TEST_FILES if ref.DEFAULT_MANIFEST.is_excluded(f"tests/{name}")]


@pytest.mark.parametrize("name", ["test_.py", "test_t.py", "test_to.py", "test_tor.py",
                                  "test_torc.py", "test_torch.py", "test_torchx.py",
                                  "test_tx_torch_a.py", "test_data/x.py"])
def test_scope_refuses_short_and_near_names(name):
    assert port.DEFAULT_MANIFEST.is_excluded(f"tests/{name}")
    assert not port.DEFAULT_MANIFEST.is_excluded("tests/test_torch_a.py")


def test_scope_of_sources_and_helpers():
    m = port.DEFAULT_MANIFEST
    assert m.is_excluded("src/repro/sim/des.py")
    assert m.is_excluded("src/repro/analysis/manifest.py")
    assert m.is_excluded("tests/simlint_fixtures/bad_wallclock.py")
    for rel in ("src/repro_torch/sim/des.py", "src/repro_torch/analysis/manifest.py",
                "tests/_tf32.py", "tests/_sim_kmeans.py", "tests/_kmeans_ties.py",
                "tests/conftest.py"):
        assert not m.is_excluded(rel), rel
    assert m.is_test_exempt("tests/conftest.py")
    assert m.is_test_exempt("tests/_hypothesis_compat.py")
    assert m.is_test_file("tests/test_torch_des.py")
    assert not m.is_wall_test("tests/test_torch_des.py")


@pytest.mark.parametrize("rel, want", [
    ("src/repro_torch/sim/des.py", "sim"),
    ("src/repro_torch/sim/batched.py", "sim"),
    ("src/repro_torch/streaming/broker.py", "sim"),
    ("src/repro_torch/core/whatif.py", "sim"),
    ("src/repro_torch/pilot/backends/federated.py", "sim"),
    ("src/repro_torch/pilot/backends/local.py", "wall"),
    ("src/repro_torch/pilot/backends/torchdevice.py", "wall"),
    ("src/repro_torch/launch/characterize.py", "wall"),
    ("src/repro_torch/models/kmeans.py", "neutral"),
])
def test_port_modules_are_classified_as_the_reference_is(rel, want):
    assert port.DEFAULT_MANIFEST.classify(rel, "") == want
    ref_rel = rel.replace("repro_torch/", "repro/").replace("torchdevice", "jaxmesh")
    assert ref.DEFAULT_MANIFEST.classify(ref_rel, "") == want
    # the reference's manifest never checked the port
    assert ref.DEFAULT_MANIFEST.classify(rel, "") == "neutral"


# -- the gap it closes --------------------------------------------------------

def test_planted_wall_clock_read_is_flagged_in_a_port_sim_module(tmp_path):
    src = Path(REPO_ROOT, "src", "repro_torch", "sim", "des.py").read_text()
    planted = src + "\n\ndef _planted_now():\n    import time\n    return time.time()\n"
    line = planted.splitlines().index("    return time.time()") + 1
    dest = tmp_path / "src" / "repro_torch" / "sim" / "des.py"
    dest.parent.mkdir(parents=True)
    dest.write_text(planted)
    got = port.run_analysis(str(tmp_path))
    assert [(f.path, f.line, f.rule) for f in got.findings] == [
        ("src/repro_torch/sim/des.py", line, "wall-clock")]
    assert ref.run_analysis(str(tmp_path)).findings == []
    # the unplanted copy is clean under both
    dest.write_text(src)
    assert port.run_analysis(str(tmp_path)).ok
    assert got.files_scanned == 1


def test_refit_self_timing_is_a_manifest_override_not_a_pragma():
    m, rel = port.DEFAULT_MANIFEST, "src/repro_torch/core/autoscale.py"
    assert m.classify(rel, "OnlineUSLEstimator.refit") == "wall"
    for qualname in ("", "OnlineUSLEstimator", "OnlineUSLEstimator.maybe_refit",
                     "OnlineUSLEstimator.observe", "ControlLoop"):
        assert m.classify(rel, qualname) == "sim", qualname
    path = Path(REPO_ROOT, rel)
    assert "simlint" not in path.read_text()
    assert lint(port.analyze_file, path, rel, m) == []
    without = dataclasses.replace(
        m, overrides=tuple(o for o in m.overrides if "autoscale" not in o[0]))
    found = port.analyze_file(str(path), rel, without).findings
    assert [f.rule for f in found] == ["wall-clock", "wall-clock"]
    assert all("OnlineUSLEstimator.refit" in f.message for f in found)


def test_port_lock_sites_are_registered_and_keep_their_pragmas():
    sites = []
    for rel in ("src/repro_torch/streaming/broker.py", "src/repro_torch/streaming/engine.py",
                "src/repro_torch/pilot/backends/local.py"):
        ctx = port.analyze_file(os.path.join(REPO_ROOT, rel), rel, port.DEFAULT_MANIFEST)
        for kind, qualname, line in extract_lock_sites(ctx):
            assert port.DEFAULT_MANIFEST.lock_registered(rel, qualname)
            assert ctx.pragmas[line].covers("lock-site")
            sites.append((rel, kind, qualname))
    assert sites == [
        ("src/repro_torch/streaming/broker.py", "RLock", "Broker.__init__"),
        ("src/repro_torch/streaming/engine.py", "Lock", "_EngineCore.__init__"),
        ("src/repro_torch/pilot/backends/local.py", "Condition", "LocalBackend.__init__")]


def test_components_of_the_port_shim():
    assert not hasattr(port.lockwatch, "install_from_env")
    assert port.lockwatch._component("src/repro_torch/pilot/backends/torchdevice.py:1:f") \
        == "backend.torchdevice"
    assert port.lockwatch._component("src/repro_torch/sim/des.py:1:f") == "repro_torch.other"
    assert port.lockwatch._component("/usr/lib/python3/queue.py:1:f") == "external"


# -- the runtime shim ---------------------------------------------------------

def abba():
    import simlint_fixtures.bad_lock_cycle as fixture

    fixture.provoke()


def ordered_nesting():
    outer = threading.Lock()
    inner = threading.Lock()
    for _ in range(3):
        with outer:
            with inner:
                pass


def rlock_reentry():
    lk = threading.RLock()
    with lk:
        with lk:
            pass


def wait_while_holding():
    held = threading.Lock()
    cond = threading.Condition()
    with held:
        with cond:
            cond.wait(timeout=0.01)


def event_round_trip():
    ev = threading.Event()
    hits = []

    def setter():
        hits.append(1)
        ev.set()

    t = threading.Thread(target=setter)
    t.start()
    assert ev.wait(timeout=5.0)
    t.join(timeout=5.0)
    assert hits == [1]


def watched(lock_watch_cls, scenario):
    watch = lock_watch_cls().install()
    try:
        scenario()
    finally:
        watch.uninstall()
    return watch


# (scenario, whether its counts are fixed: the two that start threads take
# a timing-dependent number of Condition re-acquires in Thread.start/Event)
SCENARIOS = {"abba": (abba, False), "ordered_nesting": (ordered_nesting, True),
             "rlock_reentry": (rlock_reentry, True),
             "wait_while_holding": (wait_while_holding, True),
             "event_round_trip": (event_round_trip, False)}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_lockwatch_twin_equals_reference(name):
    scenario, fixed_counts = SCENARIOS[name]
    want = watched(ref.LockWatch, scenario)
    got = watched(port.LockWatch, scenario)
    assert threading.Lock is want._saved["Lock"]      # both shims came off
    assert got.cycles() == want.cycles()
    assert got.edges == want.edges
    assert got.sites == want.sites
    if fixed_counts:
        assert got.acquisitions == want.acquisitions
        assert got.waits == want.waits
    if name == "abba":
        assert got.cycles() and all("bad_lock_cycle.py" in s for c in got.cycles() for s in c)
    elif name == "ordered_nesting":
        assert got.acquisitions == 6 and got.cycles() == [] and len(got.edges) == 1
    elif name == "rlock_reentry":
        assert got.edges == {} and got.acquisitions == 1
    elif name == "wait_while_holding":
        assert got.waits and all(w["held"] for w in got.waits)
    else:
        assert got.cycles() == []


LOCKWATCH_RUN = ("import sys\n"
                 "import pytest\n"
                 "from repro_torch.analysis import LockWatch\n"
                 "watch = LockWatch().install()\n"
                 "try:\n"
                 "    rc = pytest.main(['-q', '-p', 'no:cacheprovider', *sys.argv[2:]])\n"
                 "finally:\n"
                 "    watch.uninstall()\n"
                 "watch.dump(sys.argv[1])\n"
                 "raise SystemExit(int(rc))\n")


@pytest.mark.slow
def test_port_lock_graph_is_acyclic_over_the_threaded_tests(tmp_path):
    """The port's streaming, sim-engine and ``local://`` adaptation tests in
    a subprocess under the port's shim, installed before the run builds
    any engine: the acquisition graph has no cycle and no cross-component
    wait, and every lock site the port registers was exercised."""
    out = tmp_path / "lockgraph.json"
    tests = os.path.join(REPO_ROOT, "tests")
    proc = subprocess.run(
        [sys.executable, "-c", LOCKWATCH_RUN, str(out),
         os.path.join(tests, "test_torch_streaming.py"),
         os.path.join(tests, "test_torch_sim_engine.py"),
         os.path.join(tests, "test_torch_adaptation.py") + "::test_threaded_cell_runs_and_accounts"],
        capture_output=True, text=True, cwd=REPO_ROOT, env=SUBPROCESS_ENV, timeout=300)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    data = json.loads(out.read_text())
    assert data["acquisitions"] > 0, "shim saw no lock traffic at all"
    assert data["cycles"] == [], json.dumps(data["cycles"], indent=1)
    assert data["cross_component_waits"] == [], \
        json.dumps(data["cross_component_waits"], indent=1)
    for rel in ("src/repro_torch/streaming/broker.py", "src/repro_torch/streaming/engine.py",
                "src/repro_torch/pilot/backends/local.py"):
        ctx = port.analyze_file(os.path.join(REPO_ROOT, rel), rel, port.DEFAULT_MANIFEST)
        (_kind, _qualname, line), = extract_lock_sites(ctx)
        assert any(s.startswith(f"{rel}:{line}:") for s in data["sites"]), (rel, line)
