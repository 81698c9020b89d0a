"""StreamInsight: end-to-end performance experimentation and modeling.

Supports the paper's workflow (§IV): experimental design (parameter grids
over machine M, parallelism N, message size MS, workload complexity WC,
container memory — plus, beyond the paper, micro-batch size ``batch_max``
and the model-sharing consistency ``policy``), automated execution on the
Streaming Mini-App, USL model fitting per scenario, and model evaluation on
unseen configurations (train/test split, RMSE vs number of training
configurations — Fig 7).

The modeling loop is batched end-to-end: ``fit_models`` stacks every
scenario group into one ``fit_usl_batch`` call (vectorized grid seed +
batched Levenberg–Marquardt; see ``repro_torch.core.usl``), and ``evaluate``
accepts a *list* of training-set sizes, building the full
``(n_train_configs × scenario)`` train-split matrix and fitting it in a
single batch — thousands of scenario models cost one vectorized pass
instead of a Python loop of scalar fits.  ``bootstrap=B`` threads through
to percentile confidence intervals for (sigma, kappa, peak_N), which are
just B more rows in the same batch, and ``backend="torch"`` (with
``device``, default ``"cuda"``) routes the fits through the float64 batched
LM on the card for very large sweeps.

Execution model: every ``StreamExperiment`` cell builds its own
``PilotComputeService`` / ``Simulator`` seeded by ``exp.seed``, so cells are
fully independent — like Pilot-Streaming's independently managed resource
containers, they are embarrassingly parallel.  ``run_cells`` exploits that
with a *persistent* process pool: workers are spawned lazily on the first
pooled sweep and reused across ``run_cells`` calls for the life of the
process, amortizing pool startup the way Pilot-Streaming keeps resource
containers warm across workloads.  Because the seed travels inside the
dataclass, parallel results are bit-identical to serial ones.

``parallel="auto"`` (the default, and what ``parallel=True`` resolves to)
switches between serial and pooled execution on an estimated-work heuristic
(``n_messages × points × centroids`` summed over uncached cells): cheap
grids run serially — on small sweeps pool IPC costs more than the cells —
and only heavy grids fan out, so parallel mode is never a pessimization.
``parallel="force"`` always uses the pool; ``parallel=False`` never does.
Cells are submitted in contiguous chunks (several cells per task) to keep
IPC overhead sublinear in grid size.

Pooled workers collect trace events in private ``MetricRegistry``s; the
summaries inside ``ExperimentResult`` are computed in-worker, so results
are identical either way, and each worker additionally returns a compact
per-(component, kind) event summary that ``run_cells`` merges into the
caller's registry (``MetricRegistry.trace_summary(run_id)``).  Run serially
when you need raw per-event traces; pooled sweeps surface merged summaries.

An optional on-disk ``ResultCache`` keyed by the experiment dataclass makes
re-runs of a sweep free.

Beyond the paper's characterize-then-model workflow, StreamInsight closes
the EILC loop (§V future work): ``AdaptationDesign`` /
``StreamInsight.run_adaptation`` execute *adaptation cells*
(``AdaptationExperiment``: a time-varying rate trace in → allocation trace,
lag trace, SLO-violation count and cost integral out) where a live
``ControlLoop`` resizes the elastic backends mid-run.  Predictive cells are
parameterized automatically from the USL models fitted on this insight's
own characterization sweep, so ``run(design)`` →
``run_adaptation(adaptation_design)`` is the paper's full characterize →
model → adapt pipeline in two calls.  Adaptation cells ride the same
``run_cells`` pool, auto-switch and typed ``ResultCache`` as
characterization cells.

Ports ``repro.core.streaminsight``; on the numpy backend its records, fits,
evaluations and reports equal the reference's bit for bit, and so do the
summaries of what-if plan cells (``AdaptationPlan``).  The persistent pool
takes no lock (the reference's pool-creation lock is designed away): the
first thread that runs a pooled sweep owns the pool, and a pooled sweep from
any other thread raises while the owner is alive; once it has ended, the
next thread to run a pooled sweep takes the pool over.
"""

from __future__ import annotations

import atexit
import concurrent.futures
import dataclasses
import hashlib
import itertools
import json
import multiprocessing
import os
import threading
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

import numpy as np

from repro_torch.core.metrics import MetricRegistry
from repro_torch.core.miniapp import (AdaptationExperiment, AdaptationPlan,
                                      AdaptationResult, AdaptationSummary,
                                      ExperimentResult, StreamExperiment,
                                      default_consistency, run_adaptation,
                                      run_experiment, run_plan)
from repro_torch.core.usl import USLFit, fit_usl_batch, fit_usl_ragged, rmse

__all__ = ["ExperimentDesign", "AdaptationDesign", "ScenarioModel",
           "StreamInsight", "ResultCache", "run_cells", "estimated_cost",
           "cache_key", "CACHE_SCHEMA_VERSION", "PARALLEL_COST_THRESHOLD"]

# One constant, bumped once per on-disk schema change (v2: adaptation
# cells; v3: fault ledger; v5: federation member ledger + tick-error ring;
# v6: what-if plan summaries).  Every cache key derives from it through
# ``cache_key`` below — bumping it invalidates the whole memo at once.
CACHE_SCHEMA_VERSION = 6


@dataclass
class ExperimentDesign:
    """Cartesian experiment grid (the paper's control variables).

    ``batch_max`` and ``policy`` accept either a scalar (one level, the
    seed behaviour) or a list of levels — first-class grid axes, so e.g.
    the three model-sharing policies become directly comparable in one
    design.
    """

    machines: list = field(default_factory=lambda: ["serverless", "wrangler"])
    partitions: list = field(default_factory=lambda: [1, 2, 4, 8, 12, 16])
    points: list = field(default_factory=lambda: [16000])       # MS
    centroids: list = field(default_factory=lambda: [1024])     # WC
    memory_mb: list = field(default_factory=lambda: [3008])
    n_messages: int = 80
    seed: int = 0
    policy: str | list | None = None
    batch_max: int | list = 1

    @staticmethod
    def _levels(axis) -> list:
        return list(axis) if isinstance(axis, (list, tuple)) else [axis]

    def experiments(self) -> list[StreamExperiment]:
        out = []
        for m, n, p, c, mem, pol, bm in itertools.product(
                self.machines, self.partitions, self.points, self.centroids,
                self.memory_mb, self._levels(self.policy),
                self._levels(self.batch_max)):
            out.append(StreamExperiment(
                machine=m, partitions=n, points=p, centroids=c, memory_mb=mem,
                n_messages=self.n_messages, seed=self.seed, policy=pol,
                batch_max=bm))
        return out


@dataclass
class AdaptationDesign:
    """Grid of closed-loop adaptation cells (the EILC design space).

    The cartesian axes are machine × scaling policy × rate trace; the
    workload/SLO knobs are shared.  ``experiments(usl_params=...)`` fills
    each machine's fitted USL coefficients into the predictive cells —
    ``StreamInsight.run_adaptation`` does that automatically from the
    models it fitted on the characterization sweep (characterize → model →
    adapt, end to end).
    """

    machines: list = field(default_factory=lambda: ["serverless", "wrangler"])
    scaling_policies: list = field(
        default_factory=lambda: ["usl", "reactive", "static"])
    rates: list = field(default_factory=lambda: [
        dict(kind="step", base_hz=2.0, high_hz=12.0, t_step=40.0)])
    horizon_s: float = 120.0
    initial_partitions: int = 2
    max_partitions: int = 16
    static_partitions: int | None = None
    control_interval_s: float = 2.0
    slo_lag: int = 32
    migration_s_per_delta: float = 0.05
    points: int = 8000
    centroids: int = 1024
    memory_mb: int = 3008
    policy: str | None = None      # model-sharing consistency
    batch_max: int = 1
    seed: int = 0
    engine: str = "sim"            # sim | threaded (wall clock)
    drift_t_s: float | None = None  # mid-run per-message cost shift ...
    drift_factor: float = 1.0       # ... by this multiplier
    refit_interval_s: float = 10.0  # usl_online knobs (see miniapp)
    refit_window: int = 128
    refit_half_life_s: float = 45.0
    threaded_service_s: float | None = None
    faults: dict | None = None      # FaultPlan spec — failure-semantics axis
    max_retries: int = 2            # retry budget before poisoning a batch
    retry_backoff_s: float = 0.0    # exponential-backoff base (0 = immediate)

    def experiments(self, usl_params: dict | None = None) -> list[AdaptationExperiment]:
        """``usl_params``: machine → (sigma, kappa, gamma) for the
        predictive cells, both frozen (``"usl"``) and online re-fitting
        (``"usl_online"``) (other policies ignore it)."""
        usl_params = usl_params or {}
        out = []
        for m, sp, rate in itertools.product(self.machines,
                                             self.scaling_policies, self.rates):
            sigma = kappa = gamma = None
            if sp in ("usl", "usl_online"):
                if m not in usl_params:
                    raise ValueError(
                        f"no USL params for machine {m!r}: run a "
                        "characterization sweep first (or pass usl_params)")
                sigma, kappa, gamma = usl_params[m]
            out.append(AdaptationExperiment(
                machine=m, scaling_policy=sp, rate=dict(rate),
                horizon_s=self.horizon_s,
                initial_partitions=self.initial_partitions,
                max_partitions=self.max_partitions,
                static_partitions=self.static_partitions,
                usl_sigma=sigma, usl_kappa=kappa, usl_gamma=gamma,
                control_interval_s=self.control_interval_s,
                slo_lag=self.slo_lag,
                migration_s_per_delta=self.migration_s_per_delta,
                points=self.points, centroids=self.centroids,
                memory_mb=self.memory_mb, policy=self.policy,
                batch_max=self.batch_max, seed=self.seed,
                engine=self.engine,
                drift_t_s=self.drift_t_s, drift_factor=self.drift_factor,
                refit_interval_s=self.refit_interval_s,
                refit_window=self.refit_window,
                refit_half_life_s=self.refit_half_life_s,
                threaded_service_s=self.threaded_service_s,
                faults=dict(self.faults) if self.faults else None,
                max_retries=self.max_retries,
                retry_backoff_s=self.retry_backoff_s))
        return out


# -- cell execution: cache + process pool -------------------------------------

_RESULT_FIELDS = ("run_id", "throughput", "latency_px", "latency_br",
                  "runtime_summary", "processed", "failed", "retried",
                  "wall_virtual_s", "des_events")

_ADAPT_RESULT_FIELDS = ("run_id", "slo_violations", "ticks", "cost_integral",
                        "scale_events", "produced", "processed", "throughput",
                        "latency_px", "alloc_trace", "lag_trace",
                        "final_allocation", "drained", "drain_s",
                        "wall_virtual_s", "des_events", "refits",
                        "abandoned", "dup_delivered", "faults_injected",
                        "preemptions", "fault_windows", "lost",
                        "tick_error_log", "member_ledger")

# summary cells: everything AdaptationSummary carries except the plan
# itself (reconstructed from the cache doc's experiment payload)
_PLAN_SUMMARY_FIELDS = ("slo_violations", "ticks", "cost_integral",
                        "scale_events", "produced", "processed", "throughput",
                        "latency_px", "final_allocation", "drained",
                        "drain_s", "refits", "abandoned", "dup_delivered",
                        "faults_injected", "preemptions", "fault_windows",
                        "lost", "member_ledger", "fast_path",
                        "fallback_reason")

# cell-type registry: run_cells / ResultCache dispatch on the experiment
# dataclass, so characterization, adaptation and what-if plan cells share
# the runner, pool, and on-disk memo.
# name -> (experiment cls, result cls, fields, fn)
_CELL_TYPES = {
    "StreamExperiment": (StreamExperiment, ExperimentResult,
                         _RESULT_FIELDS, run_experiment),
    "AdaptationExperiment": (AdaptationExperiment, AdaptationResult,
                             _ADAPT_RESULT_FIELDS, run_adaptation),
    "AdaptationPlan": (AdaptationPlan, AdaptationSummary,
                       _PLAN_SUMMARY_FIELDS, run_plan),
}


def _execute(exp, registry: MetricRegistry):
    """Run one cell of whichever registered type."""
    return _CELL_TYPES[type(exp).__name__][3](exp, registry)


def cache_key(exp) -> str:
    """The one key-derivation path for every cell type: cell type + all
    experiment fields, stable-JSON-hashed under ``CACHE_SCHEMA_VERSION``.

    ``AdaptationPlan.fast`` is an execution hint (the fast replay is
    bit-identical to the scalar DES), so it is left out: a plan's summary is
    the same value however it was computed, and the what-if dedupe in
    ``core.whatif`` keys on this too."""
    payload_dict = dataclasses.asdict(exp)
    if type(exp).__name__ == "AdaptationPlan":
        payload_dict.pop("fast", None)
    payload = json.dumps(payload_dict, sort_keys=True, default=repr)
    digest = hashlib.sha256(
        f"v{CACHE_SCHEMA_VERSION}:{type(exp).__name__}:{payload}".encode())
    return digest.hexdigest()[:24]


class ResultCache:
    """On-disk memo of experiment results keyed by the experiment dataclass
    (cell type + all fields, stable-JSON-hashed), so re-running a sweep only
    pays for cells whose parameters changed.  Holds characterization
    (``ExperimentResult``), adaptation (``AdaptationResult``) and what-if
    plan (``AdaptationSummary``) cells."""

    def __init__(self, root: str | Path) -> None:
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)

    key = staticmethod(cache_key)

    def path(self, exp) -> Path:
        return self.root / f"{self.key(exp)}.json"

    def get(self, exp):
        path = self.path(exp)
        if not path.exists():
            return None
        try:
            doc = json.loads(path.read_text())
            exp_cls, res_cls, fields, _fn = _CELL_TYPES[
                doc.get("cell_type", "StreamExperiment")]
            return res_cls(experiment=exp_cls(**doc["experiment"]),
                           **{k: doc[k] for k in fields})
        except (KeyError, TypeError, ValueError, json.JSONDecodeError):
            return None          # stale/corrupt entry: fall through to a run

    def _tmp_path(self, exp) -> Path:
        """Writer-unique staging file: two processes (or threads) sharing a
        cache dir must never clobber each other's in-flight tmp before the
        atomic ``replace``."""
        final = self.path(exp)
        return final.with_name(
            f"{final.name}.{os.getpid()}-{threading.get_ident()}.tmp")

    def put(self, exp, res) -> None:
        cell_type = type(exp).__name__
        fields = _CELL_TYPES[cell_type][2]
        doc = {"cell_type": cell_type,
               "experiment": dataclasses.asdict(res.experiment)}
        doc.update({k: getattr(res, k) for k in fields})
        try:
            payload = json.dumps(doc)
        except TypeError:
            return   # non-JSON experiment (e.g. exotic backend_attrs): a
            #          memo that can't round-trip is skipped, never fatal
        tmp = self._tmp_path(exp)
        tmp.write_text(payload)
        tmp.replace(self.path(exp))


def _run_cell_chunk(exps: list) -> list[tuple]:
    """Pool worker: a contiguous chunk of cells, one private registry per
    cell (results are self-contained); each cell also ships back its
    compact trace summary for the caller's registry."""
    out = []
    for exp in exps:
        registry = MetricRegistry()
        res = _execute(exp, registry)
        out.append((res, registry.export_summary()))
    return out


def _mp_context():
    """Never fork a parent that may hold torch's threads or a CUDA context
    (neither survives a fork); forkserver forks workers from a clean helper
    process, spawn is the portable fallback.  Workers re-import this module,
    and with it ``torch``, but never touch CUDA: cells run on the virtual
    clock."""
    try:
        return multiprocessing.get_context("forkserver")
    except ValueError:
        return multiprocessing.get_context("spawn")


# -- persistent worker pool ---------------------------------------------------
#
# Pool startup costs more than an entire light sweep (a per-sweep pool is
# many times slower than serial on cheap grids).  The pool is created
# lazily on the first sweep heavy enough to want it and reused for the life
# of the process, like Pilot-Streaming's warm resource containers.
#
# One live thread owns the pool: the first to run a pooled sweep claims it
# with an atomic ``dict.setdefault``, and only that thread creates, replaces
# or resets it, so the pool state has a single writer and no lock.  Once
# the owner has ended, the next thread to run a pooled sweep takes the pool
# over by claiming the next generation, again by ``setdefault``: of threads
# that race for it, exactly one wins.  ``_pool_owner[n]`` is the
# ``threading.Thread`` of the n-th owner; generations are only ever added,
# so the latest is the owner.  Owners are told apart by their ``Thread``:
# an ident may be reused by a thread started after the owner has ended.

_pool: concurrent.futures.ProcessPoolExecutor | None = None
_pool_workers = 0
_pool_owner: dict[int, threading.Thread] = {}

# Auto-switch threshold on the summed cell cost estimate
# (n_messages × points × centroids).  Calibrated on the 2-core reference
# container: the perf-smoke sweep (~6e10) runs in ~0.1 s serially — far
# below pool IPC break-even — while grids an order of magnitude heavier
# amortize the warm pool.
PARALLEL_COST_THRESHOLD = 2e11


def estimated_cost(experiments: list) -> float:
    """Work estimate driving the serial-vs-pooled auto-switch.  Adaptation
    cells expose ``cost_estimate()`` (expected messages from the rate-trace
    integral × per-message work); characterization cells use the historical
    ``n_messages × points × centroids``."""
    total = 0.0
    for e in experiments:
        est = getattr(e, "cost_estimate", None)
        total += est() if est is not None else e.n_messages * e.points * e.centroids
    return float(total)


def _pool_generation() -> tuple[int, threading.Thread | None]:
    """(generation, ``Thread``) of the pool's owner; (-1, None) if it has
    none."""
    n = -1
    while n + 1 in _pool_owner:
        n += 1
    return n, _pool_owner.get(n)


def _claim_pool() -> None:
    """Make the calling thread the pool's owner if it has none, or raise if
    another thread is."""
    me = threading.current_thread()
    _n, owner = _pool_generation()
    if owner is None:
        _pool_owner.setdefault(0, me)
        _n, owner = _pool_generation()
    if owner is not me:
        raise RuntimeError(
            "the persistent process pool belongs to the thread that first "
            "ran a pooled sweep; run pooled sweeps from that thread, or pass "
            "parallel=False")


def _take_over_pool() -> None:
    """While the pool's owner has ended, claim the next generation for the
    calling thread.  A thread that loses the race reads the winner as the
    owner: it tries the generation after only if the winner has ended too,
    and else ``_claim_pool`` refuses it."""
    me = threading.current_thread()
    n, owner = _pool_generation()
    while owner is not None and owner is not me and not owner.is_alive():
        _pool_owner.setdefault(n + 1, me)
        n, owner = _pool_generation()


def _get_pool(workers: int) -> concurrent.futures.ProcessPoolExecutor:
    global _pool, _pool_workers
    _take_over_pool()
    _claim_pool()
    if _pool is None or _pool_workers < workers:
        if _pool is not None:
            _pool.shutdown(wait=False, cancel_futures=True)
        _pool = concurrent.futures.ProcessPoolExecutor(
            max_workers=workers, mp_context=_mp_context())
        _pool_workers = workers
    return _pool


def _reset_pool() -> None:
    global _pool, _pool_workers
    if _pool is not None:
        _pool.shutdown(wait=False, cancel_futures=True)
    _pool = None
    _pool_workers = 0


atexit.register(_reset_pool)


def _use_pool(parallel, pending: list[tuple[int, StreamExperiment]]) -> bool:
    if parallel is False or len(pending) < 2:
        return False
    if parallel == "force":
        return True
    # True and "auto" both auto-switch: pooling a cheap grid would be a
    # pessimization, never a win
    return estimated_cost([exp for _i, exp in pending]) >= PARALLEL_COST_THRESHOLD


def run_cells(experiments: list, *,
              metrics: MetricRegistry | None = None,
              parallel: bool | str = "auto",
              max_workers: int | None = None,
              cache: ResultCache | str | Path | None = None,
              on_result=None) -> list[ExperimentResult]:
    """Execute experiment cells via the persistent pool and/or cache.

    ``parallel``: ``"auto"`` (default) and ``True`` pick serial or pooled
    execution from the grid's estimated work; ``"force"`` always pools;
    ``False`` never does.  Results are returned in input order regardless
    of completion order, and are bit-identical between serial and parallel
    execution (each cell's DES is seeded from its own dataclass).
    ``on_result(exp, res)`` is invoked as each cell lands (live progress;
    in pooled mode that is completion order, not input order).  When
    ``metrics`` is given, serial runs trace into it directly and pooled
    runs merge back compact per-cell event summaries
    (``metrics.trace_summary(run_id)``).
    """
    if isinstance(cache, (str, Path)):
        cache = ResultCache(cache)
    notify = on_result or (lambda exp, res: None)
    results: dict[int, ExperimentResult] = {}
    pending: list[tuple[int, Any]] = []
    for i, exp in enumerate(experiments):
        hit = cache.get(exp) if cache is not None else None
        if hit is not None:
            results[i] = hit
            notify(exp, hit)
        else:
            pending.append((i, exp))
    if _use_pool(parallel, pending):
        workers = max_workers or min(len(pending), os.cpu_count() or 1)
        # chunked submission: several cells per task bounds IPC round-trips
        # while leaving enough tasks (~4 per worker) for load balancing
        chunk = max(1, len(pending) // (workers * 4))
        chunks = [pending[k:k + chunk] for k in range(0, len(pending), chunk)]
        for attempt in (1, 2):
            pool = _get_pool(workers)
            futures = {pool.submit(_run_cell_chunk, [exp for _i, exp in grp]): grp
                       for grp in chunks}
            try:
                for fut in concurrent.futures.as_completed(futures):
                    grp = futures[fut]
                    for (i, exp), (res, summary) in zip(grp, fut.result()):
                        results[i] = res
                        if metrics is not None:
                            metrics.merge_summary(summary)
                        notify(exp, res)
                break
            except concurrent.futures.process.BrokenProcessPool:
                # a worker died (OOM/kill): restart the pool once and retry
                # only the cells that never landed — completed cells keep
                # their results and are not re-notified; cells are pure so
                # re-running the missing ones is safe (this thread owns the
                # pool: _get_pool claimed it)
                _reset_pool()
                if attempt == 2:
                    raise
                done = set(results)
                chunks = [[(i, exp) for i, exp in grp if i not in done]
                          for grp in chunks]
                chunks = [grp for grp in chunks if grp]
    else:
        for i, exp in pending:
            results[i] = _execute(
                exp, metrics if metrics is not None else MetricRegistry())
            notify(exp, results[i])
    if cache is not None:
        for i, _exp in pending:
            cache.put(_exp, results[i])
    return [results[i] for i in range(len(experiments))]


@dataclass
class ScenarioModel:
    """USL model for one (machine, MS, WC, memory, policy, batch) scenario."""

    key: tuple
    fit: USLFit
    n: np.ndarray
    t: np.ndarray

    def __str__(self) -> str:
        m, p, c, mem, pol, bm = self.key
        return (f"{m:>10} pts={p:<6} c={c:<5} mem={mem:<5} "
                f"policy={str(pol):<16} b={bm:<3} -> {self.fit.summary()}")


class StreamInsight:
    """Run a design, fit USL per scenario, evaluate prediction quality.

    ``parallel`` is forwarded to ``run_cells`` (default ``"auto"``: heavy
    grids fan out over the persistent process pool, cheap ones run
    serially); ``cache_dir`` memoizes finished cells on disk (see
    ``ResultCache``).  Pooled sweeps merge compact per-cell trace
    summaries into ``self.metrics``.
    """

    def __init__(self, metrics: MetricRegistry | None = None,
                 cache_dir: str | Path | None = None,
                 max_workers: int | None = None) -> None:
        self.metrics = metrics or MetricRegistry()
        self.cache = ResultCache(cache_dir) if cache_dir is not None else None
        self.max_workers = max_workers
        self.results: list[ExperimentResult] = []
        self.adaptation_results: list[AdaptationResult] = []

    # -- execution -----------------------------------------------------------
    def run(self, design: ExperimentDesign, verbose: bool = False,
            parallel: bool | str = "auto") -> list[ExperimentResult]:
        exps = design.experiments()

        def progress(exp, res):
            print(f"  ran {exp.machine} N={exp.partitions} pts={exp.points} "
                  f"c={exp.centroids} mem={exp.memory_mb} "
                  f"policy={exp.effective_policy} b={exp.batch_max} "
                  f"-> T={res.throughput:.3f}", flush=True)

        batch = run_cells(exps, metrics=self.metrics, parallel=parallel,
                          max_workers=self.max_workers, cache=self.cache,
                          on_result=progress if verbose else None)
        self.results.extend(batch)
        return self.results

    def records(self) -> list[dict]:
        return [r.record() for r in self.results]

    # -- adaptation (EILC: characterize -> model -> adapt) --------------------
    def usl_params(self, *, points: int = 8000, centroids: int = 1024,
                   memory_mb: int = 3008, policy: str | None = None,
                   batch_max: int = 1, backend: str = "numpy",
                   device="cuda") -> dict:
        """Per-machine fitted (sigma, kappa, gamma) for the scenario
        matching the given workload knobs, from this insight's
        characterization results."""
        out = {}
        for m in self.fit_models(backend=backend, device=device):
            machine, p, c, mem, pol, bm = m.key
            eff = policy if policy is not None else default_consistency(machine)
            if (p, c, mem, bm) == (points, centroids, memory_mb, batch_max) \
                    and pol == eff:
                out[machine] = (m.fit.sigma, m.fit.kappa, m.fit.gamma)
        return out

    def run_adaptation(self, design: AdaptationDesign | list, *,
                       verbose: bool = False,
                       parallel: bool | str = "auto", backend: str = "numpy",
                       device="cuda") -> list[AdaptationResult]:
        """Execute adaptation cells (a design grid or an explicit list).

        For a design, predictive cells are parameterized automatically from
        the USL models fitted on this insight's characterization sweep —
        the full paper §V loop in two calls: ``run(design)`` then
        ``run_adaptation(adaptation_design)``.
        """
        if isinstance(design, AdaptationDesign):
            needs_usl = any(sp in ("usl", "usl_online")
                            for sp in design.scaling_policies)
            params = self.usl_params(
                points=design.points, centroids=design.centroids,
                memory_mb=design.memory_mb, policy=design.policy,
                batch_max=design.batch_max, backend=backend,
                device=device) if needs_usl else {}
            cells = design.experiments(usl_params=params)
        else:
            cells = list(design)

        def progress(exp, res):
            print(f"  ran {exp.machine} {exp.scaling_policy:>8} "
                  f"rate={exp.rate.get('kind')} -> "
                  f"viol={res.slo_violations}/{res.ticks} "
                  f"cost={res.cost_integral:.0f}", flush=True)

        batch = run_cells(cells, metrics=self.metrics, parallel=parallel,
                          max_workers=self.max_workers, cache=self.cache,
                          on_result=progress if verbose else None)
        self.adaptation_results.extend(batch)
        return batch

    def adaptation_records(self) -> list[dict]:
        return [r.record() for r in self.adaptation_results]

    # -- modeling --------------------------------------------------------------
    @staticmethod
    def scenario_key(rec: dict) -> tuple:
        return (rec["machine"], rec["points"], rec["centroids"],
                rec["memory_mb"], rec.get("policy"), rec.get("batch_max", 1))

    def _scenario_arrays(self, records: list[dict]) -> list[tuple]:
        """Sorted (key, n, t) triples, one per scenario group."""
        groups: dict[tuple, list[dict]] = {}
        for rec in records:
            groups.setdefault(self.scenario_key(rec), []).append(rec)
        out = []
        for key, recs in sorted(groups.items()):
            n = np.array([r["partitions"] for r in recs], dtype=np.float64)
            t = np.array([r["throughput"] for r in recs], dtype=np.float64)
            out.append((key, n, t))
        return out

    def fit_models(self, records: list[dict] | None = None, *,
                   bootstrap: int = 0, bootstrap_seed: int = 0,
                   backend: str = "numpy",
                   device="cuda") -> list[ScenarioModel]:
        """Fit one USL model per scenario — all scenarios in a single
        batched call (ragged groups are padded and masked).  ``bootstrap=B``
        adds percentile CIs for (sigma, kappa, peak_N) to every fit;
        ``backend="torch"`` fits on ``device``."""
        records = records if records is not None else self.records()
        keys, ns, ts = [], [], []
        for key, n, t in self._scenario_arrays(records):
            if len(np.unique(n)) < 2:
                continue
            keys.append(key)
            ns.append(n)
            ts.append(t)
        fits = fit_usl_ragged(ns, ts, bootstrap=bootstrap,
                              bootstrap_seed=bootstrap_seed, backend=backend,
                              device=device)
        return [ScenarioModel(key=k, fit=f, n=n, t=t)
                for k, f, n, t in zip(keys, fits, ns, ts)]

    # -- model evaluation (paper Fig 7) ----------------------------------------
    def evaluate(self, n_train_configs, records: list[dict] | None = None,
                 seed: int = 0, backend: str = "numpy", device="cuda"):
        """Train on ``n_train_configs`` partition levels per scenario, report
        RMSE of throughput predictions on the held-out levels.

        ``n_train_configs`` may be an int (returns one aggregate dict, the
        historical behaviour) or a sequence of ints (returns a list of
        aggregate dicts).  Either way every (training-set size × scenario)
        train split becomes one row of a single ``fit_usl_batch`` call —
        train membership is just a 0/1 weight row — so a full Fig-7 curve
        costs one vectorized fit instead of a double loop of scalar fits.
        Scenarios whose partition grid is too sparse for the requested
        training-set size are skipped, never fatal."""
        records = records if records is not None else self.records()
        multi = isinstance(n_train_configs, (list, tuple, np.ndarray))
        wanted = [int(x) for x in
                  (n_train_configs if multi else [n_train_configs])]
        scenarios = self._scenario_arrays(records)
        jobs = []      # (n_train, key, n, t, train_mask)
        for n_train in wanted:
            # a fresh generator per training-set size keeps the level choice
            # identical to the historical one-size-per-call behaviour
            rng = np.random.default_rng(seed)
            for key, n, t in scenarios:
                levels = np.unique(n)
                if len(levels) <= n_train or n_train < 2:
                    continue
                # anchor the design range (min AND max level), sample the middle
                middle = levels[(levels > levels.min()) & (levels < levels.max())]
                n_mid = max(n_train - 2, 0)
                if n_mid > len(middle):
                    # defensive: with unique levels the earlier size check
                    # already implies enough interior levels; this keeps a
                    # future anchor-selection change from turning a sparse
                    # grid into a rng.choice ValueError mid-sweep
                    continue
                chosen = (rng.choice(middle, size=n_mid, replace=False)
                          if n_mid else np.array([]))
                train_levels = np.concatenate(
                    [[levels.min(), levels.max()], chosen])
                jobs.append((n_train, key, n, t, np.isin(n, train_levels)))
        fits = []
        if jobs:
            width = max(job[2].size for job in jobs)
            n_mat = np.ones((len(jobs), width))
            t_mat = np.zeros((len(jobs), width))
            w_mat = np.zeros((len(jobs), width))
            for i, (_nt, _key, n, t, tr) in enumerate(jobs):
                n_mat[i, :n.size] = n
                t_mat[i, :t.size] = t
                w_mat[i, :n.size] = tr         # held-out levels: weight 0
            fits = fit_usl_batch(n_mat, t_mat, weights=w_mat, backend=backend,
                                 device=device)
        per_size: dict[int, dict] = {nt: {} for nt in wanted}
        for (n_train, key, n, t, tr), fit in zip(jobs, fits):
            pred = fit.predict(n[~tr])
            err = rmse(t[~tr], pred)
            per_size[n_train][key] = dict(
                rmse=err,
                rel_rmse=err / max(float(np.mean(t[~tr])), 1e-12),
                n_train=int(tr.sum()), n_test=int((~tr).sum()),
                sigma=fit.sigma, kappa=fit.kappa)
        aggs = []
        for n_train in wanted:
            per_scenario = per_size[n_train]
            aggs.append({
                "n_train_configs": n_train,
                "mean_rmse": float(np.mean(
                    [v["rmse"] for v in per_scenario.values()]))
                if per_scenario else float("nan"),
                "mean_rel_rmse": float(np.mean(
                    [v["rel_rmse"] for v in per_scenario.values()]))
                if per_scenario else float("nan"),
                "scenarios": per_scenario,
            })
        return aggs if multi else aggs[0]

    def report(self, *, bootstrap: int = 0, bootstrap_seed: int = 0,
               backend: str = "numpy", device="cuda") -> str:
        """Per-scenario model summaries; ``bootstrap=B`` appends percentile
        confidence intervals for (sigma, kappa, peak_N) to every line."""
        lines = ["StreamInsight scenario models (USL):"]
        for m in self.fit_models(bootstrap=bootstrap,
                                 bootstrap_seed=bootstrap_seed,
                                 backend=backend, device=device):
            lines.append("  " + str(m))
        return "\n".join(lines)
