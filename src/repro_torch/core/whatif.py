"""Fleet-scale what-if engine: tournaments over (scenario × policy × seed).

The paper's pitch (StreamInsight §IV-V) is that a fitted USL model plus
cheap simulation lets you *choose* configurations before paying for them;
Pilot-Streaming frames the same question at resource-manager scale.  This
module is that question made executable: a ``WhatIfDesign`` declares the
cross-product of rate scenarios × scaling policies (with hyper-parameter
grids) × fault plans × federation specs × seeds, and a ``Tournament``
answers it in one pass —

1. **expand** the design into ``AdaptationPlan`` cells (a run is a value:
   ``core.miniapp.run_plan`` is a pure plan → summary function);
2. **dedupe** shared cells by ``streaminsight.cache_key`` — a question-at-
   a-time runner re-simulates identical baseline cells once per comparison
   (see ``naive_question_cells``, which enumerates exactly that waste);
3. **execute** the unique cells through ``streaminsight.run_cells`` — the
   persistent process pool, the on-disk ``ResultCache`` and the serverless
   fast replay (``sim.batched``) all apply, and only compact summaries
   come back (no event traces across the pool boundary);
4. **reduce** to decision tables: a violations/cost Pareto frontier per
   scenario and per-policy win matrices with seed-level sign tests.

Non-qualifying cells (federation, threaded engine) are not a special
case: ``run_plan`` falls back to the scalar DES per cell, logs the reason,
and the tournament records it in ``TournamentResult.fallbacks`` — the
what-if surface is uniform even where the fast path is not.

Ports ``repro.core.whatif``; its rows, wins, sign tests, Pareto flags and
fallbacks equal the reference's bit for bit.
"""

from __future__ import annotations

import itertools
import math
from dataclasses import dataclass, field
from typing import Any

from repro_torch.core.miniapp import AdaptationExperiment, AdaptationPlan, \
    AdaptationSummary
from repro_torch.core.streaminsight import ResultCache, cache_key, run_cells

__all__ = ["WhatIfDesign", "Tournament", "TournamentResult", "sign_test",
           "pareto_frontier"]

# (scenario name, policy name, seed) — the coordinate a summary is filed
# under; distinct coordinates may share one simulated cell (the dedupe).
Coord = tuple[str, str, int]


@dataclass
class WhatIfDesign:
    """Declarative what-if grid over closed-loop adaptation cells.

    ``base`` holds the shared ``AdaptationExperiment`` fields (machine,
    USL coefficients, horizon, SLO ...).  Each ``scenarios`` entry is a
    named dict of experiment overrides — the rate program, drift knobs,
    a ``faults`` plan or a ``federation`` spec all ride here, which makes
    fault plans and federation member mixes first-class sweep axes.  Each
    ``policies`` entry is a scaling-policy spec: a bare name
    (``"reactive"``) or a dict with ``name``, ``scaling_policy`` and
    controller-knob overrides where any **list-valued** field expands into
    a hyper-parameter grid (one policy variant per combination, named
    ``base[knob=value,...]``).
    """

    base: dict = field(default_factory=dict)
    scenarios: list = field(default_factory=lambda: [dict(name="default")])
    policies: list = field(default_factory=lambda: ["usl", "reactive"])
    seeds: list = field(default_factory=lambda: [0])
    fast: bool = True          # execution hint for run_plan (never semantic)

    # -- expansion -----------------------------------------------------------
    def policy_variants(self) -> list[tuple[str, dict]]:
        """``(name, experiment-overrides)`` per policy, hypergrids expanded."""
        out: list[tuple[str, dict]] = []
        for entry in self.policies:
            if isinstance(entry, str):
                out.append((entry, {"scaling_policy": entry}))
                continue
            spec = dict(entry)
            name = spec.pop("name", spec.get("scaling_policy", "policy"))
            spec.setdefault("scaling_policy", name)
            grid_keys = sorted(k for k, v in spec.items()
                               if isinstance(v, (list, tuple)))
            if not grid_keys:
                out.append((name, spec))
                continue
            levels = [spec[k] for k in grid_keys]
            for combo in itertools.product(*levels):
                variant = dict(spec)
                variant.update(dict(zip(grid_keys, combo)))
                tag = ",".join(f"{k}={v:g}" if isinstance(v, float)
                               else f"{k}={v}"
                               for k, v in zip(grid_keys, combo))
                out.append((f"{name}[{tag}]", variant))
        return out

    def scenario_specs(self) -> list[tuple[str, dict]]:
        out = []
        for i, sc in enumerate(self.scenarios):
            spec = dict(sc)
            out.append((str(spec.pop("name", f"scenario{i}")), spec))
        return out

    def plans(self) -> list[tuple[Coord, AdaptationPlan]]:
        """The full cross-product, one ``AdaptationPlan`` per coordinate.
        Override precedence: base < scenario < policy < seed."""
        out: list[tuple[Coord, AdaptationPlan]] = []
        for (sc_name, sc), (pol_name, pol), seed in itertools.product(
                self.scenario_specs(), self.policy_variants(), self.seeds):
            fields: dict[str, Any] = dict(self.base)
            fields.update(sc)
            fields.update(pol)
            fields["seed"] = seed
            exp = AdaptationExperiment(**fields)
            out.append(((sc_name, pol_name, seed),
                        AdaptationPlan(experiment=exp, fast=self.fast)))
        return out

    def naive_question_cells(self) -> list[tuple[str, list[Coord]]]:
        """The per-question cell lists a question-at-a-time runner
        simulates: one block per claim the tournament answers (violations,
        cost, refit activity, drain, one Pareto per scenario, one win-
        matrix entry per ordered policy pair), each independently
        re-running every cell it reads: the execution shape of answering
        each comparison with its own ``run_adaptation`` loop, which the
        dedupe is measured against."""
        coords = [c for c, _p in self.plans()]
        pol_names = [n for n, _s in self.policy_variants()]
        online = [c for c in coords
                  if "usl_online" in c[1]]
        blocks: list[tuple[str, list[Coord]]] = [
            ("violations", list(coords)),
            ("cost", list(coords)),
            ("refit-activity", online),
            ("drain", list(coords)),
        ]
        for sc_name, _sc in self.scenario_specs():
            blocks.append((f"pareto:{sc_name}",
                           [c for c in coords if c[0] == sc_name]))
        for a, b in itertools.permutations(pol_names, 2):
            blocks.append((f"win:{a}>{b}",
                           [c for c in coords if c[1] in (a, b)]))
        return blocks


# -- reducers -----------------------------------------------------------------

def sign_test(wins: int, losses: int) -> float:
    """Two-sided exact binomial sign test p-value (ties excluded): the
    probability, under H0 "neither policy is better", of a split at least
    this lopsided.  Pure ``math.comb`` — no scipy in the image."""
    n = wins + losses
    if n == 0:
        return 1.0
    k = min(wins, losses)
    tail = sum(math.comb(n, j) for j in range(k + 1)) / 2.0 ** n
    return min(1.0, 2.0 * tail)


def pareto_frontier(points: list[tuple[float, float]]) -> list[bool]:
    """Non-domination flags for (violations, cost) points — smaller is
    better on both axes; a point is on the frontier iff no other point is
    ≤ on both and < on at least one."""
    flags = []
    for i, (vi, ci) in enumerate(points):
        dominated = any(
            (vj <= vi and cj <= ci) and (vj < vi or cj < ci)
            for j, (vj, cj) in enumerate(points) if j != i)
        flags.append(not dominated)
    return flags


@dataclass
class TournamentResult:
    """Everything a tournament learned, summary-sized.

    ``summaries`` is coordinate → ``AdaptationSummary`` (distinct
    coordinates may share one object — that IS the dedupe).  ``pareto``
    maps scenario → per-policy rows (seed-mean violations/cost +
    ``frontier`` flag); ``wins[(a, b)]`` counts a-beats-b across every
    (scenario, seed) cell pair — fewer SLO violations wins, cost breaks
    ties — with the sign-test p-value."""

    summaries: dict
    total_cells: int
    unique_cells: int
    fast_cells: int
    fallbacks: dict
    pareto: dict
    wins: dict

    def summary_rows(self) -> list[dict]:
        """Flat records (one per coordinate) for tables/JSON."""
        rows = []
        for (sc, pol, seed), s in sorted(self.summaries.items()):
            row = s.record()
            row.update(scenario=sc, policy_name=pol, seed=seed)
            rows.append(row)
        return rows


class Tournament:
    """Expand → dedupe → execute → reduce, one invocation.

    ``parallel``/``max_workers``/``cache`` pass through to
    ``streaminsight.run_cells`` (the persistent pool and on-disk memo);
    ``cache`` additionally makes repeated tournaments incremental across
    processes.  Plans are simulated **once per unique cell** however many
    comparisons read them.
    """

    def __init__(self, design: WhatIfDesign, *,
                 parallel: bool | str = "auto",
                 max_workers: int | None = None,
                 cache: ResultCache | str | None = None) -> None:
        self.design = design
        self.parallel = parallel
        self.max_workers = max_workers
        self.cache = cache

    def run(self) -> TournamentResult:
        coords_plans = self.design.plans()
        order: list[str] = []                 # first-seen unique keys
        unique: dict[str, AdaptationPlan] = {}
        fanout: dict[str, list[Coord]] = {}
        for coord, plan in coords_plans:
            key = cache_key(plan)
            if key not in unique:
                unique[key] = plan
                order.append(key)
            fanout[key] = fanout.get(key, []) + [coord]
        results = run_cells([unique[k] for k in order],
                            parallel=self.parallel,
                            max_workers=self.max_workers, cache=self.cache)
        summaries: dict[Coord, AdaptationSummary] = {}
        fallbacks: dict[Coord, str] = {}
        fast_cells = 0
        for key, summary in zip(order, results):
            if summary.fast_path:
                fast_cells += 1
            for coord in fanout[key]:
                summaries[coord] = summary
                if summary.fallback_reason is not None:
                    fallbacks[coord] = summary.fallback_reason
        return TournamentResult(
            summaries=summaries,
            total_cells=len(coords_plans),
            unique_cells=len(unique),
            fast_cells=fast_cells,
            fallbacks=fallbacks,
            pareto=self._pareto(summaries),
            wins=self._wins(summaries))

    # -- reducers ------------------------------------------------------------
    def _pareto(self, summaries: dict) -> dict:
        """Per-scenario policy rows with non-domination flags.

        Distinct policy names whose plans deduped to the *same* physical
        cells (``summaries`` maps their coordinates to the same summary
        objects) would produce coordinate-identical rows — and
        ``pareto_frontier`` flags exact duplicates as mutually
        non-dominated, so one simulated cell could occupy two frontier
        slots under two names.  Such rows are annotated
        ``duplicate_of: <representative policy>`` and excluded from the
        frontier computation; they inherit the representative's flag."""
        out: dict[str, list[dict]] = {}
        for sc_name, _sc in self.design.scenario_specs():
            rows = []
            seen: dict[tuple, str] = {}   # cell identity -> first policy name
            for pol_name, _spec in self.design.policy_variants():
                cells = [summaries[(sc_name, pol_name, s)]
                         for s in self.design.seeds
                         if (sc_name, pol_name, s) in summaries]
                if not cells:
                    continue
                row = {
                    "policy": pol_name,
                    "mean_violations":
                        sum(c.slo_violations for c in cells) / len(cells),
                    "mean_cost":
                        sum(c.cost_integral for c in cells) / len(cells),
                    "seeds": len(cells),
                }
                ident = tuple(id(c) for c in cells)
                rep = seen.get(ident)
                if rep is not None:
                    row["duplicate_of"] = rep
                else:
                    seen[ident] = pol_name
                rows.append(row)
            originals = [r for r in rows if "duplicate_of" not in r]
            flags = pareto_frontier(
                [(r["mean_violations"], r["mean_cost"]) for r in originals])
            rep_frontier = {}
            for r, on_frontier in zip(originals, flags):
                r["frontier"] = on_frontier
                rep_frontier[r["policy"]] = on_frontier
            for r in rows:
                if "duplicate_of" in r:
                    r["frontier"] = rep_frontier[r["duplicate_of"]]
            out[sc_name] = rows
        return out

    def _wins(self, summaries: dict) -> dict:
        pol_names = [n for n, _s in self.design.policy_variants()]
        sc_names = [n for n, _s in self.design.scenario_specs()]
        out: dict[tuple[str, str], dict] = {}
        for a, b in itertools.permutations(pol_names, 2):
            wins = losses = ties = 0
            for sc in sc_names:
                for seed in self.design.seeds:
                    sa = summaries.get((sc, a, seed))
                    sb = summaries.get((sc, b, seed))
                    if sa is None or sb is None:
                        continue
                    ka = (sa.slo_violations, sa.cost_integral)
                    kb = (sb.slo_violations, sb.cost_integral)
                    if ka < kb:
                        wins += 1
                    elif ka > kb:
                        losses += 1
                    else:
                        ties += 1
            out[(a, b)] = {"wins": wins, "losses": losses, "ties": ties,
                           "p_value": sign_test(wins, losses)}
        return out
