"""The port's what-if engine against the JAX package's.

On ``tests/test_whatif.py``'s designs a ``Tournament`` of the port gives the
reference's rows, dedupe counts, wins, sign tests and Pareto flags bit for
bit, with equal fallbacks; design expansion, cache keys and the reducers
agree on explicit examples, and plan summaries survive the result cache.
"""

import pytest

from repro.core import whatif as ref
from repro.core.streaminsight import cache_key as ref_cache_key
from repro_torch.core import whatif as port
from repro_torch.core.miniapp import AdaptationPlan
from repro_torch.core.streaminsight import ResultCache, cache_key, run_cells

# a cheap qualifying serverless drift cell (tests/test_whatif.py's)
BASE = dict(
    machine="serverless", usl_sigma=0.0, usl_kappa=3.0e-4, usl_gamma=1.94,
    horizon_s=60.0, max_partitions=8, slo_lag=32, control_interval_s=2.0,
    stabilization_s=0.0, scale_down_hysteresis=0.08, headroom=0.0,
    catchup_horizon_s=8.0, refit_interval_s=5.0, max_step_up=2,
    rate=dict(kind="step", base_hz=2.0, high_hz=8.0, t_step=15.0, t_end=45.0))
DRIFT = dict(name="drift", drift_t_s=20.0, drift_factor=1.8, refit_half_life_s=25.0)
FED = dict(name="fed", machine="federated", policy="update_locked",
           federation=dict(members=[dict(name="aws", machine="serverless", price=1.0),
                                    dict(name="wr", machine="wrangler", price=0.6,
                                         grant_latency_s=10.0)]),
           faults=dict(events=[dict(t=30.0, kind="backend_outage", target=0,
                                    duration_s=10.0)]),
           max_retries=8, retry_backoff_s=0.1, initial_partitions=2)
WALLTIME = dict(name="walltime", points=60000, backend_attrs=dict(flops_per_vcpu=6e6))


def _designs():
    """(name, keyword arguments of WhatIfDesign): test_whatif.py's designs,
    and two whose cells fall back to the scalar DES (a federation with an
    outage, and a cell whose invocation outlives the walltime)."""
    return {
        "two-seeds": dict(base=dict(BASE), scenarios=[dict(DRIFT)],
                          policies=["usl", "usl_online"], seeds=[0, 1]),
        "dedupe": dict(base=dict(BASE), scenarios=[dict(DRIFT), dict(DRIFT, name="drift-again")],
                       policies=["usl", "usl_online"], seeds=[0, 1]),
        "duplicate-policy": dict(base=dict(BASE), scenarios=[dict(DRIFT)],
                                 policies=["usl", dict(name="usl-again", scaling_policy="usl"),
                                           "usl_online"], seeds=[0, 1]),
        "hypergrid": dict(base=dict(BASE), scenarios=[dict(DRIFT), dict(name="calm")],
                          policies=[dict(name="usl", headroom=[0.0, 0.1], max_step_up=[1, 2]),
                                    "reactive", "static"], seeds=[2]),
        "fallbacks": dict(base=dict(BASE), scenarios=[dict(FED), dict(WALLTIME), dict(DRIFT)],
                          policies=["usl", "reactive"], seeds=[0]),
    }


def _same(a, b) -> bool:
    if isinstance(a, float) and isinstance(b, float) and a != a and b != b:
        return True
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b


@pytest.mark.parametrize("name", list(_designs()))
def test_tournament_equals_reference(name):
    kw = _designs()[name]
    got = port.Tournament(port.WhatIfDesign(**kw), parallel=False).run()
    want = ref.Tournament(ref.WhatIfDesign(**kw), parallel=False).run()
    assert (got.total_cells, got.unique_cells, got.fast_cells) == \
        (want.total_cells, want.unique_cells, want.fast_cells)
    assert got.fallbacks == want.fallbacks
    assert _same(got.summary_rows(), want.summary_rows())
    assert _same(got.pareto, want.pareto)
    assert got.wins == want.wins
    for coord, s in got.summaries.items():
        w = want.summaries[coord]
        assert s.member_ledger == w.member_ledger
        assert (s.fast_path, s.fallback_reason) == (w.fast_path, w.fallback_reason)
    # the dedupe: coordinates that share a cell share one summary object
    shared = {id(s) for s in got.summaries.values()}
    assert len(shared) == got.unique_cells
    if name == "fallbacks":
        assert got.fast_cells == 2 and len(got.fallbacks) == 4
        assert {c[0] for c in got.fallbacks} == {"fed", "walltime"}


@pytest.mark.parametrize("name", list(_designs()))
def test_expansion_and_cache_keys_equal_reference(name):
    kw = _designs()[name]
    got, want = port.WhatIfDesign(**kw), ref.WhatIfDesign(**kw)
    assert got.policy_variants() == want.policy_variants()
    assert got.scenario_specs() == want.scenario_specs()
    assert got.naive_question_cells() == want.naive_question_cells()
    plans, ref_plans = got.plans(), want.plans()
    assert [c for c, _p in plans] == [c for c, _p in ref_plans]
    assert [cache_key(p) for _c, p in plans] == [ref_cache_key(p) for _c, p in ref_plans]
    got.fast = False
    assert [cache_key(p) for _c, p in got.plans()] == [cache_key(p) for _c, p in plans]


@pytest.mark.parametrize("wins,losses", [(0, 0), (2, 2), (8, 0), (0, 8), (5, 1), (1, 1),
                                         (12, 3), (7, 7), (20, 1), (0, 1)])
def test_sign_test_equals_reference(wins, losses):
    assert port.sign_test(wins, losses) == ref.sign_test(wins, losses)


@pytest.mark.parametrize("points", [
    [], [(1.0, 1.0), (1.0, 1.0)], [(0.0, 10.0), (1.0, 11.0), (2.0, 1.0), (2.0, 2.0)],
    [(3.0, 5.5), (2.0, 7.0), (3.0, 5.0), (0.0, 9.0), (4.0, 4.0), (0.0, 9.5)]])
def test_pareto_frontier_equals_reference(points):
    assert port.pareto_frontier(points) == ref.pareto_frontier(points)


def test_plan_summaries_round_trip_the_result_cache(tmp_path):
    kw = _designs()["fallbacks"]
    plans = [p for _c, p in port.WhatIfDesign(**kw).plans()]
    cache = ResultCache(tmp_path)
    first = run_cells(plans, parallel=False, cache=cache)
    again = run_cells([AdaptationPlan(experiment=p.experiment, fast=False) for p in plans],
                      parallel=False, cache=cache)
    for a, b in zip(first, again):
        assert type(b).__name__ == "AdaptationSummary"
        assert _same(a.record(), b.record()) and a.member_ledger == b.member_ledger
        assert (a.fast_path, a.fallback_reason) == (b.fast_path, b.fallback_reason)
