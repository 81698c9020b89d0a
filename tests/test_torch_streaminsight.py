"""The port's StreamInsight against the JAX package's: the characterization
sweeps of ``launch/characterize.py`` (cut to fewer partitions and messages),
their records, fits, Fig-7 evaluations and reports equal bit for bit on the
numpy backend; serial and pooled sweeps bit-identical; the cache
round-trips; and the launch flow's torch fits (on the CPU) within the
stated tolerance of the reference's numpy fits."""

import dataclasses
import sys
import threading

import numpy as np
import pytest

from repro.core import streaminsight as ref
from repro.core.autoscale import Autoscaler as RefScaler
from repro_torch.core import streaminsight as port
from repro_torch.core.autoscale import Autoscaler
from repro_torch.launch import characterize

from test_torch_usl import assert_fits_close

PARTS = [1, 2, 4, 8, 16]
DESIGNS = {
    "sweep": dict(machines=["serverless", "wrangler"], partitions=PARTS, points=[16000],
                  centroids=[1024], n_messages=20),
    "ablation": dict(machines=["wrangler"], partitions=PARTS, points=[16000],
                     centroids=[8192], n_messages=12,
                     policy=["full_fit_locked", "update_locked"]),
}


def _records_equal(a: list, b: list) -> bool:
    return len(a) == len(b) and all(
        x.keys() == y.keys() and all(
            x[k] == y[k] or (isinstance(x[k], float) and x[k] != x[k] and y[k] != y[k])
            for k in x)
        for x, y in zip(a, b))


def _fit_fields(models) -> list:
    return [(m.key, tuple(getattr(m.fit, f.name) for f in dataclasses.fields(m.fit)),
             m.n.tolist(), m.t.tolist()) for m in models]


def _pair(design):
    si_p, si_r = port.StreamInsight(), ref.StreamInsight()
    si_p.run(port.ExperimentDesign(**design), parallel=False)
    si_r.run(ref.ExperimentDesign(**design), parallel=False)
    return si_p, si_r


@pytest.mark.parametrize("name", list(DESIGNS))
def test_sweep_records_fits_evaluation_and_report_equal_reference(name):
    si_p, si_r = _pair(DESIGNS[name])
    assert _records_equal(si_p.records(), si_r.records())
    assert _fit_fields(si_p.fit_models()) == _fit_fields(si_r.fit_models())
    assert _fit_fields(si_p.fit_models(bootstrap=16, bootstrap_seed=2)) == \
        _fit_fields(si_r.fit_models(bootstrap=16, bootstrap_seed=2))
    # repr: every float round-trips, and a NaN mean equals a NaN mean
    assert repr(si_p.evaluate([2, 3, 4])) == repr(si_r.evaluate([2, 3, 4]))
    assert repr(si_p.evaluate(3, seed=5)) == repr(si_r.evaluate(3, seed=5))
    assert si_p.report() == si_r.report()
    assert si_p.report(bootstrap=32) == si_r.report(bootstrap=32)
    assert si_p.usl_params(points=16000) == si_r.usl_params(points=16000)


def test_torch_fits_of_the_sweep_match_reference_numpy():
    si_p, si_r = _pair(DESIGNS["sweep"])
    got = si_p.fit_models(bootstrap=64, backend="torch", device="cpu")
    want = si_r.fit_models(bootstrap=64)
    assert [m.key for m in got] == [m.key for m in want]
    assert_fits_close([m.fit for m in got], [m.fit for m in want], np.asarray(PARTS, float))
    for g, w in zip(si_p.evaluate([2, 3], backend="torch", device="cpu"),
                    si_r.evaluate([2, 3])):
        assert g["scenarios"].keys() == w["scenarios"].keys()
        for key, row in w["scenarios"].items():
            assert abs(g["scenarios"][key]["sigma"] - row["sigma"]) <= 1e-6
            assert abs(g["scenarios"][key]["kappa"] - row["kappa"]) <= 1e-7


def test_serial_and_pooled_sweeps_are_bit_identical():
    serial = port.StreamInsight()
    serial.run(port.ExperimentDesign(**DESIGNS["sweep"]), parallel=False)
    pooled = port.StreamInsight(max_workers=2)
    pooled.run(port.ExperimentDesign(**DESIGNS["sweep"]), parallel="force")
    assert _records_equal(serial.records(), pooled.records())
    assert [r.run_id for r in serial.results] != [] and \
        all(pooled.metrics.trace_summary(r.run_id) for r in pooled.results)
    # the pool has one owner: a pooled sweep from another thread raises
    errors = []

    def other():
        try:
            port.run_cells(port.ExperimentDesign(**DESIGNS["sweep"]).experiments()[:2],
                           parallel="force", max_workers=2)
        except RuntimeError as exc:
            errors.append(exc)

    t = threading.Thread(target=other)
    t.start()
    t.join(60.0)
    assert len(errors) == 1 and "belongs to the thread" in str(errors[0])


def test_one_thread_claims_the_pool_under_contention():
    """32 threads race to claim an unowned pool at a 1 us switch interval:
    exactly one wins, and every other one is refused."""
    saved = dict(port._pool_owner)
    port._pool_owner.clear()
    interval = sys.getswitchinterval()
    outcomes = []
    barrier = threading.Barrier(32)

    def claim():
        barrier.wait(30.0)
        try:
            port._claim_pool()
            outcomes.append(("owner", threading.get_ident()))
        except RuntimeError:
            outcomes.append(("refused", threading.get_ident()))

    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=claim) for _ in range(32)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(60.0)
        assert not any(w.is_alive() for w in workers)
        owners = [tid for kind, tid in outcomes if kind == "owner"]
        assert len(outcomes) == 32 and owners == [port._pool_generation()[1].ident]
    finally:
        sys.setswitchinterval(interval)
        port._pool_owner.clear()
        port._pool_owner.update(saved)


def test_an_ended_owner_hands_the_pool_over():
    """Three threads in turn, each joined before the next starts, run a
    pooled sweep: each takes the pool over from the one before it, and
    every pooled sweep equals the serial records.  Between two sweeps a
    thread that stays alive is started first, so it may take the ended
    owner's ident: that does not keep the pool from the next sweep."""
    serial = port.StreamInsight()
    serial.run(port.ExperimentDesign(**DESIGNS["sweep"]), parallel=False)
    saved = dict(port._pool_owner)
    port._pool_owner.clear()
    records, errors = [], []
    release = threading.Event()
    spacers = []

    def sweep():
        try:
            pooled = port.StreamInsight(max_workers=2)
            pooled.run(port.ExperimentDesign(**DESIGNS["sweep"]), parallel="force")
            records.append(pooled.records())
        except Exception as exc:  # noqa: BLE001 — reported by the asserts below
            errors.append(exc)

    try:
        for _ in range(3):
            t = threading.Thread(target=sweep)
            t.start()
            t.join(120.0)
            assert not t.is_alive()
            spacers.append(threading.Thread(target=release.wait, args=(120.0,)))
            spacers[-1].start()
        assert errors == [] and len(records) == 3
        assert all(_records_equal(serial.records(), got) for got in records)
    finally:
        release.set()
        for t in spacers:
            t.join(60.0)
        port._pool_owner.clear()
        port._pool_owner.update(saved)


def test_one_thread_takes_over_an_ended_owner_under_contention():
    """The owner has ended; 32 threads race to take the pool over at a 1 us
    switch interval, and each stays alive until all have tried: exactly
    one becomes the owner, and every other one is refused."""
    saved = dict(port._pool_owner)
    port._pool_owner.clear()
    ended = threading.Thread(target=port._claim_pool)
    ended.start()
    ended.join(60.0)
    interval = sys.getswitchinterval()
    outcomes = []
    tried = threading.Barrier(32)
    start = threading.Barrier(32)

    def take_over():
        start.wait(30.0)
        try:
            port._take_over_pool()
            port._claim_pool()
            outcomes.append(("owner", threading.get_ident()))
        except RuntimeError:
            outcomes.append(("refused", threading.get_ident()))
        tried.wait(30.0)

    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=take_over) for _ in range(32)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(60.0)
        assert not any(w.is_alive() for w in workers)
        owners = [tid for kind, tid in outcomes if kind == "owner"]
        assert len(outcomes) == 32 and owners == [port._pool_generation()[1].ident]
    finally:
        sys.setswitchinterval(interval)
        port._pool_owner.clear()
        port._pool_owner.update(saved)


def test_a_stale_take_over_tries_the_next_generation(monkeypatch):
    """A thread reads generation 0's owner as ended; before its claim of
    generation 1 lands, another thread claims generation 1, and ends too.
    The late thread still takes the pool over, at generation 2."""
    ended = [threading.Thread(target=lambda: None) for _ in range(2)]
    for t in ended:
        t.start()
        t.join(60.0)

    class RacedOwners(dict):
        def setdefault(self, key, default=None):
            if key == 1:
                super().setdefault(1, ended[1])     # the other thread wins first
            return super().setdefault(key, default)

    monkeypatch.setattr(port, "_pool_owner", RacedOwners({0: ended[0]}))
    outcomes = []

    def take_over():
        try:
            port._take_over_pool()
            port._claim_pool()
            outcomes.append("owner")
        except RuntimeError:
            outcomes.append("refused")

    late = threading.Thread(target=take_over)
    late.start()
    late.join(60.0)
    assert outcomes == ["owner"] and port._pool_generation() == (2, late)


def test_auto_switch_and_cost_estimate_equal_reference():
    exps_p = port.ExperimentDesign(**DESIGNS["sweep"]).experiments()
    exps_r = ref.ExperimentDesign(**DESIGNS["sweep"]).experiments()
    assert port.estimated_cost(exps_p) == ref.estimated_cost(exps_r)
    pend_p, pend_r = list(enumerate(exps_p)), list(enumerate(exps_r))
    for parallel in (False, True, "auto", "force"):
        assert port._use_pool(parallel, pend_p) == ref._use_pool(parallel, pend_r)
    assert port.PARALLEL_COST_THRESHOLD == ref.PARALLEL_COST_THRESHOLD
    assert port.CACHE_SCHEMA_VERSION == ref.CACHE_SCHEMA_VERSION
    assert [port.cache_key(e) for e in exps_p] == [ref.cache_key(e) for e in exps_r]


def test_adaptation_design_equals_reference():
    si_p, si_r = _pair(dict(DESIGNS["sweep"], points=[8000]))
    design = dict(scaling_policies=["usl", "reactive"], horizon_s=60.0)
    got = si_p.run_adaptation(port.AdaptationDesign(**design), parallel=False)
    want = si_r.run_adaptation(ref.AdaptationDesign(**design), parallel=False)
    assert _records_equal(si_p.adaptation_records(), si_r.adaptation_records())
    assert [r.alloc_trace for r in got] == [r.alloc_trace for r in want]
    with pytest.raises(ValueError):
        port.AdaptationDesign(machines=["stampede2"]).experiments(usl_params={})


def test_result_cache_round_trips_both_cell_types(tmp_path):
    cache = port.ResultCache(tmp_path)
    cells = port.ExperimentDesign(**DESIGNS["sweep"]).experiments()[:3] + \
        port.AdaptationDesign(scaling_policies=["reactive"], horizon_s=30.0).experiments()
    first = port.run_cells(cells, parallel=False, cache=cache)
    assert len(list(tmp_path.glob("*.json"))) == len(cells)
    landed = []
    again = port.run_cells(cells, parallel=False, cache=tmp_path,
                           on_result=lambda exp, res: landed.append(exp))
    assert landed == cells
    assert _records_equal([r.record() for r in again], [r.record() for r in first])
    for a, b in zip(again, first):
        assert type(a) is type(b) and a.run_id == b.run_id
        assert getattr(a, "alloc_trace", None) == getattr(b, "alloc_trace", None)
    assert cache.get(dataclasses.replace(cells[0], seed=99)) is None
    cache.path(cells[0]).write_text("{not json")
    assert cache.get(cells[0]) is None


def test_launch_flow_on_the_cpu_matches_reference(capsys):
    """``repro_torch.launch.characterize`` end to end at its full designs,
    fits on the CPU: the sweeps equal the reference's, the torch fits lie
    within the tolerance of the reference's numpy fits, and the
    recommendations agree."""
    si, si2 = characterize.characterize(device="cpu", parallel=False, verbose=False)
    out = capsys.readouterr().out
    assert "StreamInsight scenario models (USL):" in out and "update_locked" in out
    for got, design in ((si, characterize.sweep_design()),
                        (si2, characterize.ablation_design())):
        want = ref.StreamInsight()
        want.run(ref.ExperimentDesign(**dataclasses.asdict(design)), parallel=False)
        assert _records_equal(got.records(), want.records())
        fits = got.fit_models(backend="torch", device="cpu")
        ref_fits = want.fit_models()
        assert_fits_close([m.fit for m in fits], [m.fit for m in ref_fits],
                          np.asarray(characterize.PARTITIONS, float))
        assert [Autoscaler(m.fit).usable_peak_n() for m in fits] == \
            [RefScaler(m.fit).usable_peak_n() for m in ref_fits]
    assert characterize.main(["--device", "cpu"]) == 0
    assert capsys.readouterr().out.rstrip().endswith("characterize OK")
