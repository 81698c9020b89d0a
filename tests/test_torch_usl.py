"""The port's USL fitter against the JAX package's: the numpy path equal bit
for bit, the float64 torch fit (on the CPU here) within the stated
tolerance.  Inputs are made in numpy from a seed and handed to both."""

import dataclasses

import numpy as np
import pytest

from repro.core import usl as ref
from repro_torch.core import usl as port

NS = np.array([1, 2, 4, 8, 16, 32, 64], dtype=np.float64)
# the torch fit against the numpy fit: T(N) relative, sigma and kappa
# absolute, gamma relative; peak_N relative (a bootstrap CI bound)
TOL = dict(t_rtol=1e-6, sigma=1e-6, kappa=1e-7, gamma_rtol=1e-6, peak_rtol=1e-6)


def _synth_batch(seed, s=5, noise=0.05):
    """``tests/test_usl.py::_synth_batch``'s draws."""
    rng = np.random.default_rng(seed)
    sigma = rng.uniform(0.0, 0.7, s)
    kappa = rng.uniform(0.0, 0.02, s)
    gamma = rng.uniform(0.2, 30.0, s)
    t = ref.usl_throughput(NS[None, :], sigma[:, None], kappa[:, None],
                           gamma[:, None])
    t = t * rng.lognormal(0.0, noise, t.shape)
    return np.broadcast_to(NS, (s, NS.size)), t


def assert_fits_equal(got, want):
    """Every ``USLFit`` field equal, the history's parameter arrays too."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for f in dataclasses.fields(w):
            a, b = getattr(g, f.name), getattr(w, f.name)
            if f.name == "history":
                assert len(a) == len(b)
                for (pa, sa), (pb, sb) in zip(a, b):
                    assert np.array_equal(pa, pb) and sa == sb
            else:
                assert a == b, (f.name, a, b)


def assert_fits_close(got, want, n):
    """The torch fits within ``TOL`` of the numpy fits (CIs too)."""
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.predict(n), w.predict(n), rtol=TOL["t_rtol"], atol=0)
        assert abs(g.sigma - w.sigma) <= TOL["sigma"]
        assert abs(g.kappa - w.kappa) <= TOL["kappa"]
        assert abs(g.gamma - w.gamma) <= TOL["gamma_rtol"] * abs(w.gamma)
        assert (g.n_obs, g.fixed_gamma, g.n_bootstrap) == (w.n_obs, w.fixed_gamma, w.n_bootstrap)
        if w.n_bootstrap:
            for gb, wb in zip(g.sigma_ci, w.sigma_ci):
                assert abs(gb - wb) <= TOL["sigma"]
            for gb, wb in zip(g.kappa_ci, w.kappa_ci):
                assert abs(gb - wb) <= TOL["kappa"]
            for gb, wb in zip(g.peak_n_ci, w.peak_n_ci):
                assert gb == wb or abs(gb - wb) <= TOL["peak_rtol"] * abs(wb)


# -- the numpy path, bit for bit ----------------------------------------------

@pytest.mark.parametrize("seed", [0, 7, 21, 1234])
def test_numpy_batch_equals_reference(seed):
    n, t = _synth_batch(seed, s=16)
    assert_fits_equal(port.fit_usl_batch(n, t), ref.fit_usl_batch(n, t))
    assert_fits_equal([port.fit_usl(NS, t[0])], [ref.fit_usl(NS, t[0])])


def test_numpy_ragged_and_fix_gamma_equal_reference():
    rng = np.random.default_rng(5)
    ns = [NS, NS[:4], NS[2:], NS[[0, 3, 6]]]
    ts = [ref.usl_throughput(a, 0.2, 0.004, 3.0) * rng.lognormal(0, 0.04, a.shape)
          for a in ns]
    for kw in ({}, {"fix_gamma": True}, {"max_iter": 7, "tol": 1e-6}):
        assert_fits_equal(port.fit_usl_ragged(ns, ts, **kw),
                          ref.fit_usl_ragged(ns, ts, **kw))


def test_numpy_weights_bootstrap_history_and_warm_start_equal_reference():
    n, t = _synth_batch(3, s=8)
    w = (np.random.default_rng(3).uniform(size=t.shape) < 0.7).astype(np.float64)
    w[:, :2] = 1.0                                    # >= 2 observations a row
    cases = [dict(weights=w), dict(weights=w, fix_gamma=True),
             dict(bootstrap=32, bootstrap_seed=4), dict(bootstrap=16, fix_gamma=True, ci_level=0.9),
             dict(keep_history=True),
             dict(seed_params=np.column_stack([np.full(8, 0.1), np.full(8, 1e-3),
                                               t[:, 0]]), max_iter=30)]
    for kw in cases:
        assert_fits_equal(port.fit_usl_batch(n, t, **kw), ref.fit_usl_batch(n, t, **kw))
    peaks = port.fit_usl_batch(n, t, bootstrap=8)
    assert all(f.summary() == r.summary()
               for f, r in zip(peaks, ref.fit_usl_batch(n, t, bootstrap=8)))


BAD_INPUTS = [
    lambda m: m.fit_usl_batch(NS, np.ones(NS.size)),
    lambda m: m.fit_usl_batch(NS[:3], np.ones((1, NS.size))),
    lambda m: m.fit_usl_batch(NS, np.ones((1, NS.size)), weights=-np.ones((1, NS.size))),
    lambda m: m.fit_usl_batch(NS, np.ones((1, NS.size)), weights=np.eye(1, NS.size)),
    lambda m: m.fit_usl_batch(NS - 1.0, np.ones((1, NS.size))),
    lambda m: m.fit_usl_batch(NS, -np.ones((1, NS.size))),
    lambda m: m.fit_usl_batch(NS, np.ones((1, NS.size)), seed_params=[[0.1, 0.0]]),
    lambda m: m.fit_usl([1.0], [1.0]),
    lambda m: m.fit_usl(NS, np.ones(3)),
    lambda m: m.fit_usl_ragged([NS], []),
    lambda m: m.fit_usl_ragged([NS], [np.ones(3)]),
]


@pytest.mark.parametrize("case", range(len(BAD_INPUTS)))
def test_same_value_errors_as_reference(case):
    call = BAD_INPUTS[case]
    with pytest.raises(ValueError) as want:
        call(ref)
    with pytest.raises(ValueError) as got:
        call(port)
    assert str(got.value) == str(want.value)


def test_empty_batch_and_unknown_backends():
    assert port.fit_usl_batch(NS, np.zeros((0, NS.size))) == []
    assert port.fit_usl_ragged([], []) == []
    with pytest.raises(ValueError, match="'torch'"):
        port.fit_usl_batch(NS, np.ones((1, NS.size)), backend="jax")
    with pytest.raises(ValueError, match="numpy-only"):
        port.fit_usl_batch(NS, np.ones((1, NS.size)), backend="torch", device="cpu",
                           seed_params=[[0.1, 0.0, 1.0]])


def test_helpers_equal_reference():
    rng = np.random.default_rng(11)
    a, b = rng.uniform(size=9), rng.uniform(size=9)
    assert port.r_squared(a, b) == ref.r_squared(a, b)
    assert port.rmse(a, b) == ref.rmse(a, b)
    assert port.r_squared(a, a) == ref.r_squared(a, a) == 1.0
    sig, kap = rng.uniform(0, 1, 20), np.concatenate([np.zeros(4), rng.uniform(0, 0.1, 16)])
    assert np.array_equal(port._peak_n_arr(sig, kap), ref._peak_n_arr(sig, kap))
    fit = port.USLFit(sigma=0.1, kappa=2e-3, gamma=4.0, r2=1.0, rmse=0.0, n_obs=3)
    want = ref.USLFit(sigma=0.1, kappa=2e-3, gamma=4.0, r2=1.0, rmse=0.0, n_obs=3)
    assert (fit.peak_n, fit.peak_throughput, fit.summary()) == \
        (want.peak_n, want.peak_throughput, want.summary())
    assert np.array_equal(fit.efficiency(NS), want.efficiency(NS))


# -- the torch fit, on the CPU ---------------------------------------------------

@pytest.mark.parametrize("seed", [0, 9])
def test_torch_fit_matches_reference_numpy_on_256_scenarios(seed):
    n, t = _synth_batch(seed, s=256)
    got = port.fit_usl_batch(n, t, backend="torch", device="cpu")
    assert_fits_close(got, ref.fit_usl_batch(n, t), NS)


def test_torch_fit_bootstrap_cis_match_reference_numpy():
    n, t = _synth_batch(2, s=24)
    got = port.fit_usl_batch(n, t, backend="torch", device="cpu", bootstrap=64,
                             bootstrap_seed=5)
    assert_fits_close(got, ref.fit_usl_batch(n, t, bootstrap=64, bootstrap_seed=5), NS)


def test_torch_fit_weights_ragged_and_fix_gamma_match_reference_numpy():
    n, t = _synth_batch(4, s=32)
    w = (np.random.default_rng(4).uniform(size=t.shape) < 0.7).astype(np.float64)
    w[:, -2:] = 1.0
    for kw in (dict(weights=w), dict(fix_gamma=True), dict(weights=w, fix_gamma=True)):
        got = port.fit_usl_batch(n, t, backend="torch", device="cpu", **kw)
        assert_fits_close(got, ref.fit_usl_batch(n, t, **kw), NS)
    ns = [NS, NS[:4], NS[3:]]
    ts = [t[i, :a.size] for i, a in enumerate(ns)]
    got = port.fit_usl_ragged(ns, ts, backend="torch", device="cpu")
    for g, w_, a in zip(got, ref.fit_usl_ragged(ns, ts), ns):
        assert_fits_close([g], [w_], a)
    one = port.fit_usl(NS, t[0], backend="torch", device="cpu", keep_history=True)
    assert one.history == []                       # numpy-only, as the reference's jax path
    assert_fits_close([one], [ref.fit_usl(NS, t[0])], NS)


def test_torch_fit_keeps_a_degenerate_row_apart():
    """A row with every point at N = 1 (fixed gamma: a zero Jacobian, so
    only the damping keeps its normal matrix regular) ends where numpy's
    does, and the rows beside it fit as they would alone."""
    n, t = _synth_batch(6, s=4)
    n = np.array(n)
    n[1] = 1.0
    got = port.fit_usl_batch(n, t, backend="torch", device="cpu", fix_gamma=True)
    want = ref.fit_usl_batch(n, t, fix_gamma=True)
    assert_fits_close(got, want, NS)
