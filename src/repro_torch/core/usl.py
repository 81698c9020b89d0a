"""Universal Scalability Law (USL) model — the analytical core of StreamInsight.

The paper (§IV-A) models streaming-system throughput as

    T(N) = gamma * N / (1 + sigma*(N - 1) + kappa*N*(N - 1))

where
  * ``N``      is the parallelism (number of partitions of the processing system),
  * ``sigma``  is the *contention* coefficient (serial fraction / shared-resource
               queueing — e.g. serialization, shared filesystem bandwidth),
  * ``kappa``  is the *coherence* coefficient (pairwise synchronization cost —
               e.g. all-to-all model-parameter sharing),
  * ``gamma``  is the throughput of a single worker (the paper normalizes
               T(1)=1, i.e. gamma fixed to the single-partition throughput; we
               expose both behaviours).

``sigma = kappa = 0`` is linear scaling; ``kappa = 0`` reduces to Amdahl's law;
``kappa > 0`` produces a throughput *peak* at ``N* = sqrt((1 - sigma)/kappa)``
followed by retrograde scaling — the behaviour the paper observes for
Kafka/Dask on HPC shared filesystems.

Fitting engine
--------------
The core is **batched**: ``fit_usl_batch(n, t)`` fits S scenarios at once on
stacked ``(S, P)`` observation matrices —

1. a fully vectorized grid seed: one broadcast evaluation of the
   ``(sigma_grid × kappa_grid × S × P)`` tensor (chunked over scenarios to
   bound memory) with the closed-form optimal gamma per grid cell;
2. batched Levenberg–Marquardt: stacked ``(S, 3)`` parameters, batched
   3×3 normal-equation solves (``np.linalg.solve`` on ``(S, 3, 3)`` stacks),
   per-scenario damping, and an active-scenario mask so converged fits stop
   paying for the stragglers' iterations;
3. optional per-observation ``weights`` — a 0/1 mask makes ragged scenario
   groups and train/test splits rectangular, and integer multiplicities make
   bootstrap resamples *just more rows in the batch*, which is how
   ``bootstrap=B`` produces nearly-free percentile confidence intervals for
   (sigma, kappa, peak_N).

``backend="numpy"`` (default, zero-dependency) and ``backend="torch"``
(the same batched LM in float64 on a torch ``device``, default ``"cuda"``;
intended for very large batches such as bootstrap resamples) share the same
seed grids and damping schedule.  Scalar ``fit_usl`` is a thin S=1 wrapper
over the batch path — one code path, identical results.

Ports ``repro.core.usl``: the numpy path is a copy and agrees with the
reference bit for bit; the torch fit takes the place of the reference's
jit + vmap float32 backend (``backend="jax"``, which raises here).

Pure numpy by default — no scipy/R dependency (the paper uses the `usl` R
package; this is a from-scratch equivalent validated by property tests).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

__all__ = [
    "usl_throughput",
    "USLFit",
    "fit_usl",
    "fit_usl_batch",
    "fit_usl_ragged",
    "r_squared",
    "rmse",
]

# Coarse (sigma, kappa) seed grids.  Flattened sigma-major so np.argmin's
# first-minimum tie-breaking matches the historical scalar loop order.
SIGMA_GRID = np.concatenate([[0.0], np.logspace(-4, 0, 17)])
KAPPA_GRID = np.concatenate([[0.0], np.logspace(-6, 0, 19)])

# Levenberg–Marquardt damping schedule (shared by both backends).
_LAM_INIT = 1e-3
_LAM_MIN = 1e-12
_LAM_MAX = 1e12
_GAMMA_MIN = 1e-12

# Bound on the (G, chunk, P) grid-seed broadcast tensor (elements), so huge
# bootstrap batches never materialize multi-GB intermediates.
_SEED_CHUNK_ELEMS = 8_000_000


def usl_throughput(n, sigma, kappa, gamma=1.0):
    """Evaluate T(N) for scalar or array ``n`` (coefficients broadcast)."""
    n = np.asarray(n, dtype=np.float64)
    denom = 1.0 + sigma * (n - 1.0) + kappa * n * (n - 1.0)
    return gamma * n / denom


def r_squared(y_true, y_pred) -> float:
    y_true = np.asarray(y_true, dtype=np.float64)
    y_pred = np.asarray(y_pred, dtype=np.float64)
    ss_res = float(np.sum((y_true - y_pred) ** 2))
    ss_tot = float(np.sum((y_true - np.mean(y_true)) ** 2))
    if ss_tot == 0.0:
        return 1.0 if ss_res == 0.0 else 0.0
    return 1.0 - ss_res / ss_tot


def rmse(y_true, y_pred) -> float:
    y_true = np.asarray(y_true, dtype=np.float64)
    y_pred = np.asarray(y_pred, dtype=np.float64)
    return float(np.sqrt(np.mean((y_true - y_pred) ** 2)))


def _fmt_ci(ci) -> str:
    lo, hi = ci
    def f(x):
        return "inf" if math.isinf(x) else f"{x:.4g}"
    return f"[{f(float(lo))}, {f(float(hi))}]"


@dataclass
class USLFit:
    """Result of fitting the USL to (N, T) observations.

    ``history`` is opt-in (``keep_history=True``): per-iteration
    ``(params, sse)`` snapshots are dead weight for thousands of batched
    fits, so by default it stays empty.  ``sigma_ci``/``kappa_ci``/
    ``peak_n_ci`` are percentile bootstrap confidence intervals, populated
    when the fit was made with ``bootstrap=B > 0``.
    """

    sigma: float
    kappa: float
    gamma: float
    r2: float
    rmse: float
    n_obs: int
    fixed_gamma: bool = False
    history: list = field(default_factory=list, repr=False)
    sigma_ci: tuple | None = None
    kappa_ci: tuple | None = None
    peak_n_ci: tuple | None = None
    n_bootstrap: int = 0
    ci_level: float = 0.95

    def predict(self, n):
        return usl_throughput(n, self.sigma, self.kappa, self.gamma)

    @property
    def peak_n(self) -> float:
        """Parallelism that maximizes T(N); inf if scaling never retrogrades."""
        if self.kappa <= 0.0:
            return math.inf
        return math.sqrt(max(0.0, 1.0 - self.sigma) / self.kappa)

    @property
    def peak_throughput(self) -> float:
        n = self.peak_n
        if math.isinf(n):
            return math.inf
        return float(usl_throughput(max(n, 1.0), self.sigma, self.kappa, self.gamma))

    def efficiency(self, n):
        """Fraction of linear scaling retained at parallelism n."""
        return self.predict(n) / (self.gamma * np.asarray(n, dtype=np.float64))

    def summary(self) -> str:
        peak = self.peak_n
        peak_s = f"{peak:.1f}" if math.isfinite(peak) else "inf"
        out = (
            f"USL(sigma={self.sigma:.4f}, kappa={self.kappa:.6f}, "
            f"gamma={self.gamma:.3f}) R2={self.r2:.4f} RMSE={self.rmse:.4g} "
            f"peak_N={peak_s}"
        )
        if self.n_bootstrap:
            pct = int(round(self.ci_level * 100))
            out += (
                f" CI{pct}(sigma={_fmt_ci(self.sigma_ci)}, "
                f"kappa={_fmt_ci(self.kappa_ci)}, "
                f"peak_N={_fmt_ci(self.peak_n_ci)}; B={self.n_bootstrap})"
            )
        return out


def _peak_n_arr(sigma, kappa):
    """Batched N* = sqrt((1-sigma)/kappa); inf where kappa <= 0."""
    sigma = np.asarray(sigma, dtype=np.float64)
    kappa = np.asarray(kappa, dtype=np.float64)
    safe = np.where(kappa > 0.0, kappa, 1.0)
    return np.where(kappa > 0.0,
                    np.sqrt(np.maximum(1.0 - sigma, 0.0) / safe), np.inf)


def _usl_batch_eval(n, sigma, kappa, gamma):
    """T(N) for (S, P) ``n`` with per-scenario (S,) coefficients."""
    s = np.asarray(sigma, dtype=np.float64)[:, None]
    k = np.asarray(kappa, dtype=np.float64)[:, None]
    g = np.asarray(gamma, dtype=np.float64)[:, None]
    return g * n / (1.0 + s * (n - 1.0) + k * n * (n - 1.0))


# -- batched numpy backend ----------------------------------------------------

def _grid_seed(n, t, w, fixed_gamma):
    """Vectorized coarse seed: argmin SSE over the whole (sigma, kappa)
    grid at once, with the closed-form weighted-LSQ gamma per cell.  One
    broadcast replaces the historical 360-iteration Python loop; chunked
    over scenarios to bound the (G, chunk, P) intermediate."""
    S, P = t.shape
    ss = np.repeat(SIGMA_GRID, KAPPA_GRID.size)[:, None, None]
    kk = np.tile(KAPPA_GRID, SIGMA_GRID.size)[:, None, None]
    G = ss.shape[0]
    chunk = max(1, _SEED_CHUNK_ELEMS // (G * P))
    params = np.empty((S, 3), dtype=np.float64)
    for lo in range(0, S, chunk):
        hi = min(lo + chunk, S)
        nc, tc, wc = n[lo:hi], t[lo:hi], w[lo:hi]
        denom = 1.0 + ss * (nc - 1.0) + kk * nc * (nc - 1.0)   # (G, C, P)
        base = nc / denom
        if fixed_gamma is not None:
            g = np.broadcast_to(fixed_gamma[lo:hi], (G, hi - lo))
        else:
            num = (wc * base * tc).sum(axis=-1)
            den = (wc * base * base).sum(axis=-1)
            g = np.where(den > 0.0,
                         np.maximum(num / np.where(den > 0.0, den, 1.0),
                                    _GAMMA_MIN),
                         1.0)
        r = g[..., None] * base - tc
        sse = (wc * r * r).sum(axis=-1)                        # (G, C)
        ib = np.argmin(sse, axis=0)
        params[lo:hi, 0] = ss[ib, 0, 0]
        params[lo:hi, 1] = kk[ib, 0, 0]
        params[lo:hi, 2] = g[ib, np.arange(hi - lo)]
    return params


def _fit_batch_numpy(n, t, w, fixed_gamma, max_iter, tol, keep_history,
                     seed_params=None):
    """Batched LM refinement from the vectorized grid seed.

    Per-scenario damping ``lam`` and an ``active`` mask reproduce the
    scalar control flow exactly: each global iteration is one damped step
    *attempt* per still-active scenario (accept → lam/3, reject → lam*4),
    and scenarios leave the batch on convergence, damping blow-up, or a
    singular normal matrix — so converged fits stop paying.

    ``seed_params`` (S, 3) warm-starts LM from a caller-supplied
    (sigma, kappa, gamma) per scenario instead of the grid seed — the
    online re-fitting path starts each refit from the previous fit, so a
    refit pays only the LM polish, not the full grid broadcast.
    """
    S, P = t.shape
    free_gamma = fixed_gamma is None
    if seed_params is None:
        params = _grid_seed(n, t, w, fixed_gamma)
    else:
        params = np.array(seed_params, dtype=np.float64, copy=True)
        params[:, 0] = np.clip(params[:, 0], 0.0, 1.0)
        params[:, 1] = np.maximum(params[:, 1], 0.0)
        params[:, 2] = (np.maximum(params[:, 2], _GAMMA_MIN) if free_gamma
                        else np.asarray(fixed_gamma, dtype=np.float64))
    res = _usl_batch_eval(n, params[:, 0], params[:, 1], params[:, 2]) - t
    sse = (w * res * res).sum(axis=1)
    lam = np.full(S, _LAM_INIT)
    active = np.ones(S, dtype=bool)
    histories = ([[(params[i].copy(), float(sse[i]))] for i in range(S)]
                 if keep_history else None)
    eye = np.eye(3)
    for _ in range(max_iter):
        idx = np.flatnonzero(active)
        if idx.size == 0:
            break
        p = params[idx]
        na, ta, wa, ra = n[idx], t[idx], w[idx], res[idx]
        gam = p[:, 2:3]
        denom = 1.0 + p[:, 0:1] * (na - 1.0) + p[:, 1:2] * na * (na - 1.0)
        inv2 = denom ** -2
        d_sig = -gam * na * (na - 1.0) * inv2
        d_kap = -gam * na * na * (na - 1.0) * inv2
        d_gam = (na / denom) if free_gamma else np.zeros_like(na)
        jac = np.stack([d_sig, d_kap, d_gam], axis=2)          # (A, P, 3)
        wj = wa[:, :, None] * jac
        jtj = np.einsum("apk,apm->akm", wj, jac)
        jtr = np.einsum("apk,ap->ak", wj, ra)
        diag = np.maximum(np.einsum("akk->ak", jtj), 1e-12)
        A = jtj + (lam[idx, None] * diag)[:, :, None] * eye
        singular = np.zeros(idx.size, dtype=bool)
        try:
            step = np.linalg.solve(A, -jtr[..., None])[..., 0]
        except np.linalg.LinAlgError:
            # the stacked solve fails as a whole: redo per scenario and
            # retire only the truly singular ones (scalar path: break)
            step = np.zeros_like(jtr)
            for j in range(idx.size):
                try:
                    step[j] = np.linalg.solve(A[j], -jtr[j][:, None])[:, 0]
                except np.linalg.LinAlgError:
                    singular[j] = True
        cand = p + step
        # sigma is a serial *fraction*: clamp to [0, 1] (an unconstrained
        # LM step on noisy saturated data can wander past 1, which models
        # negative capacity growth from N=1 and breaks peak reasoning)
        cand[:, 0] = np.clip(cand[:, 0], 0.0, 1.0)
        cand[:, 1] = np.maximum(cand[:, 1], 0.0)
        cand[:, 2] = (np.maximum(cand[:, 2], _GAMMA_MIN) if free_gamma
                      else p[:, 2])
        cdenom = 1.0 + cand[:, 0:1] * (na - 1.0) + cand[:, 1:2] * na * (na - 1.0)
        cres = cand[:, 2:3] * na / cdenom - ta
        csse = (wa * cres * cres).sum(axis=1)
        better = ~singular & (csse < sse[idx])
        rel = (sse[idx] - csse) / np.maximum(sse[idx], 1e-30)
        acc = idx[better]
        params[acc] = cand[better]
        res[acc] = cres[better]
        sse[acc] = csse[better]
        lam[acc] = np.maximum(lam[acc] / 3.0, _LAM_MIN)
        lam[idx[~better & ~singular]] *= 4.0
        if histories is not None:
            for i_glob in acc:
                histories[i_glob].append((params[i_glob].copy(),
                                          float(sse[i_glob])))
        done = singular | (better & (rel < tol)) \
            | (~better & ~singular & (lam[idx] > _LAM_MAX))
        active[idx[done]] = False
    gamma = params[:, 2] if free_gamma else np.asarray(fixed_gamma)
    return params[:, 0], params[:, 1], gamma, histories


# -- torch backend ------------------------------------------------------------

# the torch fit asks whether any scenario is still active once every this
# many iterations: the one host sync of the loop (an extra masked iteration
# changes no retired row)
_ACTIVE_CHECK_EVERY = 8


def _grid_seed_torch(n, t, w, fixed_gamma):
    """``_grid_seed`` on the device: the same sigma-major grid, chunking and
    first-minimum ``argmin``."""
    import torch

    S, P = t.shape
    ss = torch.as_tensor(np.repeat(SIGMA_GRID, KAPPA_GRID.size),
                         device=t.device)[:, None, None]
    kk = torch.as_tensor(np.tile(KAPPA_GRID, SIGMA_GRID.size),
                         device=t.device)[:, None, None]
    G = ss.shape[0]
    chunk = max(1, _SEED_CHUNK_ELEMS // (G * P))
    params = torch.empty((S, 3), dtype=torch.float64, device=t.device)
    for lo in range(0, S, chunk):
        hi = min(lo + chunk, S)
        nc, tc, wc = n[lo:hi], t[lo:hi], w[lo:hi]
        denom = 1.0 + ss * (nc - 1.0) + kk * nc * (nc - 1.0)   # (G, C, P)
        base = nc / denom
        if fixed_gamma is not None:
            g = fixed_gamma[lo:hi].expand(G, hi - lo)
        else:
            num = (wc * base * tc).sum(dim=-1)
            den = (wc * base * base).sum(dim=-1)
            g = torch.where(den > 0.0,
                            torch.clamp(num / torch.where(den > 0.0, den, 1.0),
                                        min=_GAMMA_MIN),
                            1.0)
        r = g[..., None] * base - tc
        sse = (wc * r * r).sum(dim=-1)                         # (G, C)
        ib = torch.argmin(sse, dim=0)
        params[lo:hi, 0] = ss[ib, 0, 0]
        params[lo:hi, 1] = kk[ib, 0, 0]
        params[lo:hi, 2] = g.gather(0, ib[None, :])[0]
    return params


def _fit_batch_torch(n, t, w, fixed_gamma, max_iter, tol, device):
    """``_fit_batch_numpy``'s LM in float64 on ``device``, every row at once.

    Each iteration computes a damped step for every row and only rows still
    active take its outcome (accept -> lam/3 floored at ``_LAM_MIN``, reject
    -> lam*4), so each scenario follows the numpy path's control flow: it
    retires on ``rel < tol``, on ``lam > _LAM_MAX`` or on a singular normal
    matrix (``solve_ex``'s ``info``, where numpy raises ``LinAlgError``).
    The loop syncs the host once every ``_ACTIVE_CHECK_EVERY`` iterations.
    Results agree with numpy's to rounding (sums run in another order)."""
    import torch

    from repro_torch import resolve_device

    dev = resolve_device(device)
    free_gamma = fixed_gamma is None
    f64 = dict(dtype=torch.float64, device=dev)
    n = torch.as_tensor(np.ascontiguousarray(n), **f64)
    t = torch.as_tensor(np.ascontiguousarray(t), **f64)
    w = torch.as_tensor(np.ascontiguousarray(w), **f64)
    fg = None if free_gamma else torch.as_tensor(np.asarray(fixed_gamma), **f64)
    params = _grid_seed_torch(n, t, w, fg)
    S = t.shape[0]
    nm1 = n - 1.0

    def residual(p):
        return p[:, 2:3] * n / (1.0 + p[:, 0:1] * nm1 + p[:, 1:2] * n * nm1) - t

    res = residual(params)
    sse = (w * res * res).sum(dim=1)
    lam = torch.full((S,), _LAM_INIT, **f64)
    active = torch.ones(S, dtype=torch.bool, device=dev)
    eye = torch.eye(3, **f64)
    lo = torch.tensor([0.0, 0.0, _GAMMA_MIN], **f64)
    hi = torch.tensor([1.0, math.inf, math.inf], **f64)
    for it in range(max_iter):
        if it % _ACTIVE_CHECK_EVERY == 0 and not bool(active.any()):
            break
        gam = params[:, 2:3]
        denom = 1.0 + params[:, 0:1] * nm1 + params[:, 1:2] * n * nm1
        inv2 = denom ** -2
        d_sig = -gam * n * nm1 * inv2
        d_kap = -gam * n * n * nm1 * inv2
        d_gam = n / denom if free_gamma else torch.zeros_like(n)
        jac = torch.stack([d_sig, d_kap, d_gam], dim=2)        # (S, P, 3)
        wj = w[:, :, None] * jac
        jtj = wj.transpose(1, 2) @ jac
        jtr = (wj * res[:, :, None]).sum(dim=1)
        diag = torch.clamp(torch.diagonal(jtj, dim1=1, dim2=2), min=1e-12)
        A = jtj + (lam[:, None] * diag)[:, :, None] * eye
        step, info = torch.linalg.solve_ex(A, -jtr[:, :, None],
                                           check_errors=False)
        singular = info != 0
        # sigma a fraction in [0, 1], kappa >= 0, gamma >= _GAMMA_MIN (or
        # pinned): the numpy path's clamps
        cand = torch.clamp(params + step[:, :, 0], min=lo, max=hi)
        if not free_gamma:
            cand[:, 2] = params[:, 2]
        cres = residual(cand)
        csse = (w * cres * cres).sum(dim=1)
        better = active & ~singular & (csse < sse)
        rejected = active & ~singular & ~better
        rel = (sse - csse) / torch.clamp(sse, min=1e-30)
        params = torch.where(better[:, None], cand, params)
        res = torch.where(better[:, None], cres, res)
        sse = torch.where(better, csse, sse)
        lam = torch.where(better, torch.clamp(lam / 3.0, min=_LAM_MIN),
                          torch.where(rejected, lam * 4.0, lam))
        done = (active & singular) | (better & (rel < tol)) \
            | (rejected & (lam > _LAM_MAX))
        active = active & ~done
    p = params.cpu().numpy()
    gamma = p[:, 2] if free_gamma else np.asarray(fixed_gamma, dtype=np.float64)
    return p[:, 0], p[:, 1], gamma


def _dispatch_fit(backend, n, t, w, fixed_gamma, max_iter, tol, keep_history,
                  seed_params, device):
    if backend == "numpy":
        return _fit_batch_numpy(n, t, w, fixed_gamma, max_iter, tol,
                                keep_history, seed_params)
    if backend == "torch":
        if seed_params is not None:
            raise ValueError(
                "seed_params warm starts are numpy-only; the torch path "
                "always runs its own grid seed")
        sig, kap, gam = _fit_batch_torch(n, t, w, fixed_gamma, max_iter, tol,
                                         device)
        return sig, kap, gam, None
    raise ValueError(f"unknown backend {backend!r}; expected 'numpy' or 'torch'")


def _bootstrap_cis(backend, n, t, w, fixed_gamma, max_iter, tol,
                   n_boot, seed, ci_level, device):
    """Percentile bootstrap over observation resamples.  A resample with
    replacement is exactly a multinomial weight vector over the observed
    points, so B resamples of S scenarios are one (B*S, P) weighted batch
    through the same fit core — nearly free next to S scalar refits."""
    S, P = t.shape
    rng = np.random.default_rng(seed)
    wsum = w.sum(axis=1)
    counts = np.maximum(np.rint(wsum).astype(np.int64), 2)
    pvals = w / wsum[:, None]
    wb = rng.multinomial(counts, pvals, size=(n_boot, S))
    wb = wb.astype(np.float64).reshape(n_boot * S, P)
    nb = np.broadcast_to(n, (n_boot, S, P)).reshape(n_boot * S, P)
    tb = np.broadcast_to(t, (n_boot, S, P)).reshape(n_boot * S, P)
    fgb = np.tile(fixed_gamma, n_boot) if fixed_gamma is not None else None
    sig, kap, _gam, _ = _dispatch_fit(backend, nb, tb, wb, fgb,
                                      max_iter, tol, False, None, device)
    sig = sig.reshape(n_boot, S)
    kap = kap.reshape(n_boot, S)
    peak = _peak_n_arr(sig, kap)
    q = [(1.0 - ci_level) / 2.0 * 100.0, (1.0 + ci_level) / 2.0 * 100.0]
    out = {}
    for name, arr in (("sigma", sig), ("kappa", kap), ("peak_n", peak)):
        # method="nearest" returns actual samples, so inf peak_N bounds
        # never hit inf-minus-inf interpolation
        lo, hi = np.percentile(arr, q, axis=0, method="nearest")
        out[name] = (lo, hi)
    return out


def fit_usl_batch(
    n,
    t,
    *,
    weights=None,
    fix_gamma: bool = False,
    max_iter: int = 200,
    tol: float = 1e-12,
    backend: str = "numpy",
    keep_history: bool = False,
    bootstrap: int = 0,
    bootstrap_seed: int = 0,
    ci_level: float = 0.95,
    seed_params=None,
    device="cuda",
) -> list[USLFit]:
    """Fit the USL to S scenarios at once.

    Parameters
    ----------
    n : ``(P,)`` shared parallelism levels or ``(S, P)`` per scenario.
    t : ``(S, P)`` measured throughputs.
    weights : optional ``(S, P)`` non-negative per-observation weights.
        Zeros exclude padded cells (ragged groups, train/test masks);
        integer multiplicities express resampling.  Padded cells may hold
        any values — they are neutralized before validation.
    fix_gamma : pin gamma per scenario to the mean throughput observed at
        that scenario's smallest N (the paper's normalization).
    backend : ``"numpy"`` (default) or ``"torch"`` (the batched LM in
        float64 on ``device``, meant for very large batches; ``history`` is
        not recorded).
    device : the torch device of ``backend="torch"`` (default ``"cuda"``,
        which raises when no card is present); unused by numpy.
    keep_history : record per-iteration ``(params, sse)`` snapshots on each
        ``USLFit`` (off by default — dead weight for large batches).
    bootstrap : number of bootstrap resamples per scenario (0 = off).
        Populates ``sigma_ci``/``kappa_ci``/``peak_n_ci`` with ``ci_level``
        percentile intervals.
    seed_params : optional ``(S, 3)`` per-scenario (sigma, kappa, gamma)
        warm start.  Skips the grid seed and runs LM from the given point —
        the online re-fitting loop passes its previous fit here so each
        refit costs only the polish iterations (numpy backend only;
        bootstrap resamples still seed from the grid).

    Returns one ``USLFit`` per scenario, in input order.
    """
    t = np.asarray(t, dtype=np.float64)
    if t.ndim != 2:
        raise ValueError(
            f"t must be 2-D (scenarios, observations), got shape {t.shape}")
    S, P = t.shape
    if S == 0:
        return []
    n = np.asarray(n, dtype=np.float64)
    if n.ndim == 1:
        n = np.broadcast_to(n, (S, P))
    if n.shape != t.shape:
        raise ValueError(
            f"n and t must have the same shape, got {n.shape} vs {t.shape}")
    if weights is None:
        w = np.ones((S, P), dtype=np.float64)
    else:
        w = np.asarray(weights, dtype=np.float64)
        if w.shape != t.shape:
            raise ValueError(
                f"weights must match t's shape {t.shape}, got {w.shape}")
        if np.any(w < 0.0):
            raise ValueError("weights must be non-negative")
    valid = w > 0.0
    if np.any(valid.sum(axis=1) < 2):
        raise ValueError("need at least 2 observations to fit USL")
    if np.any(valid & (n < 1.0)):
        raise ValueError("parallelism N must be >= 1")
    if np.any(valid & (t < 0.0)):
        raise ValueError("throughput must be non-negative")
    # neutralize padded cells so they cannot poison the broadcasts
    n = np.where(valid, n, 1.0)
    t = np.where(valid, t, 0.0)

    fixed_gamma = None
    if fix_gamma:
        n_min = np.min(np.where(valid, n, np.inf), axis=1)
        at_min = valid & (n == n_min[:, None])
        wm = w * at_min
        fixed_gamma = (wm * t).sum(axis=1) / wm.sum(axis=1) / n_min
        fixed_gamma = np.maximum(fixed_gamma, _GAMMA_MIN)

    if seed_params is not None:
        seed_params = np.asarray(seed_params, dtype=np.float64)
        if seed_params.shape != (S, 3):
            raise ValueError(
                f"seed_params must have shape ({S}, 3), got {seed_params.shape}")

    sigma, kappa, gamma, histories = _dispatch_fit(
        backend, n, t, w, fixed_gamma, max_iter, tol, keep_history,
        seed_params, device)

    pred = _usl_batch_eval(n, sigma, kappa, gamma)
    wsum = w.sum(axis=1)
    sse = (w * (pred - t) ** 2).sum(axis=1)
    rmse_v = np.sqrt(sse / wsum)
    tmean = (w * t).sum(axis=1) / wsum
    sst = (w * (t - tmean[:, None]) ** 2).sum(axis=1)
    r2_v = np.where(sst > 0.0, 1.0 - sse / np.where(sst > 0.0, sst, 1.0),
                    np.where(sse == 0.0, 1.0, 0.0))
    n_obs = valid.sum(axis=1)

    cis = None
    if bootstrap:
        cis = _bootstrap_cis(backend, n, t, w, fixed_gamma, max_iter, tol,
                             bootstrap, bootstrap_seed, ci_level, device)

    fits = []
    for i in range(S):
        fits.append(USLFit(
            sigma=float(sigma[i]),
            kappa=float(kappa[i]),
            gamma=float(gamma[i]),
            r2=float(r2_v[i]),
            rmse=float(rmse_v[i]),
            n_obs=int(n_obs[i]),
            fixed_gamma=fix_gamma,
            history=histories[i] if histories is not None else [],
            sigma_ci=(float(cis["sigma"][0][i]), float(cis["sigma"][1][i]))
            if cis else None,
            kappa_ci=(float(cis["kappa"][0][i]), float(cis["kappa"][1][i]))
            if cis else None,
            peak_n_ci=(float(cis["peak_n"][0][i]), float(cis["peak_n"][1][i]))
            if cis else None,
            n_bootstrap=bootstrap if cis else 0,
            ci_level=ci_level,
        ))
    return fits


def fit_usl_ragged(ns, ts, **kwargs) -> list[USLFit]:
    """Fit scenarios with *different* observation counts in one batch.

    ``ns``/``ts`` are sequences of 1-D arrays; rows are padded to the
    longest scenario and masked out via zero weights, then handed to
    ``fit_usl_batch`` (all keyword options forwarded).
    """
    if len(ns) != len(ts):
        raise ValueError("ns and ts must have the same length")
    S = len(ns)
    if S == 0:
        return []
    P = max(len(a) for a in ns)
    n = np.ones((S, P), dtype=np.float64)
    t = np.zeros((S, P), dtype=np.float64)
    w = np.zeros((S, P), dtype=np.float64)
    for i, (a, b) in enumerate(zip(ns, ts)):
        a = np.asarray(a, dtype=np.float64)
        b = np.asarray(b, dtype=np.float64)
        if a.ndim != 1 or a.shape != b.shape:
            raise ValueError(
                f"scenario {i}: n and t must be 1-D and same shape, "
                f"got {a.shape} vs {b.shape}")
        n[i, :a.size] = a
        t[i, :b.size] = b
        w[i, :a.size] = 1.0
    return fit_usl_batch(n, t, weights=w, **kwargs)


def fit_usl(
    n,
    t,
    *,
    fix_gamma: bool = False,
    max_iter: int = 200,
    tol: float = 1e-12,
    keep_history: bool = False,
    bootstrap: int = 0,
    bootstrap_seed: int = 0,
    backend: str = "numpy",
    device="cuda",
) -> USLFit:
    """Fit the USL to one scenario's observations.

    Parameters
    ----------
    n : array of parallelism levels (>= 1)
    t : array of measured throughputs (same length)
    fix_gamma : if True, pin gamma to the mean throughput observed at the
        smallest N (the paper's normalization); otherwise gamma is fitted.

    A thin S=1 wrapper over ``fit_usl_batch`` — scalar and batched fits
    share one code path by construction.
    """
    n = np.asarray(n, dtype=np.float64)
    t = np.asarray(t, dtype=np.float64)
    if n.shape != t.shape or n.ndim != 1:
        raise ValueError(
            f"n and t must be 1-D and same shape, got {n.shape} vs {t.shape}")
    if n.size < 2:
        raise ValueError("need at least 2 observations to fit USL")
    return fit_usl_batch(
        n[None, :], t[None, :], fix_gamma=fix_gamma, max_iter=max_iter,
        tol=tol, keep_history=keep_history, bootstrap=bootstrap,
        bootstrap_seed=bootstrap_seed, backend=backend, device=device)[0]
