"""The lockstep kernels' walk, emulated in plain torch on the CPU.

``csrc/lockstep_scan.cu`` reformulates both scans for the card: a walker
lane a seed, helpers staging tiles of T steps a phase ahead in three
rotating buffers (loaded into registers a phase before that), and (grid)
each step's earlier finishes taken from the step's last writers: folded
into ``pre`` by the helpers where older than the walker's tile and the
one before it, else read by the walker from the buffers (loaded AHEAD
steps early) or from its last three finishes.  The
emulations below follow that schedule and layout, with the helpers' share
of a phase run before the walker's so that a buffer both touched in one
phase would show, and are held bit for bit to the plain loops in ``ref.py``
(trajectories at 9 + 9 and 2,004 slots, ragged last tiles, NaN inputs, an
index out of range) and within rtol 1e-5 of the reference's jax scans.
"""

import numpy as np
import pytest
import torch

from repro.core import miniapp as ref
from repro.sim import batched as ref_batched
from repro_torch.core import miniapp as port
from repro_torch.kernels.lockstep_scan.ref import grid_lockstep_scan_ref, lockstep_scan_ref
from repro_torch.sim import batched

# lockstep_scan.cu: steps a tile, ring loads ahead, tile buffers, slots a kind in the table
T, AHEAD, NBUF, CAP = 96, 3, 3, 512
JAX_RTOL = 1e-5              # tests/test_torch_batched.py's: float32 torch vs float32 jax
LOCK_CELL = dict(machine="serverless", scaling_policy="static", static_partitions=1,
                 horizon_s=60.0, rate=dict(kind="step", base_hz=2.0, high_hz=4.0, t_step=30.0))
GRID_CELL = dict(machine="serverless", scaling_policy="usl", usl_sigma=0.0, usl_kappa=3.0e-4,
                 usl_gamma=1.94, horizon_s=90.0, max_partitions=16, slo_lag=32,
                 control_interval_s=2.0, stabilization_s=0.0, scale_down_hysteresis=0.08,
                 headroom=0.0, catchup_horizon_s=8.0, refit_interval_s=5.0, max_step_up=2,
                 drift_t_s=25.0, drift_factor=1.8, refit_half_life_s=25.0,
                 rate=dict(kind="step", base_hz=2.0, high_hz=10.0, t_step=15.0, t_end=70.0))


def _last_writer(slot, valid, k):
    """The helpers' backward scan (slots above CAP): the nearest valid j < k
    with slot[j] == slot[k], looked for eight candidates at a time; -1 if
    none."""
    for j0 in range(k - 1, -1, -8):
        hit = -1
        for q in range(7, -1, -1):
            j = j0 - q
            if j >= 0 and slot[j] == slot[k] and valid[j]:
                hit = j
        if hit >= 0:
            return hit
    return -1


def _table_writers(slot, live, k0, tile, table):
    """The helpers' search where every slot is below CAP: within each warp's
    32 steps the nearest earlier live step with the same slot (match-any),
    else the table of each slot's last writer before; then the warp's last
    writer of each slot goes in the table, the first half-tile first."""
    out = []
    for g0 in range(k0, k0 + tile, 32):
        group = range(g0, min(g0 + 32, k0 + tile, len(slot)))
        for k in group:
            earlier = [j for j in group if j < k and live[j] and slot[j] == slot[k]]
            out.append(-2 if not live[k] else earlier[-1] if earlier
                       else table.get(slot[k], -1))
        for k in group:
            if live[k]:
                table[slot[k]] = k
    out += [-1] * (tile - len(out))          # steps past n
    return out


def grid_emulated(floors, parts, conts, dt, n_parts, n_conts, tile=T):
    """grid_lockstep_kernel's schedule on CPU tensors (as the wrapper takes
    them); returns what it writes to ``out``."""
    S, n = dt.shape
    parts_l, conts_l = parts.tolist(), conts.tolist()
    valid = [0 <= p < n_parts and 0 <= c < n_conts for p, c in zip(parts_l, conts_l)]
    tiles = -(-n // tile)
    out = torch.full((S, n), float("nan"))
    buf = torch.zeros((NBUF, S, tile + 1))
    buf[:, :, tile] = float("-inf")                  # the pad column: "no operand"
    pre = torch.zeros((2, S, tile))
    code = [[None] * tile, [None] * tile]
    use_table = n_parts <= CAP and n_conts <= CAP
    tables = ({}, {})

    def stage(t):
        k0, b = t * tile, buf[t % NBUF]
        b[:, :tile] = 0.0
        b[:, :min(tile, n - k0)] = dt[:, k0:k0 + tile]

    def write_back(t):
        k0 = t * tile
        out[:, k0:k0 + tile] = buf[t % NBUF][:, :min(tile, n - k0)]

    def prepare(u):
        k0, fold_below = u * tile, u * tile - tile
        if use_table:
            found = list(zip(*(_table_writers(sl, valid, k0, tile, tb)
                               for sl, tb in zip((parts_l, conts_l), tables))))
        for i in range(tile):
            k = k0 + i
            if k >= n:
                ws = (-1, -1)
            elif not valid[k]:
                ws = (-2, -2)
            elif use_table:
                ws = found[i]
            else:
                ws = (_last_writer(parts_l, valid, k), _last_writer(conts_l, valid, k))
            offs, mask = [(0, tile), (0, tile)], 0
            v = floors[k].expand(S).clone() if k < n else torch.zeros(S)
            if ws[0] == -2:
                v.fill_(float("nan"))
            else:
                for x, j in enumerate(ws):
                    if j == -1:
                        v = torch.maximum(v, torch.zeros(S))
                    elif j < fold_below:                 # the helpers fold it
                        v = torch.maximum(v, buf[(j // tile) % NBUF][:, j % tile]
                                          if j >= fold_below - tile else out[:, j])
                    elif k - j <= AHEAD:                 # the walker's registers
                        mask |= 1 << (k - j)
                    else:                                # the walker's buffers
                        offs[x] = ((j // tile) % NBUF, j % tile)
            code[u % 2][i] = (offs, mask)
            pre[u % 2][:, i] = v

    def ring(off):
        return buf[off[0]][:, off[1]].clone()

    stage(0)
    prepare(0)
    prev = prev2 = prev3 = torch.zeros(S)
    for t in range(tiles):
        if t + 1 < tiles:
            stage(t + 1)
            prepare(t + 1)
        if t >= 1:
            write_back(t - 1)
        row, pr, cd = buf[t % NBUF], pre[t % 2], code[t % 2]
        va = [ring(cd[i][0][0]) for i in range(AHEAD)]
        vb = [ring(cd[i][0][1]) for i in range(AHEAD)]
        for i in range(tile):
            mask = cd[i][1]
            m = torch.maximum(pr[:, i], torch.maximum(va[i % AHEAD], vb[i % AHEAD]))
            if i + AHEAD < tile:
                va[i % AHEAD], vb[i % AHEAD] = ring(cd[i + AHEAD][0][0]), ring(cd[i + AHEAD][0][1])
            for bit, earlier in ((8, prev3), (4, prev2), (2, prev)):
                if mask & bit:
                    m = torch.maximum(m, earlier)
            fin = m + row[:, i]
            row[:, i] = fin
            prev3, prev2, prev = prev2, prev, fin
    write_back(tiles - 1)
    return out


def chain_emulated(appends, means, z, a, b, tile=T):
    """lockstep_chain_kernel's schedule on CPU tensors; returns ``out``."""
    S, n = z.shape
    a32, b32 = torch.tensor(a, dtype=torch.float32), torch.tensor(b, dtype=torch.float32)
    tiles = -(-n // tile)
    out = torch.full((S, n), float("nan"))
    buf = torch.zeros((NBUF, S, tile + 1))
    app = torch.zeros((NBUF, tile))

    def load(t):                 # tile t's z, appends and means, zeros past n
        k0, m = t * tile, min(tile, n - t * tile)
        regs = torch.zeros((S, tile)), torch.zeros(tile), torch.zeros(tile)
        for dst, src in zip(regs, (z, appends, means)):
            dst[..., :m] = src[..., k0:k0 + m]
        return regs

    def put(t, regs):            # dt and appends of tile t into its buffers
        zt, at, mt = regs
        buf[t % NBUF][:, :tile] = mt[None, :] * torch.exp(a32 + b32 * zt)
        app[t % NBUF] = at

    def write_back(t):
        k0 = t * tile
        out[:, k0:k0 + tile] = buf[t % NBUF][:, :min(tile, n - k0)]

    regs = load(0)
    put(0, regs)
    if tiles > 1:
        regs = load(1)
    finish = torch.zeros(S)
    for t in range(tiles):
        if t + 1 < tiles:
            put(t + 1, regs)
        if t >= 1:
            write_back(t - 1)
        if t + 2 < tiles:
            regs = load(t + 2)
        row, ap = buf[t % NBUF], app[t % NBUF]
        for i in range(tile):
            finish = torch.maximum(ap[i], finish) + row[:, i]
            row[:, i] = finish
    write_back(tiles - 1)
    return out


def _grid_inputs(s, n, n_parts, n_conts, seed=0, floors="rising"):
    """Rising floors (arrivals) mostly decide a step's start; flat ones (all
    0) leave it to the slots' earlier finishes, however far back."""
    rng = np.random.default_rng(seed)
    floors = np.cumsum(rng.exponential(0.1 if floors == "rising" else 0.0, n)).astype(np.float32)
    parts = rng.integers(0, n_parts, n).astype(np.int32)
    conts = rng.integers(0, n_conts, n).astype(np.int32)
    dt = rng.uniform(0.05, 0.6, (s, n)).astype(np.float32)
    return [torch.from_numpy(x) for x in (floors, parts, conts, dt)]


def _chain_inputs(s, n, seed=0):
    rng = np.random.default_rng(seed)
    appends = np.cumsum(rng.exponential(0.3, n)).astype(np.float32)
    means = rng.uniform(0.1, 0.5, n).astype(np.float32)
    z = rng.standard_normal((s, n)).astype(np.float32)
    return [torch.from_numpy(x) for x in (appends, means, z)]


@pytest.mark.parametrize("floors", ["rising", "flat"])
@pytest.mark.parametrize("s,n,n_parts,n_conts,tile", [
    (8, 1041, 9, 9, T),            # the whatif shape: 10 whole tiles and a ragged one
    (5, 300, 4, 2000, T),          # 2,004 slots: the backward scan, writers folded from out
    (3, 131, 9, 9, 8),             # small tiles: every fold, ring and register route
    (4, 96, 3, 3, T),              # one whole tile
    (2, 97, 2, 5, T),              # one step into the second tile
    (1, 1, 1, 1, T)])
def test_grid_emulation_is_bit_equal_to_plain(s, n, n_parts, n_conts, tile, floors):
    floors, parts, conts, dt = _grid_inputs(s, n, n_parts, n_conts, seed=n, floors=floors)
    got = grid_emulated(floors, parts, conts, dt, n_parts, n_conts, tile)
    assert torch.equal(got, grid_lockstep_scan_ref(floors, parts, conts, dt, n_parts, n_conts))


def test_grid_emulation_takes_each_route_on_the_whatif_shape():
    """At 9 + 9 slots over 1,041 steps the writers fall at every distance
    the walker handles: the last three steps, this tile and the last, and
    (with tiles of 8) older ones folded into pre."""
    _, parts, conts, _ = _grid_inputs(8, 1041, 9, 9, seed=1041)
    valid = [True] * 1041
    dist = {k - w for slot in (parts.tolist(), conts.tolist())
            for k in range(1041) if (w := _last_writer(slot, valid, k)) >= 0}
    assert {1, 2, 3} <= dist and any(AHEAD < d < T for d in dist)
    assert any(d > 2 * 8 for d in dist)


@pytest.mark.parametrize("where", ["floors", "dt"])
def test_grid_emulation_propagates_nan_as_the_plain_loop(where):
    floors, parts, conts, dt = _grid_inputs(8, 400, 6, 9, seed=8)
    if where == "floors":
        floors[150] = float("nan")
    else:
        dt[3, 150] = float("nan")
    got = grid_emulated(floors, parts, conts, dt, 6, 9)
    want = grid_lockstep_scan_ref(floors, parts, conts, dt, 6, 9)
    assert torch.isnan(want).any() and not torch.isnan(want).all()
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(got.nan_to_num(), want.nan_to_num())


@pytest.mark.parametrize("field", ["parts", "conts"])
def test_grid_emulation_marks_an_index_out_of_range(field):
    """The step's finish is NaN and it writes no state: every other finish
    is the plain loop's on the trajectory without that step."""
    floors, parts, conts, dt = _grid_inputs(4, 200, 3, 5, seed=4)
    (parts if field == "parts" else conts)[70] = 5 if field == "parts" else -1
    got = grid_emulated(floors, parts, conts, dt, 3, 5)
    keep = torch.arange(200) != 70
    assert torch.isnan(got[:, 70]).all()
    assert torch.equal(got[:, keep], grid_lockstep_scan_ref(
        floors[keep], parts[keep], conts[keep], dt[:, keep], 3, 5))


@pytest.mark.parametrize("s,n,tile", [(8, 1041, T), (33, 7, T), (3, 130, 8), (1, 96, T),
                                      (2, 97, T), (1, 1, T)])
def test_chain_emulation_is_bit_equal_to_plain(s, n, tile):
    appends, means, z = _chain_inputs(s, n, seed=s + n)
    got = chain_emulated(appends, means, z, -0.0198, 0.1990, tile)
    assert torch.equal(got, lockstep_scan_ref(appends, means, z, -0.0198, 0.1990))


@pytest.mark.parametrize("where", ["appends", "z"])
def test_chain_emulation_propagates_nan_as_the_plain_loop(where):
    appends, means, z = _chain_inputs(8, 300, seed=7)
    if where == "appends":
        appends[120] = float("nan")
    else:
        z[2, 120] = float("nan")
    got = chain_emulated(appends, means, z, -0.0198, 0.1990)
    want = lockstep_scan_ref(appends, means, z, -0.0198, 0.1990)
    assert torch.isnan(want[:, 120:]).any() and not torch.isnan(want[:, :120]).any()
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(got.nan_to_num(), want.nan_to_num())


def test_emulations_within_rtol_of_the_reference_jax_scans():
    seeds = list(range(8))
    x = batched.lockstep_inputs(port.AdaptationExperiment(seed=0, **LOCK_CELL), seeds)
    f32 = [torch.from_numpy(np.ascontiguousarray(x[k], dtype=np.float32))
           for k in ("appends", "means", "z")]
    got = chain_emulated(*f32, x["a"], x["b"])
    want = ref_batched.lockstep_completion_times(ref.AdaptationExperiment(seed=0, **LOCK_CELL),
                                                 seeds)
    np.testing.assert_allclose(got.numpy(), want, rtol=JAX_RTOL, atol=0)
    g = batched.grid_lockstep_inputs(port.AdaptationExperiment(seed=0, **GRID_CELL), seeds)
    got = grid_emulated(*(torch.from_numpy(g[k]) for k in ("floors", "parts", "conts", "dt")),
                        g["n_parts"], g["n_conts"])
    want = ref_batched.grid_lockstep_completion_times(
        ref.AdaptationExperiment(seed=0, **GRID_CELL), seeds)
    assert got.shape == want.shape and got.shape[1] > T
    np.testing.assert_allclose(got.numpy(), want, rtol=JAX_RTOL, atol=0)
