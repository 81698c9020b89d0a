"""The port's K-Means distance wrappers against the JAX package's kernels.

On the CPU the port's wrappers run their plain versions; the JAX side runs
its Pallas kernels in interpret mode, as ``tests/test_kernels.py`` does.
Inputs come from numpy with a fixed seed and go to both packages.  The
kernels themselves are held against these plain versions on the card by
``tests/test_torch_kernels_cuda.py``.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.kmeans_distance import ops as kd_ops
from repro_torch import resolve_device
from repro_torch.kernels import _build
from repro_torch.kernels.kmeans_distance import ops as pt_ops
from repro_torch.kernels.kmeans_distance.ref import assign_ref, pairwise_sq_dists_ref

from _kmeans_ties import planted_ties

# the sweep and tolerances of tests/test_kernels.py
DIST_SHAPES = [(64, 16, 9), (256, 128, 9), (128, 300, 32), (512, 64, 130)]
ASSIGN_SHAPES = [(64, 16, 9), (256, 100, 17)]
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _inputs(n, k, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d), dtype=np.float32),
            rng.standard_normal((k, d), dtype=np.float32))


@pytest.mark.parametrize("n,k,d", DIST_SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_pairwise_sq_dists_matches_jax(n, k, d, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    x, c = _inputs(n, k, d)
    want = kd_ops.pairwise_sq_dists(jnp.asarray(x, jdt), jnp.asarray(c, jdt),
                                    use_pallas=True, interpret=True)
    got = pt_ops.pairwise_sq_dists(torch.from_numpy(x).to(tdt),
                                   torch.from_numpy(c).to(tdt))
    assert got.dtype == torch.float32 and got.shape == (n, k)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol * d)


@pytest.mark.parametrize("n,k,d", ASSIGN_SHAPES)
def test_assign_matches_jax(n, k, d):
    x, c = _inputs(n, k, d)
    j_labels, j_best = kd_ops.assign(jnp.asarray(x), jnp.asarray(c),
                                     use_pallas=True, interpret=True)
    labels, best = pt_ops.assign(torch.from_numpy(x), torch.from_numpy(c))
    assert labels.dtype == torch.int32 and best.dtype == torch.float32
    np.testing.assert_allclose(best.numpy(), np.asarray(j_best), rtol=1e-5, atol=1e-5)
    # ties can flip labels: hold them by the distance they pick
    d2 = pairwise_sq_dists_ref(torch.from_numpy(x), torch.from_numpy(c)).numpy()
    np.testing.assert_allclose(d2[np.arange(n), labels.numpy()], np.asarray(j_best),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(d2[np.arange(n), np.asarray(j_labels)], best.numpy(),
                               rtol=1e-5, atol=1e-5)


# -- K2's k-slices and their combine, emulated ----------------------------------

def _sliced_assign(x, c, width, lanes=4):
    """K2 as the card runs it: ``assign_ref`` on each k-slice (each keeps the
    first index of its minimum); then, as ``assign_combine_kernel`` does,
    ``lanes`` threads a row each reduce a contiguous run of slices in order
    with a strict <, and the runs are combined pairwise (shuffle offsets
    1, 2, ...), the smaller index winning an equal distance."""
    k = c.shape[0]
    parts = [assign_ref(x, c[k0:k0 + width]) for k0 in range(0, k, width)]
    parts = [(lab + k0, b) for (lab, b), k0 in zip(parts, range(0, k, width))]
    run = -(-len(parts) // lanes)
    n = x.shape[0]
    lane_l = [torch.full((n,), 2 ** 31 - 1, dtype=torch.int32) for _ in range(lanes)]
    lane_b = [torch.full((n,), float("inf")) for _ in range(lanes)]
    for g in range(lanes):
        for lab, b in parts[g * run:(g + 1) * run]:
            take = (b < lane_b[g]) | (lane_l[g] == 2 ** 31 - 1)
            lane_l[g] = torch.where(take, lab, lane_l[g])
            lane_b[g] = torch.where(take, b, lane_b[g])
    off = 1
    while off < lanes:
        new_l, new_b = list(lane_l), list(lane_b)
        for g in range(lanes):
            ol, ob = lane_l[g ^ off], lane_b[g ^ off]
            take = (ob < lane_b[g]) | ((ob == lane_b[g]) & (ol < lane_l[g]))
            new_l[g] = torch.where(take, ol, lane_l[g])
            new_b[g] = torch.where(take, ob, lane_b[g])
        lane_l, lane_b = new_l, new_b
        off *= 2
    return lane_l[0], lane_b[0]


# the widths the wrapper picks for the Mini-App's shapes on a card of 132 SMs
# with 7 (register design) or 12 (general design) resident blocks each, and
# odd widths that cut the planted ties elsewhere
@pytest.mark.parametrize("n,k,d,width", [
    (16000, 1024, 9, pt_ops.slice_width(16000, 1024, 9, 132 * 7)),
    (16000, 8192, 9, pt_ops.slice_width(16000, 8192, 9, 132 * 7)),
    (600, 130, 20, pt_ops.slice_width(600, 130, 20, 132 * 12)),
    (512, 100, 9, 7), (512, 100, 9, 1), (300, 65, 3, 64), (200, 30, 4, 10)])
def test_slice_combine_matches_assign_ref_and_jax(n, k, d, width):
    x, c = planted_ties(n, k, d, width)
    assert -(-k // width) > 1
    labels, best = _sliced_assign(torch.from_numpy(x), torch.from_numpy(c), width)
    ref_labels, ref_best = assign_ref(torch.from_numpy(x), torch.from_numpy(c))
    assert torch.equal(labels, ref_labels) and torch.equal(best, ref_best)
    assert (best[::3] == 0).all()
    # first index of the minimum, as the JAX package's Pallas kernel gives it
    j_labels, j_best = kd_ops.assign(jnp.asarray(x), jnp.asarray(c),
                                     use_pallas=True, interpret=True)
    np.testing.assert_array_equal(labels.numpy(), np.asarray(j_labels))
    np.testing.assert_array_equal(best.numpy(), np.asarray(j_best))


@pytest.mark.parametrize("n,k,d,slots", [(16000, 1024, 9, 924), (16000, 8192, 9, 924),
                                         (16000, 8192, 9, 528), (8001, 1000, 130, 1584),
                                         (64, 16, 9, 924), (10 ** 6, 8192, 9, 924),
                                         (1, 1, 1, 1), (33, 65, 33, 1)])
def test_slice_width_fills_the_card(n, k, d, slots):
    """Slices cover k, fit the register design's shared memory, fill the
    resident blocks about once where one wave can hold the grid, and the
    general design's slices are whole 64-centroid panels."""
    width = pt_ops.slice_width(n, k, d, slots)
    slices = -(-k // width)
    reg = d <= pt_ops.MAX_REG_DIM
    tiles = -(-n // (pt_ops.REG_ROWS if reg else pt_ops.TILE_ROWS))
    assert 1 <= width and (slices - 1) * width < k <= slices * width
    if reg:
        assert width <= pt_ops.KS_MAX
    else:
        assert width % pt_ops.PANEL == 0
    least = -(-k // pt_ops.KS_MAX) if reg else 1
    waves = -(-tiles * least // slots)          # the fewest the slices allow
    assert -(-tiles * slices // slots) == waves
    if reg and waves * slots // tiles <= k:
        assert tiles * slices > waves * slots / 2   # the waves are mostly full


def test_assign_tie_takes_smallest_index():
    x = torch.zeros((3, 4))
    c = torch.tensor([[1.0, 0, 0, 0], [0, 1.0, 0, 0], [0, 0, 0, 1.0]])
    labels, best = pt_ops.assign(x, c)
    assert labels.tolist() == [0, 0, 0]
    assert best.tolist() == [1.0, 1.0, 1.0]


@pytest.mark.parametrize("bad", ["rank", "width", "dtype", "mixed"])
def test_wrappers_reject_bad_inputs(bad):
    x, c = torch.zeros((8, 3)), torch.zeros((4, 3))
    if bad == "rank":
        x = torch.zeros(8)
    elif bad == "width":
        c = torch.zeros((4, 5))
    elif bad == "dtype":
        x, c = x.double(), c.double()
    else:
        c = c.to(torch.bfloat16)
    for fn in (pt_ops.pairwise_sq_dists, pt_ops.assign):
        with pytest.raises((ValueError, TypeError)):
            fn(x, c)


def test_cpu_path_launches_no_kernel():
    before = dict(pt_ops.LAUNCHES)
    x, c = _inputs(32, 8, 9)
    pt_ops.pairwise_sq_dists(torch.from_numpy(x), torch.from_numpy(c))
    pt_ops.assign(torch.from_numpy(x), torch.from_numpy(c))
    assert pt_ops.LAUNCHES == before


def test_cuda_device_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


# -- the build (with a stand-in compiler: this machine has no nvcc) ------------

def _fake_nvcc(tmp_path, monkeypatch, exit_code):
    """Put an ``nvcc`` on PATH that writes its ``-o`` file (or fails)."""
    bindir = tmp_path / "bin"
    bindir.mkdir()
    script = bindir / "nvcc"
    script.write_text(f"""#!{sys.executable}
import sys
args = sys.argv[1:]
if {exit_code}:
    print("error: stand-in failure")
    sys.exit({exit_code})
open(args[args.index("-o") + 1], "w").write("lib")
print("ptxas info    : Used 40 registers")
""")
    script.chmod(0o755)
    monkeypatch.setenv("PATH", f"{bindir}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")


def test_build_compiles_once_and_caches(tmp_path, monkeypatch):
    _fake_nvcc(tmp_path, monkeypatch, 0)
    assert "kmeans_distance" in _build.sources()
    first = _build.build_all()["kmeans_distance"]
    assert not first["cached"] and "Used 40 registers" in first["log"]
    assert first["path"].endswith(".so") and os.path.exists(first["path"])
    again = _build.build_all(["kmeans_distance"])["kmeans_distance"]
    assert again["cached"] and again["path"] == first["path"]
    # one library and one log per CUDA source of the package, nothing else
    n_sources = len(_build.sources())
    assert sorted(p.suffix for p in (tmp_path / "build").iterdir()) == \
        [".log"] * n_sources + [".so"] * n_sources


def test_build_failure_raises(tmp_path, monkeypatch):
    _fake_nvcc(tmp_path, monkeypatch, 2)
    with pytest.raises(RuntimeError, match="stand-in failure"):
        _build.build_all()
    assert list((tmp_path / "build").iterdir()) == []
    with pytest.raises(KeyError):
        _build.build_all(["no_such_kernel"])
