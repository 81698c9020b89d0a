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
