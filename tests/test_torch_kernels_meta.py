"""The shape-only path of K3, K4 and their backwards on the meta device, and
``roofline.analysis.tree_local_bytes`` over sharded trees.

Inside a ``roofline.counter.CostCounter`` (the dry run's count) a meta call
of each wrapper returns the shapes and dtypes that the CPU plain version
returns on the same shapes, goes through the same ``autograd.Function`` (so
a backward reaches the backward wrapper), adds ``roofline.kernels``' work to
the counter, counts itself in ``kernel_calls`` and leaves every launch
counter as it was; it raises where the card's kernel refuses the shapes.
Outside a counter a meta tensor still raises (the existing ``match="no
kernel"`` tests in ``test_torch_flash_attention.py`` and
``test_torch_ssd_scan.py`` stay as they are).  ``tree_local_bytes`` of a
DTensor tree and of a ``TensorSpec`` tree under a fake process group equals
the reference's of the same shardings on a ``jax.sharding.AbstractMesh``.
``chip_smoke.py``'s bounds, which read ``roofline.kernels``' counts, keep
the values PERF.md's kernel table states at its shapes.  5.9 s on one CPU
worker (this file alone, imports included).
"""

import importlib.util
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh, AxisType, NamedSharding, PartitionSpec
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import distribute_tensor

from repro.roofline import analysis as JR
from repro_torch.distributed.sharding import placements
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.ssd_scan import ops as ssd
from repro_torch.launch.dryrun import fake_world
from repro_torch.launch.steps import TensorSpec
from repro_torch.roofline import kernels as K
from repro_torch.roofline.analysis import tree_local_bytes
from repro_torch.roofline.counter import CostCounter, active


def _counters():
    return (dict(fa.LAUNCHES), dict(fa.LSE_WRITES), dict(fa.BWD_ROUTES), dict(ssd.LAUNCHES),
            dict(ssd.STATES_KEPT))


def _meta(*tensors, grad=False):
    return [t.detach().to("meta").requires_grad_(grad) for t in tensors]


def _qkv(bh, bkv, s, dh, dtype):
    rng = np.random.default_rng(0)
    return [torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dtype)
            for shape in ((bh, s, dh), (bkv, s, dh), (bkv, s, dh))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh,bkv,s,dh,window", [(4, 2, 48, 16, 0), (6, 3, 40, 8, 7)])
def test_k3_forward_and_backward_on_meta_match_the_plain_shapes(bh, bkv, s, dh, window,
                                                                dtype):
    q, k, v = _qkv(bh, bkv, s, dh, dtype)
    want = fa.flash_attention(q, k, v, window=window)                  # CPU: mha_ref
    qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
    fa.flash_attention(qg, kg, vg, window=window).float().sum().backward()
    before = _counters()
    counter = CostCounter()
    with counter:
        assert active() is counter
        got = fa.flash_attention(*_meta(q, k, v), window=window)
        mq, mk, mv = _meta(q, k, v, grad=True)
        out = fa.flash_attention(mq, mk, mv, window=window)
        out.float().sum().backward()
    assert active() is None
    assert (got.device.type, got.shape, got.dtype) == ("meta", want.shape, want.dtype)
    assert (out.shape, out.dtype) == (want.shape, want.dtype)
    for m, cpu in ((mq, qg), (mk, kg), (mv, vg)):
        assert m.grad.device.type == "meta"
        assert (m.grad.shape, m.grad.dtype) == (cpu.grad.shape, cpu.grad.dtype)
    assert _counters() == before
    assert counter.kernel_calls == {"flash_attention": 2, "flash_attention_bwd": 1}
    el = q.element_size()
    fwd = K.flash_attention_work(bh, bkv, s, dh, el, window)
    fwd_lse = K.flash_attention_work(bh, bkv, s, dh, el, window, with_lse=True)
    bwd = K.flash_attention_bwd_work(bh, bkv, s, dh, el, window)
    assert counter.kernel_work["flash_attention"] == [fwd[0] + fwd_lse[0], fwd[1] + fwd_lse[1]]
    assert counter.kernel_work["flash_attention_bwd"] == list(bwd)
    assert fwd_lse[1] - fwd[1] == 4 * bh * s
    assert fwd[0] == 4.0 * bh * K.visible_pairs(s, window) * dh


def test_k3_on_meta_refuses_what_the_kernel_refuses():
    q, k, v = _meta(*_qkv(2, 1, 8, 8, torch.bfloat16))
    before = _counters()
    with CostCounter() as counter:
        with pytest.raises(ValueError, match="Dh"):
            big = torch.empty(2, 8, fa.MAX_HEAD_DIM + 1, device="meta")
            fa.flash_attention(big, big[:1], big[:1])
        with pytest.raises(ValueError, match="Dh"):
            big = torch.empty(2, 8, fa.MAX_BWD_HEAD_DIM + 1, device="meta")
            lse = torch.empty(2, 8, device="meta")
            fa.flash_attention_bwd(big, big[:1], big[:1], big, big, lse)
        with pytest.raises(ValueError, match="grid"):
            s = 65535 * 64 + 1                  # one 64-query tile past CUDA's grid.y
            long = torch.empty(1, s, 8, dtype=torch.bfloat16, device="meta")
            fa.flash_attention(long, long, long)
        with pytest.raises(ValueError, match="multiple"):
            fa.flash_attention(q, torch.cat([k, k, k]), torch.cat([v, v, v]))
        with pytest.raises(NotImplementedError):
            fa.flash_attention(q, k, v, causal=False)
        with pytest.raises(TypeError):
            fa.flash_attention(q.half(), k.half(), v.half())
    assert counter.kernel_calls == {} and _counters() == before
    # outside a count the meta path does not exist, for the backward too
    with pytest.raises(ValueError, match="runs on the card"):
        fa.flash_attention_bwd(q, k, v, q, q, torch.empty(2, 8, device="meta"))


def _ssd_inputs(b, s, h, p, n, with_h0):
    rng = np.random.default_rng(1)
    f = lambda *shape: torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))  # noqa: E731
    x, dt, Bm, Cm = f(b, s, h, p), torch.rand(b, s, h) * 0.1, f(b, s, n), f(b, s, n)
    A = -torch.rand(h) - 0.5
    return [x, dt, A, Bm, Cm, f(b, h, p, n) if with_h0 else None]


@pytest.mark.parametrize("b,s,h,p,n,chunk,with_h0", [(2, 32, 3, 8, 4, 16, False),
                                                     (1, 48, 2, 4, 8, 16, True)])
def test_k4_forward_and_backward_on_meta_match_the_plain_shapes(b, s, h, p, n, chunk, with_h0):
    x, dt, A, Bm, Cm, h0 = _ssd_inputs(b, s, h, p, n, with_h0)
    y, hT = ssd.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk, h0=h0)          # CPU: ssd_chunked
    grads_in = [t.clone().requires_grad_(True) for t in (x, dt, A, Bm, Cm)]
    h0g = None if h0 is None else h0.clone().requires_grad_(True)
    ys, hs = ssd.ssd_scan(*grads_in, chunk=chunk, h0=h0g)
    (ys.sum() + hs.sum()).backward()
    before = _counters()
    counter = CostCounter()
    with counter:
        my, mh = ssd.ssd_scan(*_meta(x, dt, A, Bm, Cm), chunk=chunk,
                              h0=None if h0 is None else _meta(h0)[0])
        metas = _meta(x, dt, A, Bm, Cm, grad=True)
        mh0 = None if h0 is None else _meta(h0, grad=True)[0]
        gy, gh = ssd.ssd_scan(*metas, chunk=chunk, h0=mh0)
        (gy.sum() + gh.sum()).backward()
    for got, want in ((my, y), (mh, hT), (gy, y), (gh, hT)):
        assert (got.device.type, got.shape, got.dtype) == ("meta", want.shape, want.dtype)
    for m, cpu in zip(metas + ([mh0] if h0 is not None else []),
                      grads_in + ([h0g] if h0 is not None else [])):
        assert (m.grad.device.type, m.grad.shape, m.grad.dtype) == (
            "meta", cpu.grad.shape, cpu.grad.dtype)
    assert _counters() == before
    assert counter.kernel_calls == {"ssd_scan": 2, "ssd_scan_bwd": 1}
    plain = K.ssd_scan_work(b, s, h, p, n, with_h0)
    kept = K.ssd_scan_work(b, s, h, p, n, with_h0, with_states=True)
    bwd = K.ssd_scan_bwd_work(b, s, h, p, n, True)          # the final state's cotangent given
    assert counter.kernel_work["ssd_scan"] == [plain[0] + kept[0], plain[1] + kept[1]]
    assert counter.kernel_work["ssd_scan_bwd"] == list(bwd)


def test_k4_on_meta_refuses_what_the_kernel_refuses():
    x, dt, A, Bm, Cm, _ = _meta(*_ssd_inputs(2, 32, 3, 8, 4, False)[:5], torch.zeros(1))
    before = _counters()
    with CostCounter() as counter:
        with pytest.raises(ValueError, match="exceeds"):
            big = torch.empty(2, 32, ssd.MAX_STATE + 1, device="meta")
            ssd.ssd_scan(x, dt, A, big, big, chunk=16)
        with pytest.raises(ValueError, match="multiple of the chunk"):
            ssd.ssd_scan(x[:, :20].contiguous(), dt[:, :20].contiguous(), A,
                         Bm[:, :20].contiguous(), Cm[:, :20].contiguous(), chunk=16)
        with pytest.raises(ValueError, match="states has shape"):
            states = torch.empty(6, 9, 8, 4, device="meta")
            ssd.ssd_scan_bwd(x, dt, A, Bm, Cm, x, states)
        with pytest.raises(TypeError):
            ssd.ssd_scan(x.double(), dt, A, Bm, Cm, chunk=16)
    assert counter.kernel_calls == {} and _counters() == before
    with pytest.raises(ValueError, match="run on the card"):
        ssd.ssd_scan_bwd(x, dt, A, Bm, Cm, x, torch.empty(6, 1, 8, 4, device="meta"))


# (shape, dtype, spec) leaves, every sharded dim dividing its mesh axes (the
# reference's shard_shape refuses a dim that does not divide)
LEAVES = {"w": ((64, 48), torch.bfloat16, ("data", "model")),
          "emb": ((96, 32), torch.bfloat16, ("model", None)),
          "batch": ((8, 16), torch.int32, (("data", "model"), None)),
          "moment": ((64, 48), torch.float32, (None, "model")),
          "scale": ((48,), torch.float32, (None,)),
          "step": ((), torch.int32, ())}
JAX_DTYPES = {torch.bfloat16: jax.numpy.bfloat16, torch.float32: jax.numpy.float32,
              torch.int32: jax.numpy.int32}


def _jax_tree(mesh_shape, axes):
    mesh = AbstractMesh(mesh_shape, axes, axis_types=(AxisType.Auto,) * len(axes))
    return {name: jax.ShapeDtypeStruct(shape, JAX_DTYPES[dtype],
                                       sharding=NamedSharding(mesh, PartitionSpec(*spec)))
            for name, (shape, dtype, spec) in LEAVES.items()}


@pytest.mark.parametrize("mesh_shape", [(2, 4), (4, 2)])
def test_tree_local_bytes_of_sharded_trees_equals_the_reference(mesh_shape):
    want = JR.tree_local_bytes(_jax_tree(mesh_shape, ("data", "model")))
    with fake_world(mesh_shape[0] * mesh_shape[1]):
        mesh = init_device_mesh("cpu", mesh_shape, mesh_dim_names=("data", "model"))
        specs = {name: TensorSpec(shape, dtype, placements(mesh, spec))
                 for name, (shape, dtype, spec) in LEAVES.items()}
        dtensors = {name: distribute_tensor(torch.empty(shape, dtype=dtype, device="meta"),
                                            mesh, specs[name].placements, src_data_rank=None)
                    for name, (shape, dtype, _) in LEAVES.items()}
        assert tree_local_bytes(specs, mesh) == want
        assert tree_local_bytes(dtensors) == want
        assert tree_local_bytes([dtensors, (specs,)], mesh) == 2 * want
        with pytest.raises(ValueError, match="mesh"):
            tree_local_bytes(specs)
        # a dim DTensor splits unevenly counts rank 0's shard, the largest
        # (ceil at each mesh dim, in mesh order); the reference refuses it
        odd = TensorSpec((7, 5), torch.float32, placements(mesh, (("data", "model"), None)))
        assert tree_local_bytes(odd, mesh) == 1 * 5 * 4
        d = distribute_tensor(torch.empty(7, 5, device="meta"), mesh, odd.placements,
                              src_data_rank=None)
        assert tuple(d.to_local().shape) == (1, 5) and tree_local_bytes(d) == 20
    assert not dist.is_initialized()


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# (bound function, arguments, ms, what bounds it): PERF.md's kernel table,
# bf16 K3 and its backward (Dh 64 and 256), f32 K4 and its backward on 3xTF32
BOUNDS = [("fa_bound", (56, 8, 1024, 64, 2), 0.007607, "operations"),
          ("fa_bwd_bound", (56, 8, 1024, 64, 2), 0.01902, "operations"),
          ("fa_bwd_bound", (40, 4, 1024, 256, 2), 0.05434, "operations"),
          ("ssd_bound", (4, 1024, 24, 64, 128, False), 0.02226, "operations"),
          ("ssd_bwd_bound", (4, 1024, 24, 64, 128, False), 0.05427, "operations")]


@pytest.mark.parametrize("fn,args,ms,by", BOUNDS)
def test_chip_smoke_bounds_keep_their_values(fn, args, ms, by):
    got = getattr(_chip_smoke(), fn)(*args)
    assert got[0] == pytest.approx(ms, rel=1e-3) and got[1] == by
