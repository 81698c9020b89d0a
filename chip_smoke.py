#!/usr/bin/env python3
"""Bring-up check of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py        # from the repository root, on a machine with a CUDA card

Phases, each printing JSON lines on standard output:

* ``device`` — card name and count, ``nvidia-smi`` name and power limit,
  torch and CUDA versions;
* ``build``  — ``nvcc`` builds every CUDA source of the port for ``sm_90a``
  and reports each kernel's registers, shared memory and spills;
* ``kernel`` — kernels K1 (``pairwise_sq_dists``) and K2 (``assign``) held
  against their plain versions at the main path's shapes and a ragged one,
  with CUDA-event times beside the bound and a library yardstick;
* ``parity`` — 24 MiniBatch K-Means steps through the kernels and through
  the plain versions, both on the card;
* ``stream`` — the Mini-App end to end (producer -> Broker ->
  ThreadedStreamingEngine -> ``torch://`` pilot -> MiniBatch K-Means) at
  1,024 and 8,192 centroids, 200 messages of 16,000 x 9 points each;
* ``profile`` — a shorter stream run under ``torch.profiler``: device time
  by kernel and the device's busy share;

then the ``{"kernels": [...]}`` summary, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``.  Exits non-zero, without that last line,
when no card is present, when run outside a checkout of the repository, or
when any phase fails.  Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import threading
import time
import traceback
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
DEVICE = "cuda"
SEED = 0
N_POINTS, DIM = 16_000, 9             # paper message size (fig5) and dims (miniapp)
MODEL_SIZES = (1_024, 8_192)          # paper model sizes (fig6)
N_MESSAGES, PARTITIONS = 200, 4       # paper messages and partitions per cell
PARITY_STEPS = 24
PROFILE_MESSAGES = 50
N_CLUSTERS = 16
# H100 SXM published peaks (NVIDIA data sheet): HBM rate, f32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
SOURCE = "src/repro_torch/kernels/kmeans_distance/csrc/kmeans_distance.cu"
REPLACES = {"pairwise_sq_dists": "src/repro/kernels/kmeans_distance/kernel.py:57",
            "assign": "src/repro/kernels/kmeans_distance/kernel.py:102"}
KERNEL_SHAPES = [(N_POINTS, k, DIM, "float32") for k in MODEL_SIZES] + [
    (8_001, 1_000, 130, "float32"), (8_001, 1_000, 130, "bfloat16")]
TOLERANCE = {"float32": 1e-5, "bfloat16": 2e-2}   # tests/test_kernels.py's


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def clustered(rng: np.random.Generator, count: int) -> np.ndarray:
    """(count, N_POINTS, DIM) float32 points around N_CLUSTERS centers."""
    centers = rng.normal(size=(N_CLUSTERS, DIM)) * 3
    labels = rng.integers(0, N_CLUSTERS, (count, N_POINTS))
    noise = rng.standard_normal((count, N_POINTS, DIM))
    return (centers[labels] + noise).astype(np.float32)


def cuda_ms(torch, fn, iters: int = 30, warmup: int = 3) -> float:
    """Mean time of ``fn`` on the card, by CUDA events over ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(n: int, k: int, d: int, in_bytes_per_el: int, out_bytes: int,
          pair_ops: int):
    """(least ms, what bounds it): the larger of the inputs read once and the
    outputs written once at the HBM rate, and the function's f32 operations
    at the f32 peak, which counts a multiply-add as 2: 2*n*k*d for the dot
    products, 2*(n+k)*d for the norms, and ``pair_ops`` for each (point,
    centroid) pair (K1: add the norms, scale, subtract, clamp; K2 also
    compares)."""
    t_bytes = ((n + k) * d * in_bytes_per_el + out_bytes) / HBM_BYTES_PER_S
    ops = 2.0 * n * k * d + 2.0 * (n + k) * d + pair_ops * n * k
    t_ops = ops / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


# -- phases ----------------------------------------------------------------------

def phase_device(torch) -> dict:
    smi = nvidia_smi_line()
    print(smi, flush=True)
    info = {"phase": "device", "name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
            "capability": list(torch.cuda.get_device_capability(0)),
            "nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
            "python": sys.version.split()[0]}
    emit(info)
    return info


def phase_build() -> dict:
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    built = _build.build_all()
    seconds = time.perf_counter() - t0
    kernels = []
    for stem, info in built.items():
        current = None
        for line in info["log"].splitlines():
            if m := re.search(r"Compiling entry function '(\w+)'", line):
                current = {"source": stem, "symbol": m.group(1)}
                kernels.append(current)
            elif current and (m := re.search(
                    r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
                current["spill_stores"], current["spill_loads"] = map(int, m.groups())
            elif current and (m := re.search(r"Used (\d+) registers", line)):
                current["registers"] = int(m.group(1))
                sm = re.search(r"(\d+) bytes smem", line)
                current["smem_bytes"] = int(sm.group(1)) if sm else 0
    emit({"phase": "build", "seconds": seconds, "flags": list(_build.NVCC_FLAGS),
          "sources": {s: {"path": str(Path(i["path"]).relative_to(ROOT)),
                          "cached": i["cached"], "seconds": i["seconds"]}
                      for s, i in built.items()},
          "kernels": kernels})
    names = " ".join(k["symbol"] for k in kernels)
    if "pairwise_sq_dists_kernel" not in names or "assign_kernel" not in names:
        raise RuntimeError(f"expected both kernels in the build, got {names}")
    return {"seconds": seconds, "kernels": kernels}


def phase_kernels(torch) -> dict:
    from repro_torch.kernels.kmeans_distance import ops, ref

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    results = {}
    failed = []
    for n, k, d, dtype_name in KERNEL_SHAPES:
        dtype = getattr(torch, dtype_name)
        tol = TOLERANCE[dtype_name]
        x = torch.randn((n, d), generator=gen, device=dev).to(dtype)
        c = torch.randn((k, d), generator=gen, device=dev).to(dtype)
        want = ref.pairwise_sq_dists_ref(x, c)
        got = ops.pairwise_sq_dists(x, c)
        labels, best = ops.assign(x, c)
        ref_labels, ref_best = ref.assign_ref(x, c)
        torch.cuda.synchronize()
        picked = want.gather(1, labels.long()[:, None])[:, 0]
        k1_ok = bool(torch.allclose(got, want, rtol=tol, atol=tol * d))
        k2_ok = bool(torch.allclose(best, ref_best, rtol=tol, atol=tol * d)
                     and torch.allclose(picked, ref_best, rtol=tol, atol=tol * d))
        es = x.element_size()
        k1_bound, k1_by = bound(n, k, d, es, n * k * 4, pair_ops=4)
        k2_bound, k2_by = bound(n, k, d, es, n * 8, pair_ops=5)
        library_ms = None
        if dtype == torch.float32:
            library_ms = cuda_ms(torch, lambda: torch.cdist(
                x, c, compute_mode="use_mm_for_euclid_dist"))
        row = {
            "phase": "kernel", "n": n, "k": k, "d": d, "dtype": dtype_name,
            "tolerance": {"rtol": tol, "atol": tol * d},
            "pairwise_sq_dists": {
                "ok": k1_ok, "max_abs_err": float((got - want).abs().max()),
                "bit_equal": bool(torch.equal(got, want)),
                "ms": cuda_ms(torch, lambda: ops.pairwise_sq_dists(x, c)),
                "plain_ms": cuda_ms(torch, lambda: ref.pairwise_sq_dists_ref(x, c)),
                "library_ms": library_ms, "bound_ms": k1_bound, "bound_by": k1_by},
            "assign": {
                "ok": k2_ok, "max_abs_err": float((best - ref_best).abs().max()),
                "label_mismatches": int((labels != ref_labels).sum()),
                "ms": cuda_ms(torch, lambda: ops.assign(x, c)),
                "plain_ms": cuda_ms(torch, lambda: ref.assign_ref(x, c)),
                "library_ms": None, "bound_ms": k2_bound, "bound_by": k2_by},
        }
        emit(row)
        results[(n, k, d, dtype_name)] = row
        if not (k1_ok and k2_ok):
            failed.append((n, k, d, dtype_name))
        del x, c, want, got, labels, best, ref_labels, ref_best, picked
        torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"kernel disagrees with its plain version at {failed}")
    return results


def phase_parity(torch) -> dict:
    from repro_torch.kernels.kmeans_distance import ref
    from repro_torch.models import kmeans

    dev = torch.device(DEVICE)
    rng = np.random.default_rng([SEED, 1])
    k = MODEL_SIZES[0]
    c0 = (3.0 * rng.standard_normal((k, DIM))).astype(np.float32)
    counts0 = np.zeros(k, np.float32)
    msgs = clustered(rng, PARITY_STEPS)
    fast = kmeans.state_from_numpy(c0, counts0, device=dev)
    plain = kmeans.state_from_numpy(c0, counts0, device=dev)
    for pts_np in msgs:
        pts = torch.from_numpy(pts_np).to(dev)
        fast = kmeans.minibatch_step(fast, pts)
        d2 = ref.pairwise_sq_dists_ref(pts, plain.centroids)
        plain = kmeans.update(plain, pts, torch.min(d2, dim=1).indices)
    fc, fn = kmeans.state_to_numpy(fast)
    pc, pn = kmeans.state_to_numpy(plain)
    ok = bool(np.allclose(fc, pc, rtol=1e-4, atol=1e-4) and np.array_equal(fn, pn)
              and np.isfinite(fc).all())
    out = {"phase": "parity", "steps": PARITY_STEPS, "n": N_POINTS, "k": k, "d": DIM,
           "ok": ok, "centroid_max_abs_diff": float(np.abs(fc - pc).max()),
           "counts_equal": bool(np.array_equal(fn, pn)),
           "bit_equal": bool(np.array_equal(fc, pc)),
           "counts_total": float(fn.sum())}
    emit(out)
    if not ok:
        raise AssertionError("kernel and plain MiniBatch runs disagree")
    return out


def phase_stream(torch, n_centroids: int, smi: str, n_messages: int = N_MESSAGES,
                 phase: str = "stream") -> dict:
    from repro_torch.core.metrics import MetricRegistry, new_run_id, percentile_summary
    from repro_torch.kernels.kmeans_distance import ops
    from repro_torch.models import kmeans
    from repro_torch.pilot.api import PilotComputeService, PilotDescription
    from repro_torch.streaming.broker import Broker
    from repro_torch.streaming.engine import ThreadedStreamingEngine, Workload

    data = clustered(np.random.default_rng([SEED, 2, n_centroids]), n_messages)
    pcs = PilotComputeService()
    pilot = pcs.submit_pilot(PilotDescription(resource="torch://",
                                              attrs={"device": DEVICE}))
    broker = Broker()
    broker.create_topic("points", PARTITIONS)
    gen = torch.Generator(device=pilot.device).manual_seed(SEED)
    state = kmeans.init_state(n_centroids, DIM, generator=gen, device=pilot.device,
                              scale=3.0)
    # inertia of each message under the model before its update (the model's
    # quality on data it has not seen): falls as the stream is learned
    pre_inertia = []
    model_lock = threading.Lock()

    def process(msgs):
        nonlocal state
        for m in msgs:
            pts = torch.from_numpy(m.value).to(pilot.device)
            with model_lock:
                pre_inertia.append(kmeans.inertia(pts, state.centroids))
                state = kmeans.minibatch_step(state, pts)

    metrics = MetricRegistry()
    run_id = new_run_id(f"chip-smoke-k{n_centroids}")
    engine = ThreadedStreamingEngine(broker, "points", pilot,
                                     Workload(fn=process, name="kmeans"),
                                     metrics, run_id, batch_max=1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for name in ops.LAUNCHES:
        ops.LAUNCHES[name] = 0
    engine.start()
    t0 = time.perf_counter()
    try:
        for i in range(n_messages):
            ts = time.perf_counter()
            broker.append("points", data[i], ts=ts, run_id=run_id,
                          msg_id=f"{run_id}/{i}", size_bytes=data[i].nbytes)
            metrics.record(run_id, "broker", "append", ts, msg_id=f"{run_id}/{i}")
        engine.drain(n_messages, timeout=600)
    finally:
        engine.stop()
        pcs.close()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    torch.cuda.synchronize()
    inertia = torch.stack(pre_inertia).cpu().numpy()
    centroids, counts = kmeans.state_to_numpy(state)
    lat = percentile_summary(metrics.latencies(run_id, "append", "complete"))
    out = {"phase": phase, "centroids": n_centroids, "points": N_POINTS, "dim": DIM,
           "partitions": PARTITIONS, "batch_max": 1,
           "processed": engine.core.processed, "expected": n_messages,
           "abandoned": engine.core.abandoned, "retried": engine.core.retried,
           "wall_s": wall, "msgs_per_s": metrics.throughput(run_id, "complete"),
           "lpx_ms": {q: lat[q] * 1e3 for q in ("p50", "p95", "max")},
           "inertia_first": float(inertia[0]), "inertia_last": float(inertia[-1]),
           "launches": launches,
           "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
           "card": smi}
    emit(out)
    problems = []
    if engine.core.processed != n_messages:
        problems.append(f"processed {engine.core.processed}/{n_messages}")
    if not inertia[-1] < inertia[0]:
        problems.append("inertia did not fall")
    if not (np.isfinite(centroids).all() and centroids.shape == (n_centroids, DIM)):
        problems.append("centroids not finite or of the wrong shape")
    if counts.sum() != n_messages * N_POINTS:
        problems.append(f"counts sum to {counts.sum()}")
    for name, count in launches.items():
        if count < n_messages:
            problems.append(f"{name} launched {count} < {n_messages} times")
    if problems:
        raise AssertionError(f"{phase} at {n_centroids} centroids: {problems}")
    return out


def phase_profile(torch, smi: str) -> dict:
    """Where the device time of the Mini-App path goes: the stream phase at
    1,024 centroids, shorter, under ``torch.profiler``.  The device's busy
    share is its summed self time over the run's wall time (one stream, so
    kernels do not overlap)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run = phase_stream(torch, MODEL_SIZES[0], smi, PROFILE_MESSAGES, "profiled-stream")
    rows = []
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        if us > 0:
            rows.append({"name": ev.key[:96], "calls": ev.count, "device_ms": us / 1e3})
    rows.sort(key=lambda r: -r["device_ms"])
    device_ms = sum(r["device_ms"] for r in rows)
    out = {"phase": "profile", "centroids": MODEL_SIZES[0], "messages": PROFILE_MESSAGES,
           "wall_ms": run["wall_s"] * 1e3,
           "device_ms": device_ms if rows else "not measured",
           "device_busy_share": device_ms / (run["wall_s"] * 1e3) if rows else "not measured",
           "top": rows[:12], "card": smi}
    emit(out)
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs a CUDA card",
              file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "__init__.py").exists():
        print(f"chip_smoke: no src/repro_torch beside {Path(__file__).name}; run it "
              f"from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))

    failures = []

    def run(name, fn, *args):
        try:
            return fn(*args)
        except Exception:  # noqa: BLE001 — record, go on, and exit non-zero
            traceback.print_exc()
            failures.append(name)
            return None

    device = run("device", phase_device, torch)
    if device is None:
        return 1
    if run("build", phase_build) is None:
        return 1
    kernels = run("kernel", phase_kernels, torch)
    run("parity", phase_parity, torch)
    streams = {k: run(f"stream-{k}", phase_stream, torch, k, device["nvidia_smi"])
               for k in MODEL_SIZES}
    run("profile", phase_profile, torch, device["nvidia_smi"])
    if failures:
        print(f"chip_smoke: failed phases: {failures}", file=sys.stderr)
        return 1
    main_shape = kernels[(N_POINTS, MODEL_SIZES[0], DIM, "float32")]
    summary = []
    for name in ("pairwise_sq_dists", "assign"):
        row = main_shape[name]
        summary.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name],
            "launches": streams[MODEL_SIZES[0]]["launches"][name],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "shape": {"n": N_POINTS, "k": MODEL_SIZES[0], "d": DIM, "dtype": "float32"},
            "launches_k8192": streams[MODEL_SIZES[1]]["launches"][name]})
    emit({"kernels": summary})
    print(device["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": device["name"],
                                 "count": device["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
