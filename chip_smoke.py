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
* ``kernel-K3`` — kernel K3 (``flash_attention``) held against its plain
  version ``mha_ref`` at the serving shape of Qwen2-0.5B (bf16 and f32)
  and a ragged one, with CUDA-event times beside the bound and SDPA;
* ``lm-parity`` — full-width Qwen2-0.5B in float32: prefill logits and
  greedy tokens of the model on the card (through K3) against the same
  model on the CPU (plain versions);
* ``serve`` — the LM serving path end to end (requests -> Broker ->
  ThreadedStreamingEngine -> ``torch://`` pilot -> prefill + greedy
  decode) at full width in bf16: 32 requests of 1,024 tokens, 8 new each;
* ``serve-alone`` — one such micro-batch generated in the main thread,
  without the engine, for comparison;
* ``serve-profile`` — a shorter serve run under ``torch.profiler``;

then each phase's seconds, the ``{"kernels": [...]}`` summary, the
``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``.  Exits non-zero, without that last line,
when no card is present, when run outside a checkout of the repository, or
when any phase fails.  Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import dataclasses
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
# LM path: Qwen2-0.5B at full width (src/repro_torch/configs/qwen2_0_5b.py)
LM_ARCH = "qwen2-0.5b"
FA_SOURCE = "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"
FA_REPLACES = "src/repro/kernels/flash_attention/kernel.py:77"
FA_SERVING = (4 * 14, 4 * 2, 1_024, 64)          # (BH, BKV, S, Dh) of a 4 x 1,024 prefill
FA_SHAPES = [FA_SERVING + ("bfloat16",), FA_SERVING + ("float32",),
             (6, 3, 1_000, 40, "float32"), (6, 3, 1_000, 40, "bfloat16")]
# f32: tests/test_kernels.py:64's 2e-5.  bf16: K3 and mha_ref both compute in
# f32 from the same bf16 inputs and round the output to bf16 once, so they
# may differ by one bf16 step (2**-7 of the value) where the f32 results
# straddle a rounding boundary; atol covers their ~1e-6 f32 differences
# near 0.  Tighter than the CPU parity test's 3e-2 against JAX.
FA_TOLERANCE = {"float32": {"rtol": 2e-5, "atol": 2e-5},
                "bfloat16": {"rtol": 8e-3, "atol": 1e-4}}
BF16_OPS_PER_S = 989e12                           # H100 SXM dense bf16 tensor cores
PARITY_PROMPT, PARITY_NEW = 100, 8                # ragged against K3's 64-row tile
# f32 on card and CPU sum in other orders (and K3's online softmax against
# mha_ref's) through 24 layers; random-weight logits are O(1)
LM_PARITY_TOL = 1e-3
# 8 new tokens, not 32: each decode step is host-bound (~60 ms alone, ~190 ms
# under two consumer threads), and 32 took 24 s of the run
SERVE_REQUESTS, SERVE_PROMPT, SERVE_NEW = 32, 1_024, 8
SERVE_PARTITIONS, SERVE_BATCH = 2, 4
PROFILE_REQUESTS, PROFILE_NEW = 8, 8


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


def reset_counts() -> None:
    """Set every kernel's launch count to 0."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.kmeans_distance import ops as kd_ops

    for counts in (kd_ops.LAUNCHES, fa_ops.LAUNCHES):
        for name in counts:
            counts[name] = 0


def fa_bound(bh: int, bkv: int, s: int, dh: int, bytes_per_el: int):
    """(least ms, what bounds it, ms of the same operations at the f32
    CUDA-core rate) of causal GQA attention: q, k, v read once and the
    output written once at the HBM rate, against the two products over the
    S (S + 1) / 2 unmasked (query, key) pairs of each q row (2 Dh operations
    each for QK^T and for PV, a multiply-add counted as 2) at the peak of
    the input type (bf16 tensor cores; f32 CUDA cores, since 2e-5 is beyond
    TF32)."""
    t_bytes = (2 * bh + 2 * bkv) * s * dh * bytes_per_el / HBM_BYTES_PER_S
    ops = 2.0 * bh * s * (s + 1) * dh
    t_ops = ops / (BF16_OPS_PER_S if bytes_per_el == 2 else F32_OPS_PER_S)
    by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops) * 1e3, by, ops / F32_OPS_PER_S * 1e3


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
    from repro_torch.kernels.flash_attention import ops as fa_ops

    emit({"phase": "build", "kernel": "flash_attention",
          "dynamic_smem_bytes": {f"dh{dh}": fa_ops.smem_bytes(dh) for dh in (40, 64, 128)}})
    names = " ".join(k["symbol"] for k in kernels)
    missing = [n for n in ("pairwise_sq_dists_kernel", "assign_kernel",
                           "flash_attention_kernel") if n not in names]
    if missing:
        raise RuntimeError(f"expected {missing} in the build, got {names}")
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
    reset_counts()
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


def device_time_rows(prof) -> list[dict]:
    """Device self time by kernel from a ``torch.profiler`` run, largest first."""
    rows = []
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        if us > 0:
            rows.append({"name": ev.key[:96], "calls": ev.count, "device_ms": us / 1e3})
    rows.sort(key=lambda r: -r["device_ms"])
    return rows


def phase_profile(torch, smi: str) -> dict:
    """Where the device time of the Mini-App path goes: the stream phase at
    1,024 centroids, shorter, under ``torch.profiler``.  The device's busy
    share is its summed self time over the run's wall time (one stream, so
    kernels do not overlap)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run = phase_stream(torch, MODEL_SIZES[0], smi, PROFILE_MESSAGES, "profiled-stream")
    rows = device_time_rows(prof)
    device_ms = sum(r["device_ms"] for r in rows)
    out = {"phase": "profile", "centroids": MODEL_SIZES[0], "messages": PROFILE_MESSAGES,
           "wall_ms": run["wall_s"] * 1e3,
           "device_ms": device_ms if rows else "not measured",
           "device_busy_share": device_ms / (run["wall_s"] * 1e3) if rows else "not measured",
           "top": rows[:12], "card": smi}
    emit(out)
    return out


def phase_kernel_k3(torch, smi: str) -> dict:
    """K3 against ``mha_ref`` on the same inputs, with times."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import mha_ref

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    results, failed = {}, []
    for bh, bkv, s, dh, dtype_name in FA_SHAPES:
        dtype = getattr(torch, dtype_name)
        tol = FA_TOLERANCE[dtype_name]
        q = torch.randn((bh, s, dh), generator=gen, device=dev).to(dtype)
        k = torch.randn((bkv, s, dh), generator=gen, device=dev).to(dtype)
        v = torch.randn((bkv, s, dh), generator=gen, device=dev).to(dtype)
        got = fa_ops.flash_attention(q, k, v)
        want = mha_ref(q, k, v)
        torch.cuda.synchronize()
        ok = bool(torch.allclose(got.float(), want.float(), **tol))
        bound_ms, by, f32_core_ms = fa_bound(bh, bkv, s, dh, q.element_size())
        sdpa = torch.nn.functional.scaled_dot_product_attention
        q4, k4, v4 = q[None], k[None], v[None]       # head h reads kv head h // G
        row = {"phase": "kernel-K3", "bh": bh, "bkv": bkv, "s": s, "dh": dh,
               "dtype": dtype_name, "ok": ok, "tolerance": tol,
               "max_abs_err": float((got.float() - want.float()).abs().max()),
               "ms": cuda_ms(torch, lambda: fa_ops.flash_attention(q, k, v)),
               "plain_ms": cuda_ms(torch, lambda: mha_ref(q, k, v)),
               "library_ms": cuda_ms(torch, lambda: sdpa(q4, k4, v4, is_causal=True,
                                                         enable_gqa=True)),
               "bound_ms": bound_ms, "bound_by": by, "f32_core_ms": f32_core_ms,
               "card": smi}
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        emit(row)
        results[(bh, bkv, s, dh, dtype_name)] = row
        if not ok:
            failed.append((bh, bkv, s, dh, dtype_name))
        del q, k, v, got, want, q4, k4, v4
        torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"K3 disagrees with mha_ref at {failed}")
    return results


def _greedy_with_logits(torch, M, params, cfg, prompt, n_new):
    """Greedy tokens and the fp32 logits each was chosen from (prefill's
    first), through the model's prefill and decode steps."""
    S = prompt.shape[1]
    logits, caches = M.prefill(params, cfg, prompt, S + n_new)
    steps = [logits.float().cpu()]
    toks = [torch.argmax(logits, dim=-1)]
    for i in range(n_new - 1):
        logits, caches = M.decode_step(params, cfg, toks[-1], caches, S + i)
        steps.append(logits.float().cpu())
        toks.append(torch.argmax(logits, dim=-1))
    return torch.stack(toks, dim=1).cpu(), steps


def phase_lm_parity(torch, smi: str) -> dict:
    """Full-width Qwen2-0.5B in float32, one weight set: the model on the
    card (prefill attention = K3) against the same model on the CPU (the
    plain versions).  A token mismatch fails unless the CPU's top-2 logit
    gap at that step is under the tolerance (a near tie)."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models import model as M

    torch.backends.cuda.matmul.allow_tf32 = False     # full f32 products, stated
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_config(LM_ARCH), dtype="float32")
    # one generator seed on the card gives both copies the same weights
    params = {d: M.init_params(cfg, torch.Generator(device=DEVICE).manual_seed(SEED), d)
              for d in (DEVICE, "cpu")}
    prompt = np.random.default_rng([SEED, 3]).integers(0, cfg.vocab_size, (1, PARITY_PROMPT))
    before = fa_ops.LAUNCHES["flash_attention"]
    with torch.inference_mode():
        gpu_toks, gpu_logits = _greedy_with_logits(
            torch, M, params[DEVICE], cfg, torch.from_numpy(prompt).to(DEVICE), PARITY_NEW)
        k3_launches = fa_ops.LAUNCHES["flash_attention"] - before
        cpu_toks, cpu_logits = _greedy_with_logits(
            torch, M, params["cpu"], cfg, torch.from_numpy(prompt), PARITY_NEW)
    gpu_toks, cpu_toks = gpu_toks[0].tolist(), cpu_toks[0].tolist()
    diffs, gaps, verdict = [], [], "equal"
    for i, (a, b) in enumerate(zip(gpu_toks, cpu_toks)):
        top2 = torch.topk(cpu_logits[i][0], 2).values
        gaps.append(float(top2[0] - top2[1]))
        diffs.append(float((gpu_logits[i] - cpu_logits[i]).abs().max()))
        if a != b:          # later steps see different tokens: stop comparing
            verdict = "near-tie" if gaps[i] < LM_PARITY_TOL else "mismatch"
            break
    out = {"phase": "lm-parity", "arch": LM_ARCH, "dtype": "float32",
           "params": sum(t.numel() for t in params["cpu"].parameters()),
           "prompt": PARITY_PROMPT, "new_tokens": PARITY_NEW, "tolerance": LM_PARITY_TOL,
           "prefill_logits_max_abs_diff": diffs[0], "step_logits_max_abs_diff": diffs,
           "cpu_top2_gaps": gaps, "tokens_card": gpu_toks, "tokens_cpu": cpu_toks,
           "tokens": verdict, "k3_launches": k3_launches, "card": smi}
    out["ok"] = (diffs[0] <= LM_PARITY_TOL and verdict != "mismatch"
                 and k3_launches == cfg.n_layers and max(diffs) <= LM_PARITY_TOL)
    emit(out)
    del params
    torch.cuda.empty_cache()
    if not out["ok"]:
        raise AssertionError("the model on the card and on the CPU disagree")
    return out


def phase_serve(torch, smi: str, params, requests: int = SERVE_REQUESTS,
                new_tokens: int = SERVE_NEW, phase: str = "serve") -> dict:
    """The LM serving path at full width in bf16; every count set to 0 just
    before and read just after."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch.serve import serve

    cfg = get_config(LM_ARCH)
    prompts = np.random.default_rng([SEED, 4]).integers(
        0, cfg.vocab_size, (requests, SERVE_PROMPT))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    res = serve(cfg, params, prompts, new_tokens=new_tokens, partitions=SERVE_PARTITIONS,
                batch_max=SERVE_BATCH, device=DEVICE)
    launches = fa_ops.LAUNCHES["flash_attention"]
    peak = torch.cuda.max_memory_allocated()
    lat = [x * 1e3 for x in res.lpx_s]
    n_batches = len(res.batches)
    out = {"phase": phase, "arch": LM_ARCH, "dtype": cfg.dtype, "requests": requests,
           "prompt": SERVE_PROMPT, "new_tokens": new_tokens,
           "partitions": SERVE_PARTITIONS, "batch_max": SERVE_BATCH,
           "answered": res.processed, "abandoned": res.abandoned,
           "retried": res.retried, "failed_batches": res.failed_batches,
           "wall_s": res.wall_s, "req_per_s": res.req_per_s,
           "generated_tokens_per_s": res.tokens_per_s,
           "lpx_ms": {"p50": float(np.percentile(lat, 50)),
                      "p95": float(np.percentile(lat, 95)), "max": max(lat)},
           "micro_batches": n_batches, "batch_sizes": [n for n, _, _ in res.batches],
           "prefill_ms_per_micro_batch": 1e3 * float(np.mean([p for _, p, _ in res.batches])),
           "decode_ms_per_step": 1e3 * float(np.mean([d for _, _, d in res.batches]))
           / max(1, new_tokens - 1),
           "launches": {"flash_attention": launches},
           "max_memory_allocated_bytes": peak, "card": smi}
    emit(out)
    problems = []
    if res.processed != requests:
        problems.append(f"answered {res.processed}/{requests}")
    if not ((res.tokens >= 0) & (res.tokens < cfg.vocab_size)).all():
        problems.append("tokens missing or outside the vocabulary")
    if launches < cfg.n_layers * n_batches:
        problems.append(f"K3 launched {launches} < {cfg.n_layers} x {n_batches} times")
    if problems:
        raise AssertionError(f"{phase}: {problems}")
    return out


def phase_serve_alone(torch, smi: str, params) -> dict:
    """One micro-batch (SERVE_BATCH prompts of SERVE_PROMPT tokens) through
    prefill and greedy decode in this one thread, with no engine: the
    model's own time, beside which the serve phase's per-step times show
    what its consumer threads add."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import model as M

    cfg = get_config(LM_ARCH)
    prompts = torch.from_numpy(np.random.default_rng([SEED, 5]).integers(
        0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT))).to(DEVICE)
    with torch.inference_mode():
        M.greedy_generate(params, cfg, prompts, 2)              # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = M.prefill(params, cfg, prompts, SERVE_PROMPT + SERVE_NEW)
        first = torch.argmax(logits, dim=-1)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        toks = M.decode_greedy(params, cfg, first, caches, SERVE_PROMPT, SERVE_NEW)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    out = {"phase": "serve-alone", "batch": SERVE_BATCH, "prompt": SERVE_PROMPT,
           "new_tokens": SERVE_NEW, "prefill_ms": (t1 - t0) * 1e3,
           "decode_ms_per_step": (t2 - t1) * 1e3 / (SERVE_NEW - 1), "card": smi}
    emit(out)
    if tuple(toks.shape) != (SERVE_BATCH, SERVE_NEW):
        raise AssertionError(f"serve-alone: tokens of shape {tuple(toks.shape)}")
    return out


def serve_params(torch):
    """Full-width Qwen2-0.5B weights in bf16, drawn on the card from SEED."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import model as M

    return M.init_params(get_config(LM_ARCH),
                         torch.Generator(device=DEVICE).manual_seed(SEED), DEVICE)


def phase_serve_profile(torch, smi: str, params) -> dict:
    """Where the time of the serving path goes: a shorter serve run under
    ``torch.profiler``; device time by kernel, host self time by op, and the
    busy share = summed device self time over the run's wall time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run = phase_serve(torch, smi, params, PROFILE_REQUESTS, PROFILE_NEW,
                          "profiled-serve")
    rows = device_time_rows(prof)
    device_ms = sum(r["device_ms"] for r in rows)
    k3_ms = sum(r["device_ms"] for r in rows if "flash_attention_kernel" in r["name"])
    host = sorted(prof.key_averages(), key=lambda ev: -ev.self_cpu_time_total)
    wall_ms = run["wall_s"] * 1e3
    out = {"phase": "serve-profile", "requests": PROFILE_REQUESTS,
           "new_tokens": PROFILE_NEW, "wall_ms": wall_ms,
           "device_ms": device_ms if rows else "not measured",
           "device_busy_share": device_ms / wall_ms if rows else "not measured",
           "k3_device_ms": k3_ms if rows else "not measured",
           "top": rows[:16],
           "top_host": [{"name": ev.key[:96], "calls": ev.count,
                         "host_self_ms": ev.self_cpu_time_total / 1e3} for ev in host[:12]],
           "card": smi}
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
    seconds = {}

    def run(name, fn, *args):
        t0 = time.perf_counter()
        try:
            return fn(*args)
        except Exception:  # noqa: BLE001 — record, go on, and exit non-zero
            traceback.print_exc()
            failures.append(name)
            return None
        finally:
            seconds[name] = time.perf_counter() - t0

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
    k3 = run("kernel-K3", phase_kernel_k3, torch, device["nvidia_smi"])
    run("lm-parity", phase_lm_parity, torch, device["nvidia_smi"])
    lm_params = run("lm-init", serve_params, torch)
    serving = None
    if lm_params is not None:
        run("serve-alone", phase_serve_alone, torch, device["nvidia_smi"], lm_params)
        serving = run("serve", phase_serve, torch, device["nvidia_smi"], lm_params)
        run("serve-profile", phase_serve_profile, torch, device["nvidia_smi"], lm_params)
    emit({"phase": "seconds", **seconds})
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
    row = k3[FA_SERVING + ("bfloat16",)]
    bh, bkv, s, dh = FA_SERVING
    summary.append({
        "name": "flash_attention", "route": "cuda", "source": FA_SOURCE,
        "replaces": FA_REPLACES, "launches": serving["launches"]["flash_attention"],
        "max_abs_err": row["max_abs_err"], "ms": row["ms"], "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
        "library_ms": row["library_ms"], "f32_core_ms": row["f32_core_ms"],
        "shape": {"bh": bh, "bkv": bkv, "s": s, "dh": dh, "dtype": "bfloat16"}})
    emit({"kernels": summary})
    print(device["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": device["name"],
                                 "count": device["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
