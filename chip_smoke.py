#!/usr/bin/env python3
"""Bring-up check of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py        # from the repository root, on a machine with a CUDA card

Phases, each printing JSON lines on standard output:

* ``device`` — card name and count, ``nvidia-smi`` name and power limit,
  torch and CUDA versions;
* ``build``  — ``nvcc`` builds every CUDA source of the port for ``sm_90a``
  and reports each kernel's registers, shared memory and spills;
* ``lint`` — the port's simlint (``repro_torch.analysis``) over this
  checkout, in an interpreter that loads neither jax, the JAX package nor
  torch: 0 findings, with files scanned, pragmas and seconds;
* ``kernel`` — kernels K1 (``pairwise_sq_dists``) and K2 (``assign``) held
  against their plain versions at the Mini-App's shapes and a ragged one,
  with CUDA-event times beside the bound (and its share), K1's write rate,
  K2's issue floor, each CUDA kernel's device time at the Mini-App's shapes
  and a library yardstick; then K2 on planted ties (equal distances in
  different k-slices, and exact hits), where the smaller index must win;
* ``parity`` — 24 MiniBatch K-Means steps through the kernels and through
  the plain versions, both on the card;
* ``stream`` — the Mini-App end to end (producer -> Broker ->
  ThreadedStreamingEngine -> ``torch://`` pilot -> MiniBatch K-Means) at
  1,024 and 8,192 centroids, 200 messages of 16,000 x 9 points each; K2
  launched twice a message (``inertia``, ``minibatch_step``) and K1 never;
* ``profile`` — a shorter stream run under ``torch.profiler``: device time
  by kernel and the device's busy share;
* ``stream-rate`` — the stream at 1,024 centroids, open loop: appends paced
  by the port's ``ConstantRate`` at half the msgs/s that ``stream`` read,
  with L^px and the broker's lag (the latency at a sustainable rate);
* ``lockwatch`` — the port's lock-order shim (``repro_torch.analysis.
  LockWatch``) installed, then the stream at 1,024 centroids, 50 messages,
  on ``torch://`` and on ``local://`` (units on the pilot's thread pool, K2
  on the card): the acquisition graph has lock traffic, no cycle and no
  cross-component wait, and holds each lock site the port's manifest
  registers; the shim comes off before the next phase;
* ``sim-cells`` — the simulated Mini-App (``repro_torch.core.miniapp``) on
  the grid of ``benchmarks/fig5_throughput.py``: serverless and wrangler,
  1-16 partitions, 1,024 and 8,192 centroids, 40 messages each, on the
  virtual clock (host only);
* ``sim-kmeans`` — three simulated cells at the paper's size (serverless
  and wrangler, 4 partitions, 16,000 x 9 points, 8,192 centroids, 200
  messages, and the serverless cell again under a crash, a preemption, a
  stall and a duplicate) whose per-message K-Means update runs on the card
  through K2 (``KMeansMessageUpdate``), under ``torch.profiler``: each
  message processed once, K2 twice a message and K1 never, the virtual
  record equal to the same cell run without the update, the inertia falling,
  and the final model and every message's inertia bit-equal to a replay of
  the logged payloads through the plain versions;
* ``characterize`` — ``repro_torch.launch.characterize``'s flow (the
  serverless/wrangler sweep and the wrangler policy ablation on the virtual
  clock, through the process pool) with every USL fit on the card: pooled
  records equal to serial ones, each fit, bootstrap CI and Fig-7 fit within
  ``USL_TOL`` of the port's numpy backend, each machine's recommended
  partitions equal; host seconds of the sweeps and the pool's start-up, fit
  ms on the card against numpy ms on the host;
* ``usl-batch`` — 64 scenarios x 7 levels fitted with 1,024 bootstrap
  resamples (65,536 rows in one batch) on the card and with numpy, the
  card's busy share under ``torch.profiler``, each quantity's worst
  deviation as a share of its limit;
* ``adapt`` — eight closed-loop cells on the virtual clock (serverless and
  wrangler x ``usl``/``usl_online``/``reactive``/``static``), each twice
  and equal, drained with nothing lost, ``usl`` no worse than ``reactive``,
  the counts the reference's; then one wall-clock cell on ``local://``;
* ``whatif`` — fig8's baseline tournament for serverless and wrangler (a
  characterization sweep and numpy fit each, 4 rate traces x usl/reactive/
  static, 120 s): every cell on the fast replay and equal to the scalar
  DES, fig8's claims on the step and burst traces; one federated cell of
  ``fed_design`` (the fast replay declines it) run twice, equal; the
  lockstep seed scans of the serverless step cell through their entry
  points on the card at 8 and 1,024 seeds (launches counted over this
  run), within ``LOCKSTEP_RTOL`` of the float64 replay; then both
  ``lockstep_scan`` kernels against their plain versions on the same
  operands, with CUDA-event times beside the plain loops', the bound and
  its share, the chain floor (the longest run of dependent steps x a
  step's max and add) and a sequential replay of the same seeds;
* ``kernel-K3`` — kernel K3 (``flash_attention``: bf16 on the tensor cores,
  f32 on them in 3xTF32) held against its plain version ``mha_ref`` at the
  prefill shape of every arch the run drives through it (Dh 64, 128 and
  RecurrentGemma-2B's 256 with its window), bf16 and f32, a ragged one,
  and where a window bites (Dh 256, window 2,048 at S 4,096; a window of
  100 on the ragged shape), with CUDA-event times beside the bound and
  SDPA (given the window as a boolean mask), the references computed with
  TF32 off;
* ``kernel-K3-bwd`` — K3's backward (``flash_attention_bwd.cu``: bf16 on
  wgmma with TMA tiles, four CUDA kernels a call; f32 on 3xTF32 mma.sync,
  three, or four where the G heads are spread over chunks) held against
  ``mha_bwd_ref`` (TF32 off) on the forward's own output and lse
  at Qwen2-0.5B's training shape, at Dh 128 (BH 160, BKV 32), with a
  window of 100 at a ragged S, and at RecurrentGemma-2B's training shape
  (Dh 256, G 10), bf16 and f32, twice (the same bits), with CUDA-event
  times beside the bound, the plain version's and SDPA's backward
  (``torch.autograd.grad`` on a kept graph), each CUDA kernel's device
  time, and the route taken (bf16 rows must take TMA's), before the serving
  phases (late in the run the profiler recorded none of its kernels);
* ``lm-parity`` — full-width Qwen2-0.5B in float32: prefill logits and
  greedy tokens of the model on the card (through K3) against the same
  model on the CPU (plain versions);
* ``serve`` — the LM serving path end to end (requests -> Broker ->
  ThreadedStreamingEngine -> ``torch://`` pilot -> prefill + greedy
  decode) at full width in bf16: 32 requests of 1,024 tokens, 8 new each;
* ``serve-alone`` — one such micro-batch generated in the main thread,
  without the engine, for comparison;
* ``serve-profile`` — a shorter serve run under ``torch.profiler``;
* ``arch-configs`` — GLM-4-9B, Qwen2.5-3B, InternVL2-1B and
  Qwen3-235B-A22B (128 experts, top-8; ~12.4 GB of bf16 weights at 2
  layers, ~470 GB at its 94) at their published widths, cut to 2 layers,
  bf16: one prefill of 4 x 1,024 tokens (InternVL2's first 256 positions
  taking patch embeddings drawn from the seed) and 8 greedy tokens; finite
  logits, tokens in the vocabulary, K3 once a layer;
* ``lm-parity-14b`` and ``lm-parity-musicgen`` — ``lm-parity`` for
  Qwen2.5-14B at full width, its first 4 of 48 layers (the host's float32
  copy at full depth would need 59 GB), and for MusicGen-Medium at full
  width and depth, a 300-token prompt whose first 256 positions take frame
  embeddings drawn from the seed, with sinusoidal positions;
* ``serve-alone-14b``, ``serve-14b`` and ``serve-profile-14b`` — the three
  serving phases for Qwen2.5-14B at full width and depth in bf16 (29.5 GB
  of weights), whose prefill runs K3 at Dh 128;
* ``lm-parity-recurrentgemma``, ``serve-alone-recurrentgemma``,
  ``serve-recurrentgemma`` and ``serve-profile-recurrentgemma`` — the same
  four phases for RecurrentGemma-2B at full width and depth (~5.3 GB of
  bf16 weights), whose 8 local-attention layers run K3 at Dh 256 with the
  2,048 window and whose 18 RG-LRU layers scan in plain torch; the profile
  gives the scan's device time;
* ``lm-parity-granite``, ``serve-alone-granite``, ``serve-granite`` and
  ``serve-profile-granite`` — the same for Granite-3.0-3B-A800M (~6.6 GB),
  32 MoE layers of 40 experts, top-8: the parity phase counts the (layer,
  token) top-k choices that differ between card and CPU and the CPU's
  smallest top-k gap, and the profile gives the device time of routing,
  dispatch, the expert GEMMs and the combine;
* ``kernel-K4`` — kernel K4 (``ssd_scan``, three CUDA kernels a call) held
  against its plain version ``ssd_ref`` (and a float64 run of it) at the
  prefill shape of Mamba2-130M, a ragged length, with an initial state, and
  across several spans with a ragged last one and an initial state, with
  CUDA-event times beside the bound and the worst error's share of the
  tolerance; at the prefill shape also each of its CUDA kernels' device
  time;
* ``kernel-K4-bwd`` — K4's backward (``ssd_scan_bwd.cu``, three CUDA
  kernels a call, 3xTF32 on the tensor cores) held against ``ssd_bwd_ref``
  and float64 autograd of ``ssd_ref`` on the forward's own span states at
  Mamba2-130M's training microbatch (also with heads decaying fast), a
  ragged length across spans with h0 and the final state's cotangent, and
  N 256, twice (the same bits), with CUDA-event times beside the bound, the
  plain version's and autograd of ``ssd_chunked`` on the card, each CUDA
  kernel's device time (none may be missing) and their sum beside the
  call's event time, and the worst error's share of each tolerance;
* ``lm-parity-mamba``, ``serve-alone-mamba``, ``serve-mamba`` and
  ``serve-profile-mamba`` — the same four phases for full-width
  Mamba2-130M, whose prefill runs K4 (every serve phase also checks that
  serving wrote no lse, kept no K4 span states and ran no backward);
* ``train-parity`` and ``train-parity-mamba`` — full-width Qwen2-0.5B and
  Mamba2-130M cut to 2 layers, float32, 2 x 256 tokens: the loss and every
  gradient leaf on the card (K3 or K4 and their backward kernels) against
  the CPU;

every training phase runs the configs' registered remat (``cfg.remat``
``"full"``: each ``block_pattern`` group's forward is recomputed in the
backward, so a kernel in a checkpointed layer launches its forward twice a
microbatch and its backward once; ``forward_launches``);

* ``train-qwen2`` and ``train-mamba2`` — ``launch.train`` on full-width
  Qwen2-0.5B and Mamba2-130M (24 layers each, bf16, 8 x 1,024 tokens a
  step in 2 microbatches): 30 steps with a checkpoint at 20, then a restart
  from it that redoes steps 20-29; the loss falls, the restart is
  bit-exact, K3 (K4) forward launches 96 times a step and its backward 48;
  ms a step, tok/s, peak allocated bytes; then, from the trained weights,
  a profiled step under ``none`` and one under ``full`` (after an
  unprofiled ``none`` step that grows the allocator's pool): each one's
  wall ms, device ms by family (the kernel's forward and backward, GEMMs,
  the rest) and the host's top ops;
* ``train-recurrentgemma`` — ``launch.train`` on RecurrentGemma-2B at full
  width and depth (26 layers, bf16, 4 x 1,024 tokens a step in 2
  microbatches, 8 steps): the loss falls, K3 forward launches 32 times a
  step and its backward 16, every backward on the TMA route; ms a step,
  tok/s, peak allocated bytes;
* ``train-remat`` — one step of 4 x 1,024 tokens in 2 microbatches at
  published width, bf16, from the same weights and batch under each of
  ``cfg.remat`` ``none``, ``dots`` and ``full``: Granite-3.0-3B-A800M and
  Mamba2-130M at 4 layers, RecurrentGemma-2B at 5 (one group and the
  unwrapped tail), Qwen2.5-3B, InternVL2-1B and MusicGen-Medium at 2; the
  loss, every updated parameter and both moments ``torch.equal`` across
  the three, K3's and K4's launches as the policy gives them, the step's
  peak allocated bytes under each and the activation bytes a layer;
* ``train-full-depth`` — ``launch.train`` at published width and depth
  under ``full``, 8 steps of 4 x 1,024 tokens in 2 microbatches:
  Granite-3.0-3B-A800M (32 layers), Qwen2.5-3B (36, K3 at Dh 128),
  InternVL2-1B (24, 256 patch embeddings) and MusicGen-Medium (48, 256
  frame embeddings); the first loss near log V, the loss falling, finite
  nonzero gradient norms, K3's launches, the peak under 80 GB, tok/s, ms a
  step, and the estimated peak under ``none`` (never run);

* ``pad-mesh`` — configs padded by the port's ``pad_for_mesh`` (heads,
  KV heads, vocab and experts; PAD_MESH_F32): at published width in f32,
  2 layers (RecurrentGemma-2B 5), each padded model holding the unpadded
  model's weights and random pad slots, a prefill of 2 x 1,024 tokens and
  4 decode steps with logits within LM_PARITY_TOL of the unpadded model's
  and the pad logits -1e30, and one ``build_train`` step whose loss is
  within 1e-5 of the unpadded model's and whose gradient is exactly 0 on
  every pad slot (K3 and its backward at G 7, 8, 10 and 16, Dh 64 and
  256); K3 forward and backward at those head groups in bf16 and f32 with
  dO zero on the pad heads (their dq and the dk, dv of KV heads serving
  only them exactly 0), ms beside the unpadded shape's; Qwen2-0.5B padded
  for tp 8 with ``pad_kv`` (56 heads over 8) served at full depth in bf16
  beside the unpadded model (req/s, K3's launches, peak bytes, and one
  micro-batch's prefill in turns), with the phase's seconds;

the serve phases, ``train-qwen2``, ``train-mamba2`` and ``train-full-depth``
also print ``mfu``: ``roofline.analysis.model_flops`` (6·N·D a training
step, 2·N·D a served token, N the logical parameters, attention's score
FLOPs left out) over the seconds at the bf16 peak, ``HW["peak_flops"]``;
every peak a bound uses is read from ``HW``;

then each phase's seconds, the ``{"kernels": [...]}`` summary, the
``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``.  Exits non-zero, without that last line,
when no card is present, when run outside a checkout of the repository, or
when any phase fails.  Imports nothing of JAX or of the JAX package.

``python3 chip_smoke.py --compare-parent DIR`` runs only ``whatif``'s four
lockstep kernel rows (both scans at 8 and 1,024 seeds) of the checkout at
DIR (e.g. a ``git archive`` of the parent commit) and of this one, in turns
(parent, change, change, parent), each with its own ``chip_smoke.py`` and
package, and holds every output of the two checkouts on the same operands
bit for bit; then, in turns again, K3's f32 rows (``K3_COMPARE_FWD`` and
``K3_COMPARE_BWD``) with each package: each row's ms and worst share of its
tolerance in every turn, and the bf16 forward's and backward's outputs at
the same shapes, which must keep their bits.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import os
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
SPIN_MS_PER_CALL, SPIN_HZ = 0.2, 1.98e9      # cuda_ms's head start for the host; H100 SXM boost clock
PROFILE_MESSAGES = 50
# lockwatch: the stream at 1,024 centroids, 50 messages, on each pilot
# (torch:// runs units inline, local:// on its thread pool), under the
# port's lock-order shim
LOCKWATCH_MESSAGES, LOCKWATCH_RESOURCES = 50, ("torch://", "local://")
# the fig5 grid (benchmarks/fig5_throughput.py), and the card-carrying cells
SIM_GRID = [dict(machine=m, partitions=n, points=N_POINTS, centroids=c, n_messages=40,
                 seed=3) for m in ("serverless", "wrangler") for c in MODEL_SIZES
            for n in (1, 2, 4, 8, 16)]
SIM_KMEANS = dict(partitions=PARTITIONS, points=N_POINTS, centroids=MODEL_SIZES[1],
                  memory_mb=3008, n_messages=N_MESSAGES, seed=3)
SIM_FAULTS = dict(events=[dict(t=30.0, kind="crash"), dict(t=60.0, kind="preempt"),
                          dict(t=90.0, kind="stall", target=1, duration_s=20.0),
                          dict(t=120.0, kind="duplicate", target=2)])
SIM_KMEANS_CELLS = [("serverless", None), ("wrangler", None), ("serverless", SIM_FAULTS)]
# StreamInsight: the card's USL fits against the port's numpy fits (T(N)
# relative, sigma and kappa absolute, gamma and a peak_N CI bound relative)
USL_TOL = {"t_rtol": 1e-6, "sigma": 1e-6, "kappa": 1e-7, "gamma_rtol": 1e-6,
           "peak_rtol": 1e-6}
USL_LEVELS = np.array([1, 2, 4, 8, 16, 32, 64], dtype=np.float64)   # tests/test_usl.py's
USL_SCENARIOS, USL_BOOTSTRAP, REPORT_BOOTSTRAP = 64, 1_024, 1_000
ADAPT_POLICIES = ("usl", "usl_online", "reactive", "static")
ADAPT_CELL = dict(horizon_s=120.0, seed=0, points=N_POINTS, centroids=MODEL_SIZES[0])
# (violating ticks, ticks) of these cells in the reference package
ADAPT_REFERENCE = {("serverless", "usl"): (6, 60), ("serverless", "reactive"): (43, 70),
                   ("wrangler", "usl"): (349, 381), ("wrangler", "reactive"): (456, 490)}
# tests/test_adaptation.py's wall-clock cell (THREADED_KNOBS, its step trace)
THREADED_CELL = dict(machine="serverless", engine="threaded", scaling_policy="usl",
                     rate=dict(kind="step", base_hz=5.0, high_hz=40.0, t_step=4.0),
                     horizon_s=10.0, control_interval_s=0.5, slo_lag=24,
                     initial_partitions=1, max_partitions=6, static_partitions=6,
                     catchup_horizon_s=2.0, stabilization_s=3.0, seed=0,
                     usl_sigma=0.02, usl_kappa=1e-4, usl_gamma=20.0)
# fig8's baseline tournament (benchmarks/fig8_adaptation.py:226-246) at its
# own sizes: per machine a characterization sweep (partitions 1-16, 8,000
# points, 1,024 centroids, 60 messages; numpy fits), then 4 rate traces x
# (usl, reactive, static), 120 s, max_partitions 16, slo_lag 32, seed 0
WHATIF_SCENARIOS = {
    "serverless": dict(policy=None, base_hz=2.0, high_hz=12.0, diurnal_mean_hz=6.0,
                       burst_hz=10.0),
    "wrangler": dict(policy="update_locked", base_hz=1.0, high_hz=6.0, diurnal_mean_hz=3.0,
                     burst_hz=7.0)}
WHATIF_PARTITIONS = [1, 2, 4, 8, 12, 16]
WHATIF_BASE = dict(horizon_s=120.0, max_partitions=16, slo_lag=32)
# fig8's fed_design "federated" scenario (serverless + wrangler members, the
# serverless member out for 25 s at 45 s), seed 0
FED_MEMBER_KNOBS = {"serverless": dict(price=1.0, grant_latency_s=0.0),
                    "wrangler": dict(price=0.6, grant_latency_s=10.0)}
FED_CELL = dict(machine="federated", policy="update_locked", scaling_policy="usl", seed=0,
                rate=dict(kind="step", base_hz=2.0, high_hz=8.0, t_step=20.0), horizon_s=120.0,
                control_interval_s=2.0, initial_partitions=2, max_partitions=8, points=2000,
                centroids=256, max_retries=12, retry_backoff_s=0.1,
                faults=dict(events=[dict(t=45.0, kind="backend_outage", target=0,
                                         duration_s=25.0)]))
# the lockstep seed scans of the serverless step cell: the grid scan of its
# usl cell and the chain of the same trace at one static partition
LOCKSTEP_SEEDS = (8, 1_024)
LOCKSTEP_TOL = 1e-5     # kernel against plain: the chain's expf against torch.exp
LOCKSTEP_SOURCE = "src/repro_torch/kernels/lockstep_scan/csrc/lockstep_scan.cu"
LOCKSTEP_REPLACES = {"lockstep_scan": "src/repro/sim/batched.py:1559",
                     "grid_lockstep_scan": "src/repro/sim/batched.py:1698"}
# the scans' carried chain: a step's FMNMX.NAN then its FADD (counted in the
# walkers' SASS, `cuobjdump -sass` of the built library), each ~4 cycles of
# dependent latency on Hopper's FP32 pipes
LOCKSTEP_CARRIED, CYCLES_PER_DEPENDENT = 2, 4
N_CLUSTERS = 16
SIM_CENTERS = 3 * np.random.default_rng([SEED, DIM]).standard_normal((N_CLUSTERS, DIM))
SOURCE = "src/repro_torch/kernels/kmeans_distance/csrc/kmeans_distance.cu"
REPLACES = {"pairwise_sq_dists": "src/repro/kernels/kmeans_distance/kernel.py:57",
            "assign": "src/repro/kernels/kmeans_distance/kernel.py:102"}
KERNEL_SHAPES = [(N_POINTS, k, DIM, "float32") for k in MODEL_SIZES] + [
    (8_001, 1_000, 130, "float32"), (8_001, 1_000, 130, "bfloat16")]
TOLERANCE = {"float32": 1e-5, "bfloat16": 2e-2}   # tests/test_kernels.py's
# LM paths at full width: Qwen2-0.5B (src/repro_torch/configs/qwen2_0_5b.py)
# and Qwen2.5-14B (.../qwen2_5_14b.py), whose prefills run K3 at Dh 64 and
# 128, and Mamba2-130M (.../mamba2_130m.py), which runs K4
DENSE_ARCH, LARGE_ARCH, SSM_ARCH = "qwen2-0.5b", "qwen2.5-14b", "mamba2-130m"
# RecurrentGemma-2B (.../recurrentgemma_2b.py: RG-LRU layers and local
# attention at Dh 256, window 2,048) and Granite-3.0-3B-A800M
# (.../granite_moe_3b_a800m.py: 40 experts, top-8) at full width and depth
HYBRID_ARCH, MOE_ARCH = "recurrentgemma-2b", "granite-moe-3b-a800m"
# the other configs at full width and 2 layers: one prefill and greedy decode;
# Qwen3-235B-A22B's 94 layers hold ~470 GB of bf16 weights, its 2 ~12.4 GB
ARCH_CONFIGS, ARCH_LAYERS, ARCH_NEW = ("glm4-9b", "qwen2.5-3b", "internvl2-1b",
                                       "qwen3-moe-235b-a22b"), 2, 8
# Qwen2.5-14B's parity: a float32 copy on the card and one on the host at
# full depth would need 59 GB of host RAM, so its first 4 layers (10.6 GB)
PARITY_14B_LAYERS = 4
# MusicGen-Medium's parity at full depth: 256 prefix embeddings (its
# n_prefix) and 44 tokens after them
MUSICGEN_ARCH, MUSICGEN_PROMPT = "musicgen-medium", 300
FA_SOURCE = "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"
FA_REPLACES = "src/repro/kernels/flash_attention/kernel.py:77"
FA_SERVING = (4 * 14, 4 * 2, 1_024, 64)          # (BH, BKV, S, Dh) of a 4 x 1,024 prefill
# Dh 128: the same prefill of Qwen2.5-14B (40 heads, 8 KV; its serving path)
FA_SERVING_14B = (4 * 40, 4 * 8, 1_024, 128)
# Dh 256: RecurrentGemma-2B's (10 heads, 1 KV, window 2,048; BH, BKV, S, Dh, window)
FA_SERVING_RG = (4 * 10, 4 * 1, 1_024, 256, 2_048)
# K3 is held against mha_ref at the prefill shape (and window) of every arch
# whose 4 x 1,024 prefill the run drives through it (fa_shapes), in both
# dtypes, at a ragged Dh-40 shape, and where a window bites: RecurrentGemma's
# Dh 256 and window 2,048 at S 4,096 (its 40 prefill rows), and a small
# window on the ragged shape.  Rows are (BH, BKV, S, Dh, window, dtype).
FA_PREFILL_ARCHS = (DENSE_ARCH, LARGE_ARCH, HYBRID_ARCH, MOE_ARCH) + ARCH_CONFIGS
FA_RAGGED = [(6, 3, 1_000, 40, 0, "float32"), (6, 3, 1_000, 40, 0, "bfloat16")]
FA_WINDOWED = [(40, 4, 4_096, 256, 2_048, "bfloat16"), (40, 4, 4_096, 256, 2_048, "float32"),
               (6, 3, 1_000, 40, 100, "bfloat16"), (6, 3, 1_000, 40, 100, "float32")]
# f32: tests/test_kernels.py:64's 2e-5 (K3's f32 kernel computes each
# product in 3xTF32, a_hi b_hi + a_lo b_hi + a_hi b_lo with each operand
# split into two TF32 parts, which keeps ~21 bits of each operand, and sums
# in f32; one TF32 product would miss 2e-5 by ~60x).  bf16: K3 multiplies
# the bf16 inputs exactly on the tensor cores with f32 sums, and splits P
# into two bf16 parts (hi and lo) for PV, which keeps ~16 bits of each
# probability, so it and mha_ref both compute in f32 up to summation order
# and round the output to bf16 once: they may differ by one bf16 step
# (2**-7 of the value) where the f32 results straddle a rounding boundary;
# atol covers their ~1e-5 f32 differences near 0.  A single bf16 P (~2**-9
# per probability) was not what this was set for.  Tighter than the CPU
# parity test's 3e-2 against JAX.
FA_TOLERANCE = {"float32": {"rtol": 2e-5, "atol": 2e-5},
                "bfloat16": {"rtol": 8e-3, "atol": 1e-4}}
PARITY_PROMPT, PARITY_NEW = 100, 8                # ragged against K3's 64-row tile
# f32 on card and CPU sum in other orders (and K3's online softmax against
# mha_ref's) through 24 layers; random-weight logits are O(1)
LM_PARITY_TOL = 1e-3
# an MoE router's top-k is a discontinuity: where the card's and the CPU's
# f32 gates straddle the k-th and (k+1)-th expert, the two pick different
# experts.  Such flips are expected where the CPU's gap between them is near
# the f32 noise of the gates; more than ROUTE_FLIPS_MAX flips at gaps above
# ROUTE_FLIP_MARGIN fail the phase
ROUTE_FLIP_MARGIN, ROUTE_FLIPS_MAX = 1e-5, 3
# 8 new tokens, not 32: each decode step is host-bound (~60 ms alone, ~190 ms
# under two consumer threads), and 32 took 24 s of the run
SERVE_REQUESTS, SERVE_PROMPT, SERVE_NEW = 32, 1_024, 8
SERVE_PARTITIONS, SERVE_BATCH = 2, 4
PROFILE_REQUESTS, PROFILE_NEW = 8, 8
SSD_SOURCE = "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu"
SSD_REPLACES = "src/repro/kernels/ssd_scan/kernel.py:75"
SSD_Q = 64                                        # K4's own chunk length
SSD_SERVING = (4, 1_024, 24, 64, 128)             # (batch, S, H, P, N) of a 4 x 1,024 prefill
SSD_SHAPES = [(SSD_SERVING, False), ((1, 100, 24, 64, 128), False),
              ((2, 256, 24, 64, 128), True),      # ragged against SSD_Q; with h0
              ((2, 700, 24, 64, 128), True)]      # 2 x 256 + 188: spans, ragged, h0
SSD_CHUNK = 256                                   # Mamba2-130M's ssm_chunk
SSD_TOL = 2e-4                                    # tests/test_kernels.py:96-99's
# K4's backward (no TPU kernel: the reference's XLA differentiates its
# ssd_chunked, src/repro/models/ssm.py:88).  Rows ((batch, S, H, P, N), h0 and
# the final state's cotangent given, A scale): Mamba2-130M's training
# microbatch (4 x 1,024, as in training: no h0, no dh), the same with heads
# decaying fast (A x 4, tests/test_torch_kernels_cuda.py's seed-3 case), a
# ragged S across spans with h0 and dh, and N 256 (MAX_STATE) across spans.
# Tolerance (rtol, atol as a share of each gradient's largest entry):
# against ssd_bwd_ref (f32, the kernels' decomposition) 1e-4, against float64
# autograd of ssd_ref SSD_TOL (tests/test_torch_ssd_scan.py's)
SSD_BWD_SOURCE = "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan_bwd.cu"
SSD_BWD_REPLACES = "src/repro/models/ssm.py:88"
SSD_BWD_SHAPES = [(SSD_SERVING, False, 1.0), (SSD_SERVING, False, 4.0),
                  ((2, 700, 24, 64, 128), True, 1.0), ((1, 1_024, 24, 64, 256), True, 1.0)]
SSD_BWD_TOL = 1e-4
SSD_GRADS = ("dx", "ddt", "dA", "dB", "dC", "dh0")
# K3's backward (no TPU kernel: the reference's XLA differentiates its
# model's attend, src/repro/models/attention.py:194).  Rows (BH, BKV, S, Dh,
# window, dtype): Qwen2-0.5B's training shape (a microbatch of 4 x 1,024),
# Qwen2.5-14B's heads at Dh 128, and a window of 100 at a ragged S of 1,000
# (whole 64-key tiles masked for most rows), and RecurrentGemma-2B's training
# shape (10 heads, 1 KV, Dh 256, its 2,048 window past S), each in bf16 and f32
FA_BWD_SOURCE = "src/repro_torch/kernels/flash_attention/csrc/flash_attention_bwd.cu"
FA_BWD_REPLACES = "src/repro/models/attention.py:194"
FA_BWD_TRAIN = (4 * 14, 4 * 2, 1_024, 64, 0)
FA_BWD_TRAIN_RG = (4 * 10, 4 * 1, 1_024, 256, 2_048)
FA_BWD_SHAPES = [sh + (dt,) for sh in (FA_BWD_TRAIN, (4 * 40, 4 * 8, 1_024, 128, 0),
                                       (14, 2, 1_000, 64, 100), FA_BWD_TRAIN_RG)
                 for dt in ("bfloat16", "float32")]
# each CUDA kernel of a backward call, by dtype: D, dK/dV, the G-chunks' sum
# (where the heads are spread over more than one chunk), dQ
FA_BWD_KERNELS = {"bfloat16": ("fa_bwd_delta_kernel", "fa_bwd_dkdv_bf16_kernel",
                               "fa_bwd_sum_kernel", "fa_bwd_dq_bf16_kernel"),
                  "float32": ("fa_bwd_delta_kernel", "fa_bwd_dkdv_f32_kernel",
                              "fa_bwd_sum_kernel", "fa_bwd_dq_f32_kernel")}
# (rtol, atol as a share of the largest entry), tests/test_torch_kernels_cuda.py's
# FA_BWD_TOL: f32 the forward's 2e-5, atol scaled since dk and dv sum S·G
# products in another order; bf16 one bf16 step (the kernel computes in f32
# up to summation order, P and dS entering the products as hi/lo bf16
# pairs, and both round once), atol for the f32 differences near 0
FA_BWD_TOLERANCE = {"float32": (2e-5, 2e-5), "bfloat16": (8e-3, 1e-4)}
# --compare-parent's K3 rows (BH, BKV, S, Dh, window): kernel-K3's four f32
# shapes (Qwen2-0.5B's, Qwen2.5-14B's and RecurrentGemma-2B's prefill, the
# window at S 4,096) and kernel-K3-bwd's four f32 shapes
K3_COMPARE_FWD = [FA_SERVING + (0,), FA_SERVING_14B + (0,), FA_SERVING_RG, FA_WINDOWED[1][:5]]
K3_COMPARE_BWD = [sh[:5] for sh in FA_BWD_SHAPES if sh[5] == "float32"]
# training: full-width Qwen2-0.5B, 24 layers, bf16, SyntheticLM at 8 x 1,024
# tokens a step in 2 microbatches, AdamW with f32 moments; 30 steps with a
# checkpoint at step 20, then a restart from it that redoes steps 20-29
TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICRO = DENSE_ARCH, 8, 1_024, 2
TRAIN_STEPS, TRAIN_CKPT = 30, 20
# train-parity: the same config cut to 2 layers in f32, 2 x 256 tokens, card
# against CPU within tests/test_torch_training.py's gradient tolerance
# (each leaf max|d| <= 1e-4 max|g_cpu| + 1e-6) and its loss rtol 1e-5
TRAIN_PARITY_LAYERS, TRAIN_PARITY_BATCH, TRAIN_PARITY_SEQ = 2, 2, 256
# train-remat: one make_train_step step at published width, bf16, seed 0, 4 x
# 1,024 tokens in 2 microbatches, from the same parameters and batch under
# each policy of cfg.remat: Granite (MoE and K3) and Mamba2-130M (K4) at 4
# layers, RecurrentGemma-2B at 5 (one rglru, rglru, local_attn group and the
# unwrapped 2-layer rglru tail), and the other configs train-full-depth
# trains at 2 layers (their activation bytes a layer, for the estimate of
# their full-depth peak under "none", which is never run)
REMAT_POLICIES = ("none", "dots", "full")
REMAT_ARCHS = {MOE_ARCH: 4, SSM_ARCH: 4, HYBRID_ARCH: 5, "qwen2.5-3b": 2,
               "internvl2-1b": 2, MUSICGEN_ARCH: 2}
REMAT_BATCH, REMAT_SEQ, REMAT_MICRO = 4, 1_024, 2
# train-full-depth: launch.train at published width and depth, bf16, seed
# 0, under the registered remat ("full"), 4 x 1,024 tokens a step in 2
# microbatches, no checkpoint (a 3B model's is ~31 GB of disk)
FULL_DEPTH_ARCHS = (MOE_ARCH, "qwen2.5-3b", "internvl2-1b", MUSICGEN_ARCH)
FULL_DEPTH_BATCH, FULL_DEPTH_SEQ, FULL_DEPTH_MICRO, FULL_DEPTH_STEPS = 4, 1_024, 2, 8
# their learning rate: the order of the published pretraining peak rates of
# 1-3B models; at launch.train's default 3e-3 (sized for the reduced
# configs, one warmup step at 8 steps) these widths' losses swing from step
# to step, and MusicGen-Medium's did not fall in 8
FULL_DEPTH_LR = 3e-4
CARD_BYTES = 80e9                                 # the H100's device memory
# train-recurrentgemma: full width and depth, bf16, 4 x 1,024 tokens a step
# in 2 microbatches, 8 steps
TRAIN_RG_BATCH, TRAIN_RG_SEQ, TRAIN_RG_MICRO, TRAIN_RG_STEPS = 4, 1_024, 2, 8
# pad-mesh: configs padded by the port's pad_for_mesh for a model axis of tp,
# (arch, tp, pad_kv, layers) at published width in f32: Qwen2-0.5B's 14
# heads over 2 KV heads to 16 over 2 (G 7 -> 8) and, with pad_kv, 56 over 8
# (G 7 kept); RecurrentGemma-2B's 10 over 1 to 16 over 1 (G 16) and, with
# pad_kv, 80 over 8 (G 10), Dh 256 and its 2,048 window, 5 layers (a
# group and the tail: 3 is no depth of its pattern with its 2-layer tail);
# InternVL2-1B's heads 14 -> 16 and vocab 151,655 -> 151,656; Granite's
# heads 24 -> 32, vocab 49,155 -> 49,168 and experts 40 -> 48.  Each padded
# model holds the unpadded model's weights and random pad slots: a prefill
# of PAD_BATCH x PAD_PROMPT tokens and PAD_NEW decode steps, logits within
# LM_PARITY_TOL of the unpadded model's; one training step, the loss within
# rtol PAD_LOSS_RTOL and every pad slot's gradient exactly 0
PAD_MESH_F32 = [(DENSE_ARCH, 8, False, 2), (DENSE_ARCH, 8, True, 2),
                (HYBRID_ARCH, 8, False, 5), (HYBRID_ARCH, 8, True, 5),
                ("internvl2-1b", 4, False, 2), (MOE_ARCH, 16, False, 2)]
PAD_BATCH, PAD_PROMPT, PAD_NEW, PAD_LOSS_RTOL = 2, 1_024, 4, 1e-5
# then Qwen2-0.5B padded for tp 8 with pad_kv at full depth in bf16, served
# as the serving cells are, beside the unpadded model
PAD_SERVE = (DENSE_ARCH, 8, True)
# and K3 forward and backward on padded heads in bf16 and f32 at the
# shapes the phase's models give it, dO zero on the pad heads: (heads,
# KV heads, padded heads, padded KV heads, Dh, window), B = PAD_BATCH
PAD_K3 = [(14, 2, 16, 2, 64, 0), (14, 2, 56, 8, 64, 0),
          (10, 1, 16, 1, 256, 2_048), (10, 1, 80, 8, 256, 2_048)]
# mfu: model_flops (6·N·D training, 2·N·D a forward token; N the logical
# parameters) over the seconds at the bf16 peak
MFU_NOTE = "6·N·D (2·N·D serving) leaves out attention's score FLOPs"


def peak(key: str) -> float:
    """An H100 SXM published peak from ``repro_torch.roofline.analysis.HW``,
    the one copy of them: ``hbm_bw`` (B/s), ``peak_flops`` (bf16 tensor
    cores), ``tf32_flops``, ``f32_flops`` (outside the tensor cores)."""
    from repro_torch.roofline.analysis import HW

    return HW[key]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def clustered(rng: np.random.Generator, count: int, n_points: int = N_POINTS,
              centers: np.ndarray | None = None) -> np.ndarray:
    """(count, n_points, DIM) float32 points around N_CLUSTERS centers, drawn
    from ``rng`` first unless they are given."""
    if centers is None:
        centers = rng.normal(size=(N_CLUSTERS, DIM)) * 3
    labels = rng.integers(0, N_CLUSTERS, (count, n_points))
    noise = rng.standard_normal((count, n_points, DIM))
    return (centers[labels] + noise).astype(np.float32)


def message_points(payload: dict) -> np.ndarray:
    """A simulated message's (n_points, DIM) points, rebuilt on the host from
    its ``{"n_points", "seed"}`` payload around the fixed SIM_CENTERS."""
    rng = np.random.default_rng(payload["seed"])
    return clustered(rng, 1, payload["n_points"], SIM_CENTERS)[0]


class KMeansMessageUpdate:
    """The real MiniBatch K-Means update as ``run_experiment``'s ``fn``: for
    each message, its inertia under the model before the update
    (``kmeans.inertia``), then ``kmeans.minibatch_step`` (K2 twice).  The
    payloads are logged in the order they were processed, for ``replay``."""

    def __init__(self, torch, n_centroids: int) -> None:
        from repro_torch.models import kmeans

        self.torch, self.kmeans = torch, kmeans
        gen = torch.Generator(device=DEVICE).manual_seed(SEED)
        self.initial = kmeans.init_state(n_centroids, DIM, generator=gen, device=DEVICE,
                                         scale=3.0)
        self.state = self.initial
        self.calls = 0
        self.payloads: list[dict] = []
        self.inertia: list = []

    def points(self, payload: dict):
        return self.torch.from_numpy(message_points(payload)).to(DEVICE)

    def __call__(self, msgs) -> None:
        self.calls += 1
        for m in msgs:
            pts = self.points(m.value)
            self.inertia.append(self.kmeans.inertia(pts, self.state.centroids))
            self.state = self.kmeans.minibatch_step(self.state, pts)
            self.payloads.append(m.value)

    def replay(self):
        """The logged payloads, in order, from the same initial model through
        the plain assignment ``assign_ref`` and the same update, on the card
        (so the update's matrix product sums in the same order).  Returns the
        model and each message's inertia, ``assign_ref``'s mean ``best``."""
        from repro_torch.kernels.kmeans_distance.ref import assign_ref

        state, inertia = self.initial, []
        for payload in self.payloads:
            pts = self.points(payload)
            labels, best = assign_ref(pts, state.centroids)
            inertia.append(best.mean())
            state = self.kmeans.update(state, pts, labels)
        return state, inertia


def cuda_ms(torch, fn, iters: int = 30, warmup: int = 3) -> float:
    """Mean time of ``fn`` on the card, by CUDA events over ``iters`` calls
    run back to back.  The card first spins for about SPIN_MS_PER_CALL a
    call, before the first event, while the host queues the calls: where a
    call's host time exceeds its kernels' (K1/K2 at 1,024 centroids on a
    busy host), the events then time the kernels and not the host's issue
    rate.  The spin itself is never inside the timed span."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(int(SPIN_MS_PER_CALL * 1e-3 * SPIN_HZ * iters))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _counters() -> tuple[dict, ...]:
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.kmeans_distance import ops as kd_ops
    from repro_torch.kernels.lockstep_scan import ops as ls_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops

    return kd_ops.LAUNCHES, fa_ops.LAUNCHES, ssd_ops.LAUNCHES, ls_ops.LAUNCHES


def reset_counts() -> None:
    """Set every kernel's launch count to 0 (and K3's count of forward
    launches that wrote lse, K4's of those that kept their span states)."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops

    for counts in (*_counters(), fa_ops.LSE_WRITES, fa_ops.BWD_ROUTES, ssd_ops.STATES_KEPT):
        for name in counts:
            counts[name] = 0


def training_work() -> dict:
    """What only training does, counted since the last ``reset_counts``:
    K3's backward launches and forward launches that wrote lse, K4's
    backward launches and forward launches that kept their span states."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops

    return {"flash_attention_bwd": launches("flash_attention_bwd"),
            "lse_writes": fa_ops.LSE_WRITES["flash_attention"],
            "ssd_scan_bwd": launches("ssd_scan_bwd"),
            "ssd_states_kept": ssd_ops.STATES_KEPT["ssd_scan"]}


def launches(kernel: str) -> int:
    """The launch count of the kernel named ``kernel``."""
    return next(c[kernel] for c in _counters() if kernel in c)


def visible_pairs(s: int, window: int = 0) -> int:
    """(query, key) pairs that causal attention over S positions sees, with
    a local ``window`` (0: none): min(i + 1, window) keys for query i."""
    if not window or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


def product_ms(ops: float, bytes_per_el: int) -> float:
    """ms of ``ops`` matrix-product operations at the rate of the input type
    on the tensor cores: bf16 at its peak; f32 in 3xTF32, three TF32
    products for each (the split that keeps f32 accuracy)."""
    return (ops / peak("peak_flops") if bytes_per_el == 2 else 3 * ops / peak("tf32_flops")) * 1e3


def fa_bound(bh: int, bkv: int, s: int, dh: int, bytes_per_el: int, window: int = 0):
    """(least ms, what bounds it, ms of the same operations at the f32
    CUDA-core rate) of causal GQA attention: q, k, v read once and the
    output written once at the HBM rate, against the two products over the
    unmasked (query, key) pairs of each q row (``visible_pairs``; 2 Dh
    operations each for QK^T and for PV, a multiply-add counted as 2) on the
    tensor cores (``product_ms``: bf16, or f32 in 3xTF32)."""
    t_bytes = (2 * bh + 2 * bkv) * s * dh * bytes_per_el / peak("hbm_bw") * 1e3
    ops = 4.0 * bh * visible_pairs(s, window) * dh
    t_ops = product_ms(ops, bytes_per_el)
    by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops), by, ops / peak("f32_flops") * 1e3


def bound(n: int, k: int, d: int, in_bytes_per_el: int, out_bytes: int,
          pair_ops: int):
    """(least ms, what bounds it): the larger of the inputs read once and the
    outputs written once at the HBM rate, and the function's f32 operations
    at the f32 peak, which counts a multiply-add as 2: 2*n*k*d for the dot
    products, 2*(n+k)*d for the norms, and ``pair_ops`` for each (point,
    centroid) pair (K1: add the norms, scale, subtract, clamp; K2 also
    compares)."""
    t_bytes = ((n + k) * d * in_bytes_per_el + out_bytes) / peak("hbm_bw")
    ops = 2.0 * n * k * d + 2.0 * (n + k) * d + pair_ops * n * k
    t_ops = ops / peak("f32_flops")
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def issue_floor_ms(n: int, k: int, d: int, pair_ops: int) -> float:
    """The least time the bit-equal arithmetic of K1/K2 can take: the
    operations that ``bound`` counts, each issued as its own instruction
    (products and sums unfused: a multiply-add is 2 instructions where the
    f32 peak counts one FMA), at one instruction per f32 lane per cycle,
    half the f32 peak."""
    ops = 2.0 * n * k * d + 2.0 * (n + k) * d + pair_ops * n * k
    return ops / (peak("f32_flops") / 2) * 1e3


def device_ms_by_kernel(torch, fn, kernels, calls: int = 10) -> dict:
    """Device ms a launch of each CUDA kernel named in ``kernels`` (matched
    as whole names) takes, from ``torch.profiler`` over ``calls`` calls of
    ``fn``, each of which launches each kernel once: the kernel's summed
    time divided by the launches of it that the profile recorded (it drops
    some late in a run, and the sum divided by ``calls`` then read low).  A
    kernel of which a session recorded no launch is profiled again, over
    twice the calls, up to three sessions; "not measured" only where none
    recorded it."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    out = {name: "not measured" for name in kernels}
    for attempt in range(3):
        missing = [name for name in kernels if out[name] == "not measured"]
        if not missing:
            break
        # CPU and CUDA both: late in a run, a CUDA-only session recorded no
        # kernel (every row 0.0), where sessions with both still did
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls << attempt):
                fn()
            torch.cuda.synchronize()
        rows = device_time_rows(prof)
        for name in missing:
            hits = [r for r in rows if re.search(rf"\b{name}\b", r["name"])]
            launched = sum(r["calls"] for r in hits)
            if launched:
                out[name] = sum(r["device_ms"] for r in hits) / launched
    return out


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


def phase_build(torch) -> dict:
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
    from repro_torch.kernels.ssd_scan import ops as ssd_ops

    emit({"phase": "build", "kernel": "flash_attention",
          "dynamic_smem_bytes": {
              name: {f"dh{dh}": fa_ops.smem_bytes(dh, dtype=getattr(torch, name))
                     for dh in (40, 64, 128, 256)} for name in ("float32", "bfloat16")}})
    emit({"phase": "build", "kernel": "flash_attention_bwd",
          "dynamic_smem_bytes": {
              name: {f"dh{dh}": fa_ops.bwd_smem_bytes(dh, dtype=getattr(torch, name))
                     for dh in (40, 64, 128, 256)} for name in ("float32", "bfloat16")}})
    emit({"phase": "build", "kernel": "ssd_scan",
          "dynamic_smem_bytes": {f"n{n}": ssd_ops.smem_bytes(n) for n in (16, 128, 256)}})
    names = " ".join(k["symbol"] for k in kernels)
    missing = [n for n in ("pairwise_sq_dists_kernel", "pairwise_sq_dists_tile_kernel",
                           "assign_kernel", "assign_tile_kernel", "assign_combine_kernel",
                           "flash_attention_kernel", "flash_attention_bf16_kernel",
                           "fa_bwd_delta_kernel", "fa_bwd_dq_f32_kernel",
                           "fa_bwd_dkdv_f32_kernel", "fa_bwd_dq_bf16_kernel",
                           "fa_bwd_dkdv_bf16_kernel", "fa_bwd_sum_kernel",
                           *(f"ssd_scan_{p}_kernel" for p in ssd_ops.PHASES),
                           *(f"ssd_bwd_{p}_kernel" for p in ssd_ops.BWD_PHASES),
                           "lockstep_chain_kernel", "grid_lockstep_kernel")
               if n not in names]
    if missing:
        raise RuntimeError(f"expected {missing} in the build, got {names}")
    return {"seconds": seconds, "kernels": kernels}


def phase_kernels(torch) -> dict:
    from repro_torch.kernels.kmeans_distance import ops, ref

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    results = {}
    failed = []
    before = dict(ops.LAUNCHES)
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
        k1 = {"ok": k1_ok, "max_abs_err": float((got - want).abs().max()),
              "bit_equal": bool(torch.equal(got, want)),
              "ms": cuda_ms(torch, lambda: ops.pairwise_sq_dists(x, c)),
              "plain_ms": cuda_ms(torch, lambda: ref.pairwise_sq_dists_ref(x, c)),
              "library_ms": library_ms, "bound_ms": k1_bound, "bound_by": k1_by}
        k1["share_of_bound"] = k1_bound / k1["ms"]
        k1["write_tb_per_s"] = n * k * 4 / (k1["ms"] * 1e-3) / 1e12
        k2 = {"ok": k2_ok, "max_abs_err": float((best - ref_best).abs().max()),
              "bit_equal": bool(torch.equal(best, ref_best) and torch.equal(labels, ref_labels)),
              "label_mismatches": int((labels != ref_labels).sum()),
              "ms": cuda_ms(torch, lambda: ops.assign(x, c)),
              "plain_ms": cuda_ms(torch, lambda: ref.assign_ref(x, c)),
              "library_ms": None, "bound_ms": k2_bound, "bound_by": k2_by,
              "issue_floor_ms": issue_floor_ms(n, k, d, pair_ops=5),
              "slices": -(-k // ops.assign_slice_width(n, k, d, x.dtype, x.device.index))}
        k2["share_of_bound"] = k2_bound / k2["ms"]
        if (n, d, dtype_name) == (N_POINTS, DIM, "float32"):
            # device time by CUDA kernel: ms above is a back-to-back call
            # rate, which the host's issue time sets where it exceeds the
            # kernels' own
            k1["device_ms"] = device_ms_by_kernel(
                torch, lambda: ops.pairwise_sq_dists(x, c), ("pairwise_sq_dists_kernel",))
            k2["device_ms"] = device_ms_by_kernel(
                torch, lambda: ops.assign(x, c), ("assign_kernel", "assign_combine_kernel"))
        row = {"phase": "kernel", "n": n, "k": k, "d": d, "dtype": dtype_name,
               "tolerance": {"rtol": tol, "atol": tol * d},
               "pairwise_sq_dists": k1, "assign": k2}
        emit(row)
        results[(n, k, d, dtype_name)] = row
        if not (k1_ok and k2_ok):
            failed.append((n, k, d, dtype_name))
        del x, c, want, got, labels, best, ref_labels, ref_best, picked
        torch.cuda.empty_cache()
    for case in ("ties-across-slices", "exact-hits"):
        row = planted_ties(torch, ops, ref, case)
        emit(row)
        if not row["ok"]:
            failed.append(case)
    if failed:
        raise AssertionError(f"kernel disagrees with its plain version at {failed}")
    results["launches"] = {name: ops.LAUNCHES[name] - before[name] for name in before}
    return results


def planted_ties(torch, ops, ref, case: str) -> dict:
    """K2 at the Mini-App's largest shape on small-integer points and
    centroids (every distance exact in f32).  ``ties-across-slices``: each
    k-slice's first centroid is copied to the end of the slice before it
    (equal distances in different slices); ``exact-hits``: every slice is
    a copy of the first and every third point a copy of a centroid (best 0,
    tied in every slice).  Passes when labels and best
    equal ``assign_ref``'s bit for bit and every label is the smallest index
    among its row's minima."""
    n, k, d = N_POINTS, MODEL_SIZES[1], DIM
    dev = torch.device(DEVICE)
    width = ops.assign_slice_width(n, k, d, torch.float32, torch.cuda.current_device())
    rng = np.random.default_rng([SEED, 6])
    c = rng.integers(-3, 4, (k, d)).astype(np.float32)
    x = rng.integers(-3, 4, (n, d)).astype(np.float32)
    if case == "ties-across-slices":
        for k0 in range(width, k, width):
            c[k0 - 1] = c[k0]
    else:
        c = c[np.arange(k) % width]
        x[::3] = c[rng.integers(0, k, x[::3].shape[0])]
    x, c = torch.from_numpy(x).to(dev), torch.from_numpy(c).to(dev)
    labels, best = ops.assign(x, c)
    ref_labels, ref_best = ref.assign_ref(x, c)
    d2 = ref.pairwise_sq_dists_ref(x, c)
    first = (d2 == d2.min(dim=1, keepdim=True).values).int().argmax(dim=1)
    torch.cuda.synchronize()
    tied = int(((d2 == d2.min(dim=1, keepdim=True).values).sum(dim=1) > 1).sum())
    hits = int((best == 0).sum())
    ok = bool(torch.equal(labels, ref_labels) and torch.equal(best, ref_best)
              and torch.equal(labels.long(), first))
    if case == "exact-hits":
        ok = ok and hits >= x.shape[0] // 3
    return {"phase": "kernel-ties", "case": case, "n": n, "k": k, "d": d,
            "slice_width": width, "slices": -(-k // width), "rows_with_ties": tied,
            "rows_at_zero": hits, "ok": ok,
            "label_mismatches": int((labels.long() != first).sum())}


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
                 phase: str = "stream", rate_hz: float | None = None,
                 resource: str = "torch://") -> dict:
    """The Mini-App stream at ``n_centroids``: every message appended at once,
    or, with ``rate_hz``, open loop at the port's ``ConstantRate(rate_hz)``.
    ``resource`` is ``torch://`` (units run inline on the card's pilot) or
    ``local://`` (units run on the pilot's thread pool, one a partition, and
    put their points on the card themselves)."""
    from repro_torch.core.metrics import MetricRegistry, new_run_id, percentile_summary
    from repro_torch.kernels.kmeans_distance import ops
    from repro_torch.models import kmeans
    from repro_torch.pilot.api import PilotComputeService, PilotDescription
    from repro_torch.streaming.broker import Broker
    from repro_torch.streaming.engine import ThreadedStreamingEngine, Workload
    from repro_torch.streaming.producer import ConstantRate

    data = clustered(np.random.default_rng([SEED, 2, n_centroids]), n_messages)
    program = ConstantRate(rate_hz) if rate_hz else None
    pcs = PilotComputeService()
    if resource == "torch://":
        pilot = pcs.submit_pilot(PilotDescription(resource=resource, attrs={"device": DEVICE}))
        device = pilot.device
    else:
        pilot = pcs.submit_pilot(PilotDescription(resource=resource, partitions=PARTITIONS,
                                                  concurrency=PARTITIONS))
        device = torch.device(DEVICE)
    broker = Broker()
    broker.create_topic("points", PARTITIONS)
    gen = torch.Generator(device=device).manual_seed(SEED)
    state = kmeans.init_state(n_centroids, DIM, generator=gen, device=device, scale=3.0)
    # inertia of each message under the model before its update (the model's
    # quality on data it has not seen): falls as the stream is learned
    pre_inertia = []
    model_lock = threading.Lock()

    def process(msgs):
        nonlocal state
        for m in msgs:
            pts = torch.from_numpy(m.value).to(device)
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
    due, lags = t0, []
    try:
        for i in range(n_messages):
            if program is not None:       # open loop: wait for the program's next slot
                time.sleep(max(0.0, due - time.perf_counter()))
                due += 1.0 / program.rate(due - t0)
            ts = time.perf_counter()
            broker.append("points", data[i], ts=ts, run_id=run_id,
                          msg_id=f"{run_id}/{i}", size_bytes=data[i].nbytes)
            metrics.record(run_id, "broker", "append", ts, msg_id=f"{run_id}/{i}")
            if program is not None:
                lags.append(broker.lag("engine", "points"))
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
    out = {"phase": phase, "resource": resource, "centroids": n_centroids,
           "points": N_POINTS, "dim": DIM, "partitions": PARTITIONS, "batch_max": 1,
           "processed": engine.core.processed, "expected": n_messages,
           "abandoned": engine.core.abandoned, "retried": engine.core.retried,
           "wall_s": wall, "msgs_per_s": metrics.throughput(run_id, "complete"),
           "lpx_ms": {q: lat[q] * 1e3 for q in ("p50", "p95", "max")},
           "inertia_first": float(inertia[0]), "inertia_last": float(inertia[-1]),
           "launches": launches,
           "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
           "card": smi}
    if program is not None:
        out.update(rate_hz=rate_hz, lag_at_last_append=lags[-1], lag_max=max(lags),
                   lag_mean=float(np.mean(lags)))
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
    # inertia and minibatch_step each take the fused assignment (K2); the
    # (n, k) matrix (K1) is not on the stream's path
    if launches["assign"] < 2 * n_messages:
        problems.append(f"assign launched {launches['assign']} < 2 x {n_messages} times")
    if launches["pairwise_sq_dists"] != 0:
        problems.append(f"pairwise_sq_dists launched {launches['pairwise_sq_dists']} times")
    if problems:
        raise AssertionError(f"{phase} at {n_centroids} centroids: {problems}")
    return out


LINT_RUN = """
import json, sys, time
t0 = time.perf_counter()
from repro_torch.analysis import run_analysis
report = run_analysis(sys.argv[1])
seconds = time.perf_counter() - t0
loaded = sorted({m.split(".")[0] for m in sys.modules} & {"torch", "jax", "jaxlib", "repro"})
print(json.dumps({"findings": [f.render() for f in sorted(report.findings)],
                  "files_scanned": report.files_scanned,
                  "pragma_count": report.pragma_count, "seconds": seconds,
                  "loaded": loaded}))
"""


def phase_lint(smi: str) -> dict:
    """The port's simlint (``repro_torch.analysis``) over this checkout, in a
    fresh interpreter that must load neither jax, the JAX package nor torch:
    0 findings."""
    proc = subprocess.run([sys.executable, "-c", LINT_RUN, str(ROOT)], capture_output=True,
                          text=True, timeout=120,
                          env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    if proc.returncode != 0:
        raise RuntimeError(f"lint: exit {proc.returncode}: {proc.stderr[-4000:]}")
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    out = {"phase": "lint", "findings": len(res["findings"]),
           "files_scanned": res["files_scanned"], "pragma_count": res["pragma_count"],
           "seconds": res["seconds"], "modules_loaded": res["loaded"], "card": smi}
    emit(out)
    problems = res["findings"][:20]
    if res["loaded"]:
        problems.append(f"the analysis loaded {res['loaded']}")
    if res["files_scanned"] <= 100:
        problems.append(f"only {res['files_scanned']} files scanned")
    if problems:
        raise AssertionError(f"lint: {problems}")
    return out


def phase_lockwatch(torch, smi: str) -> dict:
    """The threaded Mini-App on the card under the port's lock-order shim
    (``repro_torch.analysis.LockWatch``), installed before any of the
    phase's engines, pilots or brokers exists: the stream on each of
    LOCKWATCH_RESOURCES, K2 on the card.  The acquisition graph must have
    lock traffic, no cycle and no cross-component wait, and every lock site
    the port's manifest registers (found statically) must be a node."""
    from repro_torch.analysis import DEFAULT_MANIFEST, LockWatch, analyze_file
    from repro_torch.analysis.locks import extract_lock_sites

    registered = []
    for site in DEFAULT_MANIFEST.known_locks:
        rel = "src/" + site.path.removeprefix("*/")
        ctx = analyze_file(str(ROOT / rel), rel, DEFAULT_MANIFEST)
        registered += [f"{rel}:{line}:" for _kind, qualname, line in extract_lock_sites(ctx)
                       if site.matches(rel, qualname)]
    t0 = time.perf_counter()
    watch = LockWatch().install()
    try:
        runs = [phase_stream(torch, MODEL_SIZES[0], smi, LOCKWATCH_MESSAGES,
                             f"lockwatch-{res.removesuffix('://')}", resource=res)
                for res in LOCKWATCH_RESOURCES]
    finally:
        watch.uninstall()
    seconds = time.perf_counter() - t0
    report = watch.report()
    seen = {want: any(s.startswith(want) for s in report["sites"]) for want in registered}
    out = {"phase": "lockwatch", "resources": list(LOCKWATCH_RESOURCES),
           "messages": LOCKWATCH_MESSAGES, "acquisitions": report["acquisitions"],
           "nodes": len(report["sites"]),
           "edges": sum(len(b) for b in report["edges"].values()),
           "cycles": report["cycles"], "cross_component_waits": report["cross_component_waits"],
           "waits_while_holding": len(report["waits_while_holding"]),
           "registered_sites_seen": seen,
           "assign_launches": [r["launches"]["assign"] for r in runs],
           "seconds": seconds, "card": smi}
    emit(out)
    problems = []
    if report["acquisitions"] <= 0:
        problems.append("the shim saw no lock traffic")
    if report["cycles"]:
        problems.append(f"cycles {report['cycles']}")
    if report["cross_component_waits"]:
        problems.append(f"cross-component waits {report['cross_component_waits']}")
    if len(registered) != len(DEFAULT_MANIFEST.known_locks) or not all(seen.values()):
        problems.append(f"registered lock sites {registered}, seen {seen}")
    if problems:
        raise AssertionError(f"lockwatch: {problems}")
    return out


def averages(prof):
    """``prof.key_averages()``, computed once a profile: each call of it
    averages every event again (~1 s a training step's profile)."""
    if not hasattr(prof, "chip_smoke_averages"):
        prof.chip_smoke_averages = prof.key_averages()
    return prof.chip_smoke_averages


def device_time_rows(prof) -> list[dict]:
    """Device self time by kernel (and memcpy/memset) from a ``torch.profiler``
    run, largest first.  Only device-side kernel events count: a CPU op's
    row also carries the device time of the kernels it launched, and a
    ``record_function`` span's device-side row the time its kernels took,
    so summing either with the kernels would count that time twice."""
    from torch.autograd import DeviceType

    rows = []
    for ev in averages(prof):
        if ev.device_type == DeviceType.CPU or getattr(ev, "is_user_annotation", False):
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        if us > 0:
            rows.append({"name": ev.key[:96], "calls": ev.count, "device_ms": us / 1e3})
    rows.sort(key=lambda r: -r["device_ms"])
    return rows


def host_time_rows(prof, top: int = 10) -> list[dict]:
    """Host self time by op from a ``torch.profiler`` run, largest first:
    where the host's issue time goes when the device waits for it."""
    from torch.autograd import DeviceType

    rows = [{"name": ev.key[:96], "calls": ev.count, "host_ms": ev.self_cpu_time_total / 1e3}
            for ev in averages(prof)
            if ev.device_type == DeviceType.CPU and ev.self_cpu_time_total > 0]
    rows.sort(key=lambda r: -r["host_ms"])
    return rows[:top]


@contextlib.contextmanager
def spans(torch, named: dict):
    """Within the block, each function ``named[label] = (module, name)``
    runs inside ``torch.profiler.record_function(label)``, so a profile
    attributes the device time of the kernels it launches to ``label``
    (``span_device_ms``).  The model's modules call these functions through
    their module globals, which the block replaces and then restores."""
    saved = []
    for label, (module, name) in named.items():
        fn = getattr(module, name)

        def wrapped(*args, _fn=fn, _label=label, **kwargs):
            with torch.profiler.record_function(_label):
                return _fn(*args, **kwargs)

        saved.append((module, name, fn))
        setattr(module, name, wrapped)
    try:
        yield
    finally:
        for module, name, fn in saved:
            setattr(module, name, fn)


def span_device_ms(prof, labels) -> dict:
    """Device ms of the kernels launched inside each ``record_function``
    span named in ``labels`` (the host-side span's device total), with its
    calls; "not measured" where the profile holds no such span."""
    from torch.autograd import DeviceType

    out = {label: "not measured" for label in labels}
    for ev in averages(prof):
        if ev.key in out and ev.device_type == DeviceType.CPU:
            us = getattr(ev, "device_time_total", None)
            if us is None:
                us = ev.cuda_time_total
            out[ev.key] = {"device_ms": us / 1e3, "calls": ev.count}
    return out


def kernel_device_ms(rows: list[dict], kernel: str) -> float:
    """Summed device time of the rows that are kernels of the wrapper
    ``kernel`` (``flash_attention`` has ``flash_attention_kernel`` for f32 and
    ``flash_attention_bf16_kernel`` for bf16)."""
    return sum(r["device_ms"] for r in rows
               if re.search(rf"\b{kernel}(_\w+)?_kernel\b", r["name"]))


def busy_share(device_ms: float, wall_ms: float) -> float:
    """Summed device time over wall time.  Every kernel of the port runs on
    one stream, so a share above 1 means the rows counted time twice."""
    share = device_ms / wall_ms
    if share > 1:
        raise AssertionError(f"{device_ms} ms of device time in {wall_ms} ms of wall "
                             f"time on one stream: the profile counted time twice")
    return share


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
           "device_busy_share": busy_share(device_ms, run["wall_s"] * 1e3) if rows
           else "not measured",
           "top": rows[:12], "card": smi}
    emit(out)
    return out


def _records_equal(a: dict, b: dict) -> bool:
    """Field for field, ``==`` with NaN equal to NaN."""
    return a.keys() == b.keys() and all(
        a[k] == b[k] or (isinstance(a[k], float) and a[k] != a[k] and b[k] != b[k])
        for k in a)


def _records_equal_list(a: list, b: list) -> bool:
    return len(a) == len(b) and all(_records_equal(x, y) for x, y in zip(a, b))


def phase_sim_cells(smi: str) -> dict:
    """The port's ``run_experiment`` over the fig5 grid on the virtual clock
    (the host only): each cell's record and DES events."""
    from repro_torch.core.miniapp import StreamExperiment, run_experiment

    t0 = time.perf_counter()
    short = []
    for cell in SIM_GRID:
        res = run_experiment(StreamExperiment(**cell))
        emit({"phase": "sim-cells", **res.record(), "des_events": res.des_events,
              "wall_virtual_s": res.wall_virtual_s})
        if res.processed != cell["n_messages"]:
            short.append((cell["machine"], cell["centroids"], cell["partitions"]))
    out = {"phase": "sim-cells", "cells": len(SIM_GRID), "host_s": time.perf_counter() - t0,
           "card": smi}
    emit(out)
    if short:
        raise AssertionError(f"sim-cells: messages missing in {short}")
    return out


def phase_sim_kmeans(torch, smi: str, machine: str, faults) -> dict:
    """One simulated cell whose per-message K-Means update runs on the card
    (``run_experiment(exp, fn=KMeansMessageUpdate(...))``), under
    ``torch.profiler``; counts set to 0 just before and read just after.
    Then the same cell without the update (its virtual record must be the
    same) and the logged payloads replayed through the plain versions (the
    model and each message's inertia, K2's two outputs, must be the same,
    bit for bit)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.miniapp import StreamExperiment, run_experiment
    from repro_torch.models import kmeans

    exp = StreamExperiment(machine=machine, **SIM_KMEANS)
    update = KMeansMessageUpdate(torch, exp.centroids)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = run_experiment(exp, fn=update, faults=faults)
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
    counts = {name: launches(name) for name in ("assign", "pairwise_sq_dists")}
    peak = torch.cuda.max_memory_allocated()
    rows = device_time_rows(prof)
    device_ms = sum(r["device_ms"] for r in rows)
    plain = run_experiment(exp, faults=faults)
    same_record = (_records_equal(res.record(), plain.record())
                   and (res.des_events, res.wall_virtual_s, res.faults)
                   == (plain.des_events, plain.wall_virtual_s, plain.faults))
    replay, replay_inertia = update.replay()
    torch.cuda.synchronize()
    bit_equal = bool(torch.equal(replay.centroids, update.state.centroids)
                     and torch.equal(replay.counts, update.state.counts))
    inertia_equal = bool(torch.equal(torch.stack(replay_inertia),
                                     torch.stack(update.inertia)))
    centroids, model_counts = kmeans.state_to_numpy(update.state)
    inertia = torch.stack(update.inertia).cpu().numpy()
    out = {"phase": "sim-kmeans", "machine": machine, "faults": faults,
           **{k: v for k, v in res.record().items() if k != "machine"},
           "des_events": res.des_events, "wall_virtual_s": res.wall_virtual_s,
           "expected": exp.n_messages, "dup_delivered": res.dup_delivered,
           "abandoned": res.abandoned, "retried": res.retried, "fault_ledger": res.faults,
           "fn_calls": update.calls, "updates": len(update.payloads), "launches": counts,
           "record_equals_plain_run": same_record, "replay_bit_equal": bit_equal,
           "replay_inertia_bit_equal": inertia_equal,
           "inertia_first": float(inertia[0]), "inertia_last": float(inertia[-1]),
           "host_s": host_s, "device_ms": device_ms if rows else "not measured",
           "device_busy_share": busy_share(device_ms, host_s * 1e3) if rows
           else "not measured",
           "top": rows[:8], "max_memory_allocated_bytes": peak, "card": smi}
    emit(out)
    problems = []
    if res.processed != exp.n_messages or res.abandoned:
        problems.append(f"processed {res.processed}/{exp.n_messages}, "
                        f"abandoned {res.abandoned}")
    if faults is not None and (res.dup_delivered != 1 or res.faults["skipped"]
                               or res.faults["injected"] != len(faults["events"])):
        problems.append(f"faults {res.faults}, dup_delivered {res.dup_delivered}")
    if update.calls != exp.n_messages + res.dup_delivered \
            or counts["assign"] != 2 * update.calls:
        problems.append(f"assign launched {counts['assign']} times in {update.calls} "
                        f"calls of fn")
    if counts["pairwise_sq_dists"] != 0:
        problems.append(f"pairwise_sq_dists launched {counts['pairwise_sq_dists']} times")
    if not same_record:
        problems.append("the card's update moved the virtual record")
    if not bit_equal:
        problems.append("the model differs from the plain replay")
    if not inertia_equal:
        problems.append("an inertia differs from the plain replay's")
    if not inertia[-1] < inertia[0]:
        problems.append("inertia did not fall")
    if not (np.isfinite(centroids).all() and centroids.shape == (exp.centroids, DIM)
            and model_counts.sum() == update.calls * exp.points):
        problems.append("model not finite, of the wrong shape or miscounted")
    if problems:
        raise AssertionError(f"sim-kmeans {machine}: {problems}")
    return out


def usl_worst_shares(got, want, levels) -> dict:
    """Each fitted quantity's worst deviation of ``got`` (the card's fits)
    from ``want`` (numpy's), as a share of its limit in ``USL_TOL``."""
    share = dict.fromkeys(("t", "sigma", "kappa", "gamma", "sigma_ci", "kappa_ci",
                           "peak_n_ci"), 0.0)

    def worst(key, dev):
        share[key] = max(share[key], float(dev))

    for g, w in zip(got, want, strict=True):
        pw = w.predict(levels)
        worst("t", np.max(np.abs(g.predict(levels) - pw) / np.abs(pw)) / USL_TOL["t_rtol"])
        worst("sigma", abs(g.sigma - w.sigma) / USL_TOL["sigma"])
        worst("kappa", abs(g.kappa - w.kappa) / USL_TOL["kappa"])
        worst("gamma", abs(g.gamma - w.gamma) / abs(w.gamma) / USL_TOL["gamma_rtol"])
        if w.n_bootstrap:
            for a, b in zip(g.sigma_ci, w.sigma_ci):
                worst("sigma_ci", abs(a - b) / USL_TOL["sigma"])
            for a, b in zip(g.kappa_ci, w.kappa_ci):
                worst("kappa_ci", abs(a - b) / USL_TOL["kappa"])
            for a, b in zip(g.peak_n_ci, w.peak_n_ci):
                worst("peak_n_ci", 0.0 if a == b else abs(a - b) / abs(b) / USL_TOL["peak_rtol"])
    return share


def _timed(fn, *args, **kwargs):
    """(fn's result, its host seconds)."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    return out, time.perf_counter() - t0


def phase_characterize(torch, smi: str) -> dict:
    """``repro_torch.launch.characterize``'s flow with its fits on the card:
    both designs swept serially and through the process pool
    (``parallel="force"``: cold, then warm), whose records must be equal bit
    for bit; then every ``fit_models`` / ``evaluate`` / bootstrap fit on the
    card held against the port's numpy backend (``USL_TOL``), and each
    machine's ``Autoscaler.usable_peak_n()`` equal between the two."""
    import contextlib
    import io

    from repro_torch.core.autoscale import Autoscaler
    from repro_torch.core.streaminsight import StreamInsight
    from repro_torch.core.usl import fit_usl_batch
    from repro_torch.launch import characterize as C

    designs = {"sweep": C.sweep_design(), "ablation": C.ablation_design()}
    serial, serial_s = {}, {}
    for name, design in designs.items():
        serial[name] = StreamInsight()
        _, serial_s[name] = _timed(serial[name].run, design, parallel=False)
    pooled_s = {}
    for name in ("sweep", "ablation", "sweep-warm"):
        si = StreamInsight()
        _, pooled_s[name] = _timed(si.run, designs[name.split("-")[0]], parallel="force")
        if not _records_equal_list(si.records(), serial[name.split("-")[0]].records()):
            raise AssertionError(f"characterize: pooled {name} records differ from serial")
    # the launch flow itself, fits on the card, its report kept as text
    warm_n, warm_t = np.broadcast_to(USL_LEVELS, (2, 7)), np.ones((2, 7))
    fit_usl_batch(warm_n, warm_t, backend="torch", device=DEVICE)   # solver setup
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        (si, si2), flow_s = _timed(C.characterize, device=DEVICE, parallel="force",
                                   verbose=False)
    card = dict(backend="torch", device=DEVICE)
    rows, shares, problems = [], {}, []

    def hold(label, got, want, levels):
        sh = usl_worst_shares(got, want, levels)
        shares[label] = sh
        if max(sh.values()) > 1.0:
            problems.append(f"{label}: {sh}")

    levels = np.asarray(C.PARTITIONS, dtype=np.float64)
    for name, ins, serial_ins in (("sweep", si, serial["sweep"]),
                                  ("ablation", si2, serial["ablation"])):
        if not _records_equal_list(ins.records(), serial_ins.records()):
            problems.append(f"{name}: the flow's pooled records differ from serial")
        models_np, np_s = _timed(ins.fit_models)
        torch.cuda.synchronize()
        models_cu, cu_s = _timed(ins.fit_models, **card)
        hold(f"{name}/fit_models", [m.fit for m in models_cu], [m.fit for m in models_np],
             levels)
        boot_np, boot_np_s = _timed(ins.fit_models, bootstrap=REPORT_BOOTSTRAP)
        boot_cu, boot_cu_s = _timed(ins.fit_models, bootstrap=REPORT_BOOTSTRAP, **card)
        hold(f"{name}/bootstrap", [m.fit for m in boot_cu], [m.fit for m in boot_np], levels)
        ev_np, ev_np_s = _timed(ins.evaluate, C.EVAL_SIZES)
        ev_cu, ev_cu_s = _timed(ins.evaluate, C.EVAL_SIZES, **card)
        for agg_np, agg_cu in zip(ev_np, ev_cu, strict=True):
            for key, row in agg_np["scenarios"].items():
                other = agg_cu["scenarios"].get(key)
                if other is None or abs(other["sigma"] - row["sigma"]) > USL_TOL["sigma"] \
                        or abs(other["kappa"] - row["kappa"]) > USL_TOL["kappa"]:
                    problems.append(f"{name}/evaluate({agg_np['n_train_configs']}) {key}")
        peaks = [(m.key[0], m.key[4], Autoscaler(m.fit).usable_peak_n(),
                  Autoscaler(c.fit).usable_peak_n()) for m, c in zip(models_np, models_cu)]
        if any(p_np != p_cu for *_k, p_np, p_cu in peaks):
            problems.append(f"{name}: usable_peak_n differs {peaks}")
        rows.append({
            "design": name, "scenarios": len(models_np),
            "fit_ms": {"card": cu_s * 1e3, "numpy": np_s * 1e3},
            "bootstrap_fit_ms": {"card": boot_cu_s * 1e3, "numpy": boot_np_s * 1e3,
                                 "rows": REPORT_BOOTSTRAP * len(models_np)},
            "evaluate_ms": {"card": ev_cu_s * 1e3, "numpy": ev_np_s * 1e3},
            "mean_rel_rmse": {str(a["n_train_configs"]): [a["mean_rel_rmse"],
                                                          b["mean_rel_rmse"]]
                              for a, b in zip(ev_cu, ev_np)},
            "usable_peak_n": [{"machine": m, "policy": p, "numpy": a, "card": b}
                              for m, p, a, b in peaks],
            "report_card": [str(m) for m in boot_cu]})
    report_lines = si.report(bootstrap=REPORT_BOOTSTRAP, **card).splitlines()
    out = {"phase": "characterize", "serial_s": serial_s, "pooled_s": pooled_s,
           "pool_startup_s": pooled_s["sweep"] - pooled_s["sweep-warm"],
           "flow_s": flow_s, "flow_output": text.getvalue().splitlines(),
           "report_bootstrap": report_lines, "fits": rows, "worst_to_limit": shares,
           "card": smi}
    emit(out)
    if problems or len(report_lines) != 1 + len(rows[0]["report_card"]):
        raise AssertionError(f"characterize: {problems}")
    return out


def usl_synth(seed: int, s: int):
    """``tests/test_usl.py::_synth_batch``'s draws: random (sigma, kappa,
    gamma) per scenario, T(N) at ``USL_LEVELS`` with 5% lognormal noise."""
    from repro_torch.core.usl import usl_throughput

    rng = np.random.default_rng(seed)
    sigma, kappa = rng.uniform(0.0, 0.7, s), rng.uniform(0.0, 0.02, s)
    gamma = rng.uniform(0.2, 30.0, s)
    t = usl_throughput(USL_LEVELS[None, :], sigma[:, None], kappa[:, None], gamma[:, None])
    return (np.broadcast_to(USL_LEVELS, (s, USL_LEVELS.size)),
            t * rng.lognormal(0.0, 0.05, t.shape))


def phase_usl_batch(torch, smi: str) -> dict:
    """A fig6/fig7-sized bootstrap through one batch: 64 scenarios at 7
    levels with ``bootstrap=1024`` (65,536 resampled rows, plus the 64-row
    fit), on the card and with numpy on the host; the card's run once more
    under ``torch.profiler`` for its busy share; each quantity's worst
    deviation as a share of its limit."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.usl import fit_usl_batch

    n, t = usl_synth(SEED, USL_SCENARIOS)
    kw = dict(bootstrap=USL_BOOTSTRAP, bootstrap_seed=SEED)
    fit_usl_batch(n[:2], t[:2], backend="torch", device=DEVICE)       # solver setup
    want, numpy_s = _timed(fit_usl_batch, n, t, **kw)
    torch.cuda.synchronize()
    got, card_s = _timed(fit_usl_batch, n, t, backend="torch", device=DEVICE, **kw)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, prof_s = _timed(fit_usl_batch, n, t, backend="torch", device=DEVICE, **kw)
    rows = device_time_rows(prof)
    device_ms = sum(r["device_ms"] for r in rows)
    shares = usl_worst_shares(got, want, USL_LEVELS)
    out = {"phase": "usl-batch", "scenarios": USL_SCENARIOS, "levels": USL_LEVELS.tolist(),
           "bootstrap": USL_BOOTSTRAP, "rows": USL_SCENARIOS * USL_BOOTSTRAP,
           "card_s": card_s, "numpy_s": numpy_s, "profiled_s": prof_s,
           "device_ms": device_ms if rows else "not measured",
           "device_busy_share": busy_share(device_ms, prof_s * 1e3) if rows
           else "not measured",
           "top": rows[:8], "host_top": host_time_rows(prof), "worst_to_limit": shares,
           "card": smi}
    emit(out)
    if max(shares.values()) > 1.0:
        raise AssertionError(f"usl-batch: the card's fits exceed the tolerance {shares}")
    return out


def phase_adapt(smi: str) -> dict:
    """Closed-loop adaptation: serverless and wrangler x the four scaling
    policies on the virtual clock (the default step trace, 2 -> 12 Hz at
    40 s; 120 s, seed 0, 16,000 points, 1,024 centroids), the predictive
    cells parameterized by the sweep's numpy fits through ``usl_params``;
    each cell run twice, records and traces equal.  Every cell must drain
    with nothing lost, ``usl`` must violate no more ticks than ``reactive``
    on each machine, and the counts must be the reference's.  Then the
    reference test's wall-clock cell on ``local://``."""
    from repro_torch.core.miniapp import AdaptationExperiment, run_adaptation
    from repro_torch.core.streaminsight import StreamInsight
    from repro_torch.launch import characterize as C

    si = StreamInsight()
    si.run(C.sweep_design(), parallel=False)
    usl = si.usl_params(points=N_POINTS, centroids=MODEL_SIZES[0])
    cells, problems = {}, []
    for machine in ("serverless", "wrangler"):
        for policy in ADAPT_POLICIES:
            kw = dict(ADAPT_CELL, machine=machine, scaling_policy=policy)
            if policy.startswith("usl"):
                kw.update(zip(("usl_sigma", "usl_kappa", "usl_gamma"), usl[machine]))
            res, host_s = _timed(run_adaptation, AdaptationExperiment(**kw))
            again = run_adaptation(AdaptationExperiment(**kw))
            repeat = (_records_equal(res.record(), again.record())
                      and (res.alloc_trace, res.lag_trace)
                      == (again.alloc_trace, again.lag_trace))
            cells[(machine, policy)] = res
            emit({"phase": "adapt", **res.record(), "host_s": host_s,
                  "des_events": res.des_events, "repeat_equal": repeat})
            if not (repeat and res.drained and res.lost == 0):
                problems.append(f"{machine}/{policy}: repeat {repeat}, drained "
                                f"{res.drained}, lost {res.lost}")
            want = ADAPT_REFERENCE.get((machine, policy))
            if want is not None and (res.slo_violations, res.ticks) != want:
                problems.append(f"{machine}/{policy}: {res.slo_violations}/{res.ticks} "
                                f"ticks violating, the reference's {want}")
        if cells[(machine, "usl")].slo_violations > cells[(machine, "reactive")].slo_violations:
            problems.append(f"{machine}: usl violates more ticks than reactive")
    exp = AdaptationExperiment(**THREADED_CELL)
    res, host_s = _timed(run_adaptation, exp)
    ts = [t for t, _v in res.alloc_trace]
    threaded_ok = (res.drained and res.processed == res.produced > 0 and res.ticks >= 10
                   and res.scale_events >= 1 and res.final_allocation > 1
                   and len(res.alloc_trace) == res.ticks
                   and 0.0 < ts[0] < 2.0 and ts[-1] < exp.horizon_s + 5.0)
    emit({"phase": "adapt-threaded", **res.record(), "host_s": host_s, "ok": threaded_ok})
    if not threaded_ok:
        problems.append("the threaded cell failed the reference test's checks")
    out = {"phase": "adapt", "cells": len(cells), "usl_params": usl,
           "violations": {f"{m}/{p}": [r.slo_violations, r.ticks]
                          for (m, p), r in cells.items()}, "card": smi}
    emit(out)
    if problems:
        raise AssertionError(f"adapt: {problems}")
    return out


def rate_traces(s: dict) -> list[dict]:
    """benchmarks/fig8_adaptation.py's four rate traces for a scenario."""
    return [
        dict(kind="step", base_hz=s["base_hz"], high_hz=s["high_hz"], t_step=40.0),
        dict(kind="ramp", start_hz=s["base_hz"], end_hz=s["high_hz"], t0=30.0, t1=90.0),
        dict(kind="diurnal", mean_hz=s["diurnal_mean_hz"], amplitude=0.7, period_s=60.0),
        dict(kind="burst", base_hz=s["base_hz"], burst_hz=s["burst_hz"], burst_len_s=10.0,
             mean_gap_s=25.0, seed=8),
    ]


def whatif_tournament(machine: str) -> dict:
    """fig8's characterize -> fit -> baseline tournament for ``machine`` (the
    host only): the tournament, its seconds, the fit, and the problems found
    (fallbacks, undrained or lossy cells, a fast cell unequal to the scalar
    DES, fig8's claims on the step and burst traces)."""
    from repro_torch.core.miniapp import AdaptationPlan, run_plan
    from repro_torch.core.streaminsight import ExperimentDesign, StreamInsight
    from repro_torch.core.whatif import Tournament, WhatIfDesign

    s = WHATIF_SCENARIOS[machine]
    si = StreamInsight()
    si.run(ExperimentDesign(machines=[machine], partitions=WHATIF_PARTITIONS, points=[8000],
                            centroids=[1024], n_messages=60, policy=s["policy"]),
           parallel=False)
    usl = si.usl_params(policy=s["policy"])[machine]
    design = WhatIfDesign(
        base=dict(WHATIF_BASE, machine=machine, policy=s["policy"]),
        scenarios=[dict(name=r["kind"], rate=r) for r in rate_traces(s)],
        policies=[dict(name="usl", scaling_policy="usl",
                       **dict(zip(("usl_sigma", "usl_kappa", "usl_gamma"), usl))),
                  "reactive", "static"], seeds=[0])
    t, seconds = _timed(Tournament(design, parallel=False).run)
    problems = [f"{machine}: fell back {t.fallbacks}"] if t.fallbacks else []
    if t.fast_cells != t.unique_cells:
        problems.append(f"{machine}: {t.fast_cells} of {t.unique_cells} cells fast")
    scalar_s = 0.0
    for (trace, pol, _seed), summary in sorted(t.summaries.items()):
        if not summary.drained or summary.lost:
            problems.append(f"{machine}/{trace}/{pol}: drained {summary.drained}, "
                            f"lost {summary.lost}")
        scalar, secs = _timed(run_plan, AdaptationPlan(
            experiment=summary.experiment.experiment, fast=False))
        scalar_s += secs
        if not _records_equal(scalar.record(), summary.record()):
            problems.append(f"{machine}/{trace}/{pol}: fast replay != scalar DES")
    for trace in ("step", "burst"):
        usl_c, reactive, static = (t.summaries[(trace, p, 0)]
                                   for p in ("usl", "reactive", "static"))
        if not (usl_c.slo_violations < reactive.slo_violations
                and usl_c.cost_integral <= reactive.cost_integral
                and usl_c.cost_integral < static.cost_integral):
            problems.append(f"{machine}/{trace}: fig8's claim failed: usl "
                            f"{usl_c.slo_violations}/{usl_c.cost_integral}, reactive "
                            f"{reactive.slo_violations}/{reactive.cost_integral}, static "
                            f"{static.cost_integral}")
    return {"tournament": t, "seconds": seconds, "scalar_s": scalar_s, "usl": usl,
            "problems": problems}


def whatif_federated(usl: dict) -> dict:
    """One federated cell of fig8's ``fed_design`` through ``run_plan`` (the
    fast replay declines it; the scalar DES runs it), and a second run,
    which must be equal."""
    from repro_torch.core.miniapp import AdaptationExperiment, AdaptationPlan, run_plan

    members = [dict(name=m, machine=m, usl=tuple(usl[m]), **FED_MEMBER_KNOBS[m])
               for m in ("serverless", "wrangler")]
    exp = AdaptationExperiment(**FED_CELL, federation=dict(members=members),
                               **dict(zip(("usl_sigma", "usl_kappa", "usl_gamma"),
                                          usl["serverless"])))
    summary, seconds = _timed(run_plan, AdaptationPlan(experiment=exp))
    again = run_plan(AdaptationPlan(experiment=exp))
    ledger = summary.member_ledger
    problems = []
    if summary.fast_path or "federated" not in (summary.fallback_reason or ""):
        problems.append(f"federated: fast {summary.fast_path}, {summary.fallback_reason}")
    if not (summary.drained and summary.lost == 0 and ledger[0]["opens"] >= 1
            and ledger[0]["state"] == "closed"
            and all(m["dirty_samples"] == 0 for m in ledger)):
        problems.append(f"federated: drained {summary.drained}, lost {summary.lost}, "
                        f"ledger {ledger}")
    if not (_records_equal(summary.record(), again.record())
            and summary.member_ledger == again.member_ledger):
        problems.append("federated: a second run differs")
    return {"summary": summary, "seconds": seconds, "problems": problems}


def whatif_lockstep(exp, device: str) -> dict:
    """The lockstep seed scans of ``exp`` (a serverless cell without faults)
    through their entry points on ``device``, at each of LOCKSTEP_SEEDS:
    the grid scan of ``exp`` and the chain of ``exp`` at one static
    partition; host seconds, and each one's worst deviation from the
    float64 replay (the grid's reference column, the chain's scalar latency
    p50/p95 on the first 8 seeds) as a share of LOCKSTEP_RTOL."""
    from repro_torch.core.metrics import percentile_summary
    from repro_torch.core.miniapp import run_adaptation
    from repro_torch.sim import batched

    chain_exp = dataclasses.replace(exp, scaling_policy="static", static_partitions=1)
    out, problems = {"grid": {}, "chain": {}}, []
    for n_seeds in LOCKSTEP_SEEDS:
        seeds = list(range(n_seeds))
        (fins, ref_fin), secs = _timed(batched.grid_lockstep_completion_times, exp, seeds,
                                       with_reference=True, device=device)
        err = np.abs(fins[0].astype(np.float64) - ref_fin) / np.maximum(ref_fin, 1e-9)
        share = float(err.max()) / batched.LOCKSTEP_RTOL
        out["grid"][n_seeds] = {"host_s": secs, "steps": fins.shape[1],
                                "share_of_lockstep_rtol": share}
        if not (share <= 1.0 and np.isfinite(fins).all()):
            problems.append(f"grid lockstep at {n_seeds} seeds: share {share}")
        (fins, appends), secs = _timed(batched.lockstep_completion_times, chain_exp, seeds,
                                       with_appends=True, device=device)
        out["chain"][n_seeds] = {"host_s": secs, "steps": fins.shape[1]}
        if not (np.all(np.diff(fins, axis=1) >= 0) and np.isfinite(fins).all()):
            problems.append(f"lockstep chain at {n_seeds} seeds: not a FIFO chain")
        if n_seeds == LOCKSTEP_SEEDS[0]:
            worst = 0.0
            for i, seed in enumerate(seeds):
                res = run_adaptation(dataclasses.replace(chain_exp, seed=seed))
                lat = percentile_summary(list(fins[i] - appends))
                worst = max(worst, *(abs(lat[q] - res.latency_px[q])
                                     / (batched.LOCKSTEP_RTOL * res.latency_px[q])
                                     for q in ("p50", "p95")))
            out["chain"][n_seeds]["share_of_lockstep_rtol"] = worst
            if worst > 1.0:
                problems.append(f"lockstep chain: latency share {worst}")
    out["problems"] = problems
    return out


def sm_clock_max_mhz() -> float:
    """The card's top SM clock, as ``nvidia-smi`` reads it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return float(out.strip().splitlines()[0])


def writer_depth(parts, conts, n_parts: int, n_conts: int) -> int:
    """The grid scan's longest chain of steps that wait on one another: step
    k waits on the last earlier steps in range that wrote its partition and
    its container (an out-of-range step waits on none and writes none)."""
    depth, last = [0] * len(parts), ({}, {})
    for k, (p, c) in enumerate(zip(parts.tolist(), conts.tolist())):
        if not (0 <= p < n_parts and 0 <= c < n_conts):
            continue
        depth[k] = 1 + max(depth[last[0][p]] if p in last[0] else 0,
                           depth[last[1][c]] if c in last[1] else 0)
        last[0][p] = last[1][c] = k
    return max(depth, default=0)


def lockstep_rows(torch, exp, smi: str) -> dict:
    """Each lockstep kernel against its plain version on the card, on the
    operands the entry points build for ``exp`` at each of LOCKSTEP_SEEDS:
    worst deviation (and its share of LOCKSTEP_TOL), CUDA-event ms beside
    the plain version's, the bound and its share, the chain floor (an
    estimate: the longest run of steps that wait on one another, every
    step for the chain and the writer graph's depth for the grid, x
    LOCKSTEP_CARRIED dependent instructions x CYCLES_PER_DEPENDENT at the
    card's top SM clock), and an estimate of the seconds a sequential
    replay of the same seeds takes (the first 8 replayed and timed, their
    mean scaled to the seed count)."""
    from repro_torch.core.miniapp import AdaptationPlan, run_plan
    from repro_torch.kernels.lockstep_scan import ops, ref
    from repro_torch.sim import batched

    dev = torch.device(DEVICE)
    clock_mhz = sm_clock_max_mhz()
    chain_exp = dataclasses.replace(exp, scaling_policy="static", static_partitions=1)
    replay_s = [_timed(run_plan, AdaptationPlan(experiment=dataclasses.replace(exp, seed=s)))[1]
                for s in range(LOCKSTEP_SEEDS[0])]
    rows, failed = {}, []
    for n_seeds in LOCKSTEP_SEEDS:
        seeds = list(range(n_seeds))
        g = batched.grid_lockstep_inputs(exp, seeds)
        c = batched.lockstep_inputs(chain_exp, seeds)
        grid_args = [torch.from_numpy(g[k]).to(dev) for k in ("floors", "parts", "conts", "dt")]
        grid_args += [g["n_parts"], g["n_conts"]]
        chain_args = [torch.from_numpy(np.ascontiguousarray(c[k], dtype=np.float32)).to(dev)
                      for k in ("appends", "means", "z")] + [c["a"], c["b"]]
        for name, fn, plain, args in (
                ("grid_lockstep_scan", ops.grid_lockstep_scan, ref.grid_lockstep_scan_ref,
                 grid_args),
                ("lockstep_scan", ops.lockstep_scan, ref.lockstep_scan_ref, chain_args)):
            got, want = fn(*args), plain(*args)
            torch.cuda.synchronize()
            share = float(((got - want).abs() / (LOCKSTEP_TOL * want.abs())).max())
            S, n = got.shape
            # each input read once, the finishes written once; the operations
            # per step and seed (grid: 3 max, 1 add; chain: 2 mul, 2 add, exp,
            # max) are far below the bytes' time
            in_bytes = S * n * 4 + (12 if name == "grid_lockstep_scan" else 8) * n
            t_bytes = (in_bytes + S * n * 4) / peak("hbm_bw")
            t_ops = S * n * (4 if name == "grid_lockstep_scan" else 6) / peak("f32_flops")
            chain = (writer_depth(g["parts"], g["conts"], g["n_parts"], g["n_conts"])
                     if name == "grid_lockstep_scan" else n)
            row = {"phase": "whatif-kernel", "kernel": name, "seeds": S, "steps": n,
                   "ok": share <= 1.0 and bool(torch.isfinite(got).all()),
                   "bit_equal": bool(torch.equal(got, want)),
                   "max_abs_err": float((got - want).abs().max()),
                   "worst_share_of_rtol": share, "tolerance": {"rtol": LOCKSTEP_TOL},
                   "ms": cuda_ms(torch, lambda: fn(*args)),
                   "plain_ms": cuda_ms(torch, lambda: plain(*args), iters=3, warmup=1),
                   "bound_ms": max(t_bytes, t_ops) * 1e3,
                   "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                   "library_ms": None, "chain_steps": chain, "sm_clock_max_mhz": clock_mhz,
                   "chain_floor_ms": (chain * LOCKSTEP_CARRIED * CYCLES_PER_DEPENDENT
                                      / (clock_mhz * 1e3)),
                   # the first 8 seeds' replays measured, scaled to S seeds
                   "sequential_replay_s_est": (sum(replay_s) / len(replay_s) * S
                                               if name == "grid_lockstep_scan" else None),
                   "card": smi}
            row["share_of_bound"] = row["bound_ms"] / row["ms"]
            if name == "grid_lockstep_scan":
                row["n_parts"], row["n_conts"] = g["n_parts"], g["n_conts"]
            emit(row)
            rows[(name, S)] = row
            if not row["ok"]:
                failed.append((name, S))
    if failed:
        raise AssertionError(f"lockstep kernels disagree with their plain versions at {failed}")
    return {"rows": rows, "sequential_replay_s_8": sum(replay_s)}


def phase_whatif(torch, smi: str) -> dict:
    """fig8's what-if path: for serverless and wrangler the baseline
    tournament (every cell on the fast replay, each equal to the scalar
    DES, fig8's claims held), one federated cell of ``fed_design``, and the
    lockstep seed scans of the serverless step cell on the card at 8 and
    1,024 seeds, through their entry points; launches counted over that
    run.  Then each lockstep kernel against its plain version on the card."""
    reset_counts()
    t0 = time.perf_counter()
    runs = {m: whatif_tournament(m) for m in WHATIF_SCENARIOS}
    fed = whatif_federated({m: r["usl"] for m, r in runs.items()})
    step_cell = runs["serverless"]["tournament"].summaries[("step", "usl", 0)]
    exp = step_cell.experiment.experiment
    lock = whatif_lockstep(exp, DEVICE)
    host_s = time.perf_counter() - t0
    counts = {k: launches(k) for k in LOCKSTEP_REPLACES}
    problems = [p for r in runs.values() for p in r["problems"]]
    problems += fed["problems"] + lock["problems"]
    problems += [f"{k} was not launched in the whatif run" for k, v in counts.items() if v < 1]
    for machine, r in runs.items():
        t = r["tournament"]
        emit({"phase": "whatif-tournament", "machine": machine, "usl": r["usl"],
              "total_cells": t.total_cells, "unique_cells": t.unique_cells,
              "fast_cells": t.fast_cells, "fallbacks": len(t.fallbacks),
              "seconds": r["seconds"], "scalar_rerun_s": r["scalar_s"],
              "rows": [{k: row[k] for k in ("scenario", "policy_name", "slo_violations",
                                            "ticks", "cost_integral", "processed", "drained",
                                            "lost")} for row in t.summary_rows()],
              "wins": {f"{a}>{b}": w for (a, b), w in t.wins.items()}, "card": smi})
    s = fed["summary"]
    emit({"phase": "whatif-federated", **s.record(), "member_ledger": s.member_ledger,
          "fallback_reason": s.fallback_reason, "seconds": fed["seconds"], "card": smi})
    emit({"phase": "whatif-lockstep", "grid": lock["grid"], "chain": lock["chain"],
          "launches": counts, "card": smi})
    kernels = lockstep_rows(torch, exp, smi)
    out = {"phase": "whatif", "host_s": host_s, "launches": counts,
           "fast_cells": sum(r["tournament"].fast_cells for r in runs.values()),
           "fallbacks": sum(len(r["tournament"].fallbacks) for r in runs.values()),
           "tournament_s": {m: r["seconds"] for m, r in runs.items()},
           "sequential_replay_s_8": kernels["sequential_replay_s_8"], "card": smi}
    emit(out)
    if problems:
        raise AssertionError(f"whatif: {problems}")
    out["rows"] = kernels["rows"]
    return out


def fa_prefill_shape(cfg) -> tuple[int, int, int, int, int]:
    """(BH, BKV, S, Dh, window) of K3 in a SERVE_BATCH x SERVE_PROMPT
    prefill (window: the config's local window where it has local-attention
    layers, else 0)."""
    window = cfg.local_window if "local_attn" in cfg.layer_kinds else 0
    return (SERVE_BATCH * cfg.n_heads, SERVE_BATCH * cfg.n_kv_heads, SERVE_PROMPT,
            cfg.head_dim, window)


KERNEL_KINDS = {"flash_attention": ("attn", "local_attn", "moe"), "ssd_scan": ("ssm",)}


def kernel_layers(cfg, kernel: str) -> int:
    """Layers of ``cfg`` whose prefill launches ``kernel`` once."""
    return sum(kind in KERNEL_KINDS[kernel] for kind in cfg.layer_kinds)


def wrapped_layers(cfg, kernel: str | None = None) -> int:
    """Layers of ``cfg`` in its ``block_pattern`` groups, which training
    checkpoints unless ``cfg.remat`` is ``"none"`` (the tail runs
    unwrapped); with ``kernel``, only those that launch it."""
    body = cfg.layer_kinds[:cfg.n_groups * len(cfg.block_pattern)]
    return sum(kernel is None or kind in KERNEL_KINDS[kernel] for kind in body)


def forward_launches(cfg, kernel: str) -> int:
    """``kernel``'s forward launches in one microbatch of a training step:
    once a layer that runs it, and once more in a checkpointed layer, whose
    forward the backward recomputes (``cfg.remat`` other than ``"none"``).
    The backward launches once a layer."""
    again = 0 if cfg.remat == "none" else wrapped_layers(cfg, kernel)
    return kernel_layers(cfg, kernel) + again


def fa_shapes() -> list[tuple]:
    """K3's rows: each FA_PREFILL_ARCHS prefill shape once, in bf16 and
    f32, then FA_RAGGED and FA_WINDOWED."""
    from repro_torch.configs.base import get_config

    shapes = []
    for arch in FA_PREFILL_ARCHS:
        shape = fa_prefill_shape(get_config(arch))
        if shape not in shapes:
            shapes.append(shape)
    return ([sh + (dt,) for sh in shapes for dt in ("bfloat16", "float32")] + FA_RAGGED
            + FA_WINDOWED)


def phase_kernel_k3(torch, smi: str) -> dict:
    """K3 against ``mha_ref`` on the same inputs, with times; SDPA on the
    same operands, given a window that bites as an explicit boolean mask."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import mha_ref

    torch.backends.cuda.matmul.allow_tf32 = False     # mha_ref's products in full f32, stated
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    results, failed = {}, []
    for bh, bkv, s, dh, window, dtype_name in fa_shapes():
        dtype = getattr(torch, dtype_name)
        tol = FA_TOLERANCE[dtype_name]
        q = torch.randn((bh, s, dh), generator=gen, device=dev).to(dtype)
        k = torch.randn((bkv, s, dh), generator=gen, device=dev).to(dtype)
        v = torch.randn((bkv, s, dh), generator=gen, device=dev).to(dtype)
        got = fa_ops.flash_attention(q, k, v, window=window)
        want = mha_ref(q, k, v, window=window)
        torch.cuda.synchronize()
        ok = bool(torch.allclose(got.float(), want.float(), **tol))
        bound_ms, by, f32_core_ms = fa_bound(bh, bkv, s, dh, q.element_size(), window)
        q4, k4, v4 = q[None], k[None], v[None]       # head h reads kv head h // G
        if 0 < window < s:
            idx = torch.arange(s, device=dev)
            mask = (idx[None, :] <= idx[:, None]) & (idx[None, :] > idx[:, None] - window)
            library = lambda: sdpa(q4, k4, v4, attn_mask=mask, enable_gqa=True)  # noqa: E731
        else:
            library = lambda: sdpa(q4, k4, v4, is_causal=True, enable_gqa=True)  # noqa: E731
        row = {"phase": "kernel-K3", "bh": bh, "bkv": bkv, "s": s, "dh": dh,
               "window": window, "dtype": dtype_name, "ok": ok, "tolerance": tol,
               "max_abs_err": float((got.float() - want.float()).abs().max()),
               "ms": cuda_ms(torch, lambda: fa_ops.flash_attention(q, k, v, window=window)),
               "plain_ms": cuda_ms(torch, lambda: mha_ref(q, k, v, window=window)),
               "library_ms": cuda_ms(torch, library),
               "library_max_abs_err": float((library().float() - want.float()).abs().max()),
               "bound_ms": bound_ms, "bound_by": by, "f32_core_ms": f32_core_ms,
               "card": smi}
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        emit(row)
        results[(bh, bkv, s, dh, window, dtype_name)] = row
        if not ok:
            failed.append((bh, bkv, s, dh, window, dtype_name))
        del q, k, v, got, want, q4, k4, v4, library
        torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"K3 disagrees with mha_ref at {failed}")
    return results


def ssd_bound(b: int, s: int, h: int, p: int, n: int, with_h0: bool):
    """(least ms, what bounds it, the route of the operations' time, ms of
    the operations at the f32 CUDA-core rate) of the SSD scan at K4's chunk
    SSD_Q: the f32 operands read once (h0 too, if given) and y and the final
    state written once at the HBM rate, against the chunked form's
    operations, a multiply-add counted as 2.  Per batch row and chunk of q
    positions, C B^T over its q (q + 1) / 2 lower pairs (2 N each; B and C
    are shared by the heads); per head and chunk, the decay L on those pairs
    (1 each), the intra-chunk product (2 P each), and the carry-in C h^T and
    the state update (2 q P N each).  The operations take the faster of two
    routes: all on the f32 CUDA cores, or the four products on the TF32
    tensor cores three times over (2e-4 is beyond one TF32 pass, not beyond
    three: hi/lo splits of both operands) and the decays on the CUDA
    cores."""
    t_bytes = 4 * (2 * b * s * h * p + b * s * h + h + 2 * b * s * n
                   + (2 if with_h0 else 1) * b * h * p * n) / peak("hbm_bw")
    products = rest = 0.0
    for s0 in range(0, s, SSD_Q):
        q = min(SSD_Q, s - s0)
        pairs = q * (q + 1) / 2
        products += b * pairs * 2 * n + b * h * (pairs * 2 * p + 4 * q * p * n)
        rest += b * h * pairs
    t_cores = (products + rest) / peak("f32_flops")
    t_tf32 = 3 * products / peak("tf32_flops") + rest / peak("f32_flops")
    t_ops = min(t_cores, t_tf32)
    route = "3xTF32 tensor cores" if t_tf32 <= t_cores else "f32 CUDA cores"
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations", route,
            t_cores * 1e3)


def ssd_phase_ms(torch, fn, calls: int = 10) -> dict:
    """Device ms a call of each of K4's CUDA kernels (``ssd_ops.PHASES``)."""
    from repro_torch.kernels.ssd_scan import ops as ssd_ops

    by_kernel = device_ms_by_kernel(
        torch, fn, [f"ssd_scan_{ph}_kernel" for ph in ssd_ops.PHASES], calls)
    return {ph: by_kernel[f"ssd_scan_{ph}_kernel"] for ph in ssd_ops.PHASES}


def phase_kernel_k4(torch, smi: str) -> dict:
    """K4 against ``ssd_ref`` (float32, the plain version; float64 beside
    it) on the same inputs, drawn as tests/test_kernels.py:87-92 draws
    them, with times; ``ssd_chunked`` (the wrapper's CPU path) timed on the
    card too."""
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan.ref import ssd_ref
    from repro_torch.models.ssm import ssd_chunked

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def to_limit(got, want):    # the largest |err| / (atol + rtol |want|): <= 1 passes
        return float(((got.double() - want.double()).abs()
                      / (SSD_TOL + SSD_TOL * want.double().abs())).max())

    results, failed = {}, []
    for (b, s, h, p, n), with_h0 in SSD_SHAPES:
        x, dt = randn(b, s, h, p), torch.nn.functional.softplus(randn(b, s, h))
        A = -torch.exp(0.5 * randn(h))
        Bm, Cm = randn(b, s, n), randn(b, s, n)
        h0 = randn(b, h, p, n) if with_h0 else None
        args = (x, dt, A, Bm, Cm)
        chunk = SSD_CHUNK if s % min(SSD_CHUNK, s) == 0 else s    # the model's contract
        y, hT = ssd_ops.ssd_scan(*args, chunk=chunk, h0=h0)
        want_y, want_h = ssd_ref(*args, h0)
        y64, h64 = ssd_ref(*(t.double() for t in args), None if h0 is None else h0.double())
        torch.cuda.synchronize()
        ok = bool(torch.allclose(y, want_y, rtol=SSD_TOL, atol=SSD_TOL)
                  and torch.allclose(hT, want_h, rtol=SSD_TOL, atol=SSD_TOL))
        bound_ms, by, route, f32_core_ms = ssd_bound(b, s, h, p, n, with_h0)
        row = {"phase": "kernel-K4", "batch": b, "s": s, "h": h, "p": p, "n": n,
               "h0": with_h0, "dtype": "float32", "ok": ok,
               "tolerance": {"rtol": SSD_TOL, "atol": SSD_TOL},
               "max_abs_err": max(float((y - want_y).abs().max()),
                                  float((hT - want_h).abs().max())),
               "max_abs_err_f64": max(float((y.double() - y64).abs().max()),
                                      float((hT.double() - h64).abs().max())),
               "plain_f32_err_f64": max(float((want_y.double() - y64).abs().max()),
                                        float((want_h.double() - h64).abs().max())),
               "worst_to_limit": max(to_limit(y, want_y), to_limit(hT, want_h)),
               "worst_to_limit_f64": max(to_limit(y, y64), to_limit(hT, h64)),
               "max_abs_y": float(want_y.abs().max()),
               "ms": cuda_ms(torch, lambda: ssd_ops.ssd_scan(*args, chunk=chunk, h0=h0)),
               "plain_ms": cuda_ms(torch, lambda: ssd_ref(*args, h0), iters=3, warmup=1),
               "chunked_ms": cuda_ms(torch, lambda: ssd_chunked(*args, chunk, h0),
                                     iters=5, warmup=1),
               "library_ms": None, "bound_ms": bound_ms, "bound_by": by,
               "bound_route": route, "f32_core_bound_ms": f32_core_ms, "card": smi}
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        if (b, s, h, p, n) == SSD_SERVING:
            row["phase_ms"] = ssd_phase_ms(
                torch, lambda: ssd_ops.ssd_scan(*args, chunk=chunk, h0=h0))
        emit(row)
        results[((b, s, h, p, n), with_h0)] = row
        if not ok:
            failed.append(((b, s, h, p, n), with_h0))
        del x, dt, A, Bm, Cm, h0, args, y, hT, want_y, want_h, y64, h64
        torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"K4 disagrees with ssd_ref at {failed}")
    return results


def ssd_bwd_bound(b: int, s: int, h: int, p: int, n: int, with_h0: bool):
    """(least ms, what bounds it, the route of the operations' time, ms of
    the operations at the f32 CUDA-core rate) of K4's backward at its chunk
    SSD_Q: x, dt, A, B, C, dy and the forward's span states read once (and
    the final state's cotangent where it is given, with h0) and dx, ddt, dA,
    dB, dC (and dh0 where there is an h0) written once at the HBM rate,
    against the chunked form's operations, a multiply-add counted as 2.  Per
    batch row and chunk of q positions C B^T over its q (q + 1) / 2 lower
    pairs (2 N each); per head and chunk on those pairs dy (dt x)^T and M^T
    dy (2 P each), LD B and LD^T C (2 N each) and the decays (3 each), and
    the four full products dy h_in, (dt x) R, B R^T and the local adjoint
    (2 q P N each).  The faster route of ``ssd_bound``'s two."""
    chunks = -(-s // SSD_Q)
    spans = -(-chunks // 4)                  # of the saved states, 4 chunks each
    t_bytes = 4 * (3 * b * s * h * p + 2 * b * s * h + 2 * h + 4 * b * s * n
                   + b * h * spans * p * n + (2 if with_h0 else 0) * b * h * p * n
                   ) / peak("hbm_bw")
    products = rest = 0.0
    for s0 in range(0, s, SSD_Q):
        q = min(SSD_Q, s - s0)
        pairs = q * (q + 1) / 2
        products += b * pairs * 2 * n + b * h * (pairs * (4 * p + 4 * n) + 8 * q * p * n)
        rest += 3 * b * h * pairs
    t_cores = (products + rest) / peak("f32_flops")
    t_tf32 = 3 * products / peak("tf32_flops") + rest / peak("f32_flops")
    t_ops = min(t_cores, t_tf32)
    route = "3xTF32 tensor cores" if t_tf32 <= t_cores else "f32 CUDA cores"
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations", route,
            t_cores * 1e3)


def phase_kernel_k4_bwd(torch, smi: str) -> dict:
    """K4's backward (``ssd_scan_bwd.cu``, three CUDA kernels a call) against
    ``ssd_bwd_ref`` (f32, its plain version) and float64 autograd of
    ``ssd_ref`` on the forward's own span states, twice (the same bits),
    with CUDA-event times beside the bound, the plain version's, autograd of
    ``ssd_chunked`` on a kept graph (the CPU path's gradient, run on the
    card), and the forward's without and with its span states kept; each
    row's worst error as a share of the tolerance and each CUDA kernel's
    device ms, their sum beside the call's CUDA-event ms; a kernel whose
    device ms is not measured fails the row."""
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan.ref import ssd_bwd_ref, ssd_ref
    from repro_torch.models.ssm import ssd_chunked

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def shares(got, want, tol):     # each gradient's largest |err| / (tol max|want| + tol |want|)
        return {name: float(((g.double() - w.double()).abs()
                             / (tol * w.double().abs().max() + tol * w.double().abs())).max())
                for name, g, w in zip(SSD_GRADS, got, want)}

    results, failed = {}, []
    for (b, s, h, p, n), with_h0, scale in SSD_BWD_SHAPES:
        x, dt = randn(b, s, h, p), torch.nn.functional.softplus(randn(b, s, h))
        A = -scale * torch.exp(0.5 * randn(h))
        Bm, Cm, dy = randn(b, s, n), randn(b, s, n), randn(b, s, h, p)
        h0, dh = (randn(b, h, p, n), randn(b, h, p, n)) if with_h0 else (None, None)
        args = (x, dt, A, Bm, Cm)
        _, _, states = ssd_ops._forward(*args, h0, keep_states=True)
        got = ssd_ops.ssd_scan_bwd(*args, dy, states, dh)
        again = ssd_ops.ssd_scan_bwd(*args, dy, states, dh)
        want = ssd_bwd_ref(*args, dy, states, dh)
        ins = [t.double().requires_grad_(True) for t in args + ((h0,) if with_h0 else ())]
        y64, h64 = ssd_ref(*ins[:5], h0=ins[5] if with_h0 else None)
        loss = (y64 * dy.double()).sum() + ((h64 * dh.double()).sum() if with_h0 else 0)
        want64 = torch.autograd.grad(loss, ins)
        del ins, y64, h64, loss
        torch.cuda.synchronize()
        same = all(torch.equal(u, v) for u, v in zip(got, again))
        to_ref = shares(got, want, SSD_BWD_TOL)
        to_f64 = shares(got, want64, SSD_TOL)
        ok = same and max(to_ref.values()) <= 1.0 and max(to_f64.values()) <= 1.0
        chunk = SSD_CHUNK if s % min(SSD_CHUNK, s) == 0 else s     # the model's contract
        tins = [t.detach().requires_grad_(True) for t in args + ((h0,) if with_h0 else ())]
        yc, hc = ssd_chunked(*tins[:5], chunk, tins[5] if with_h0 else None)
        outs, cots = ((yc, hc), (dy, dh)) if with_h0 else ((yc,), (dy,))
        bound_ms, by, route, f32_core_ms = ssd_bwd_bound(b, s, h, p, n, with_h0)
        row = {"phase": "kernel-K4-bwd", "batch": b, "s": s, "h": h, "p": p, "n": n,
               "h0_and_dh": with_h0, "a_scale": scale, "dtype": "float32", "ok": ok,
               "bit_identical": same,
               "tolerance": {
                   "ssd_bwd_ref": {"rtol": SSD_BWD_TOL, "atol_share_of_max": SSD_BWD_TOL},
                   "float64": {"rtol": SSD_TOL, "atol_share_of_max": SSD_TOL}},
               "max_abs_err": max(float((g - w).abs().max()) for g, w in zip(got, want)),
               "worst_to_tolerance": max(to_ref.values()), "to_tolerance": to_ref,
               "worst_to_tolerance_f64": max(to_f64.values()), "to_tolerance_f64": to_f64,
               "plain_f32_to_tolerance_f64": max(shares(want, want64, SSD_TOL).values()),
               "ms": cuda_ms(torch, lambda: ssd_ops.ssd_scan_bwd(*args, dy, states, dh),
                             iters=20),
               "plain_ms": cuda_ms(torch, lambda: ssd_bwd_ref(*args, dy, states, dh),
                                   iters=5, warmup=1),
               "chunked_autograd_ms": cuda_ms(torch, lambda: torch.autograd.grad(
                   outs, tins, cots, retain_graph=True), iters=5, warmup=1),
               "library_ms": None,
               "forward_ms": cuda_ms(torch, lambda: ssd_ops._forward(*args, h0, False)),
               "forward_keep_states_ms": cuda_ms(torch, lambda: ssd_ops._forward(
                   *args, h0, True)),
               "bound_ms": bound_ms, "bound_by": by, "bound_route": route,
               "f32_core_bound_ms": f32_core_ms,
               "device_ms_by_kernel": device_ms_by_kernel(
                   torch, lambda: ssd_ops.ssd_scan_bwd(*args, dy, states, dh),
                   [f"ssd_bwd_{ph}_kernel" for ph in ssd_ops.BWD_PHASES], calls=5),
               "card": smi}
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        by_kernel = list(row["device_ms_by_kernel"].values())
        row["device_ms_sum"] = (sum(by_kernel) if "not measured" not in by_kernel
                                else "not measured")
        if row["device_ms_sum"] == "not measured":
            row["ok"] = ok = False
        emit(row)
        results[((b, s, h, p, n), with_h0, scale)] = row
        if not ok:
            failed.append(((b, s, h, p, n), with_h0, scale))
        del x, dt, A, Bm, Cm, dy, h0, dh, args, states, got, again, want, want64, tins, yc, hc
        del outs, cots
        torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"K4's backward disagrees with ssd_bwd_ref or float64, or "
                             f"repeats inexactly at {failed}")
    return results


def _greedy_with_logits(torch, M, params, cfg, prompt, n_new, embeds=None):
    """Greedy tokens and the fp32 logits each was chosen from (prefill's
    first), through the model's prefill (with ``embeds``, if given) and
    decode steps."""
    S = prompt.shape[1]
    logits, caches = M.prefill(params, cfg, prompt, S + n_new, embeds=embeds)
    steps = [logits.float().cpu()]
    toks = [torch.argmax(logits, dim=-1)]
    for i in range(n_new - 1):
        logits, caches = M.decode_step(params, cfg, toks[-1], caches, S + i)
        steps.append(logits.float().cpu())
        toks.append(torch.argmax(logits, dim=-1))
    return torch.stack(toks, dim=1).cpu(), steps


def route_flips(torch, card: list, cpu: list, k: int, steps: int) -> dict:
    """Top-k choices that differ between the card's and the CPU's router
    gates: ``card`` and ``cpu`` hold the (1, S, E) gates of each router
    call of ``steps`` forwards, the same number of calls each, on equal
    inputs.  Returns per step the number of (layer, token) choices that
    differ, the CPU's gaps between the k-th and (k+1)-th gate where they
    do, and the CPU's smallest such gap."""
    per = len(cpu) // steps
    flips, flip_gaps, smallest = [0] * steps, [], float("inf")
    for i, (a, b) in enumerate(zip(card, cpu)):
        top = torch.topk(b[0], k + 1, dim=-1)
        gap = top.values[:, k - 1] - top.values[:, k]
        smallest = min(smallest, float(gap.min()))
        mine = torch.topk(a[0], k, dim=-1).indices.sort(dim=-1).values
        theirs = top.indices[:, :k].sort(dim=-1).values
        differ = (mine != theirs).any(dim=-1)
        flips[i // per] += int(differ.sum())
        flip_gaps += gap[differ].tolist()
    return {"flips": flips, "flip_gaps": flip_gaps, "smallest_gap": smallest}


def phase_lm_parity(torch, smi: str, arch: str, kernel: str,
                    phase: str = "lm-parity", n_layers: int = 0,
                    prompt_len: int = PARITY_PROMPT, depth_cut: str = "") -> dict:
    """Full-width ``arch`` in float32, one weight set: the model on the card
    (its prefill through ``kernel``) against the same model on the CPU (the
    plain versions).  A token mismatch fails unless the CPU's top-2 logit
    gap at that step is under the tolerance (a near tie).  ``n_layers``
    cuts the depth (0: the published depth), for the reason ``depth_cut``
    states; a config with a frontend takes its ``n_prefix`` embeddings,
    drawn in numpy from SEED, on the first positions of the prompt.

    An MoE config's routers are recorded on both sides (``route_flips``):
    from the first step at which a (layer, token) top-k choice differs, the
    two models compute different functions, so logits are held to the
    tolerance only before it and a later token mismatch is reported as
    ``after-flip``; more than ROUTE_FLIPS_MAX flips at CPU gaps above
    ROUTE_FLIP_MARGIN fail."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import model as M
    from repro_torch.models import moe as moe_mod

    torch.backends.cuda.matmul.allow_tf32 = False     # full f32 products, stated
    torch.backends.cudnn.allow_tf32 = False
    published = get_config(arch)
    cfg = dataclasses.replace(published, dtype="float32",
                              n_layers=n_layers or published.n_layers)
    # one generator seed on the card gives both copies the same weights
    params = {d: M.init_params(cfg, torch.Generator(device=DEVICE).manual_seed(SEED), d)
              for d in (DEVICE, "cpu")}
    prompt = np.random.default_rng([SEED, 3]).integers(0, cfg.vocab_size, (1, prompt_len))
    embeds = None
    if cfg.frontend is not None:
        embeds = torch.from_numpy(np.random.default_rng([SEED, 6]).standard_normal(
            (1, cfg.n_prefix, cfg.d_model), dtype=np.float32))
    route, gates = moe_mod._route, {DEVICE: [], "cpu": []}
    moe_mod._route = lambda cfg_, x, router, cap: _recorded(
        route(cfg_, x, router, cap), gates[x.device.type])
    try:
        before = launches(kernel)
        with torch.inference_mode():
            gpu_toks, gpu_logits = _greedy_with_logits(
                torch, M, params[DEVICE], cfg, torch.from_numpy(prompt).to(DEVICE),
                PARITY_NEW, None if embeds is None else embeds.to(DEVICE))
            kernel_launches = launches(kernel) - before
            cpu_toks, cpu_logits = _greedy_with_logits(
                torch, M, params["cpu"], cfg, torch.from_numpy(prompt), PARITY_NEW, embeds)
    finally:
        moe_mod._route = route
    gpu_toks, cpu_toks = gpu_toks[0].tolist(), cpu_toks[0].tolist()
    # steps 0..m see equal inputs, m the first step whose tokens differ
    compared = next((i + 1 for i, (a, b) in enumerate(zip(gpu_toks, cpu_toks)) if a != b),
                    PARITY_NEW)
    routing = None
    first_flip = PARITY_NEW
    if gates["cpu"]:
        per = len(gates["cpu"]) // PARITY_NEW
        routing = route_flips(torch, gates[DEVICE][:compared * per],
                              gates["cpu"][:compared * per], cfg.experts_per_token, compared)
        first_flip = next((i for i, n in enumerate(routing["flips"]) if n), PARITY_NEW)
    diffs, gaps, verdict = [], [], "equal"
    for i, (a, b) in enumerate(zip(gpu_toks, cpu_toks)):
        top2 = torch.topk(cpu_logits[i][0], 2).values
        gaps.append(float(top2[0] - top2[1]))
        diffs.append(float((gpu_logits[i] - cpu_logits[i]).abs().max()))
        if a != b:          # later steps see different tokens: stop comparing
            verdict = ("after-flip" if first_flip <= i else
                       "near-tie" if gaps[i] < LM_PARITY_TOL else "mismatch")
            break
    held = diffs[:first_flip]
    out = {"phase": phase, "arch": arch, "dtype": "float32",
           "params": sum(t.numel() for t in params["cpu"].parameters()),
           "layers": cfg.n_layers, "published_layers": published.n_layers,
           "depth_cut": depth_cut or "none",
           "prefix_embeds": 0 if embeds is None else cfg.n_prefix, "pos_emb": cfg.pos_emb,
           "prompt": prompt_len, "new_tokens": PARITY_NEW, "tolerance": LM_PARITY_TOL,
           "prefill_logits_max_abs_diff": diffs[0], "step_logits_max_abs_diff": diffs,
           "cpu_top2_gaps": gaps, "tokens_card": gpu_toks, "tokens_cpu": cpu_toks,
           "tokens": verdict, "launches": {kernel: kernel_launches},
           "logits_held_steps": len(held), "card": smi}
    suspicious = 0
    if routing is not None:
        suspicious = sum(g > ROUTE_FLIP_MARGIN for g in routing["flip_gaps"])
        out["routing"] = {"top_k": cfg.experts_per_token, "experts": cfg.n_experts,
                          "steps_compared": compared, "flips_per_step": routing["flips"],
                          "flip_cpu_gaps": routing["flip_gaps"],
                          "smallest_cpu_gap": routing["smallest_gap"],
                          "flips_above_margin": suspicious, "margin": ROUTE_FLIP_MARGIN}
    out["ok"] = (verdict != "mismatch" and kernel_launches == kernel_layers(cfg, kernel)
                 and all(d <= LM_PARITY_TOL for d in held)
                 and suspicious <= ROUTE_FLIPS_MAX)
    emit(out)
    del params
    torch.cuda.empty_cache()
    if not out["ok"]:
        raise AssertionError(f"{phase}: the model on the card and on the CPU disagree")
    return out


def _recorded(routed, calls: list):
    """``routed`` (``_route``'s result), its full gates kept on the host."""
    calls.append(routed[3].float().cpu())
    return routed


def phase_serve(torch, smi: str, params, arch: str, kernel: str,
                requests: int = SERVE_REQUESTS, new_tokens: int = SERVE_NEW,
                phase: str = "serve", cfg=None) -> dict:
    """The LM serving path of ``arch`` (or of ``cfg``, a padded config of
    it) at full width in bf16; every count set to 0 just before and read
    just after, and ``kernel`` launched at least once per layer and
    micro-batch; ``mfu`` from the serve's wall seconds."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch.serve import serve

    cfg = cfg or get_config(arch)
    prompts = np.random.default_rng([SEED, 4]).integers(
        0, cfg.vocab_size, (requests, SERVE_PROMPT))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    res = serve(cfg, params, prompts, new_tokens=new_tokens, partitions=SERVE_PARTITIONS,
                batch_max=SERVE_BATCH, device=DEVICE)
    n_launches = launches(kernel)
    work = training_work()
    peak = torch.cuda.max_memory_allocated()
    lat = [x * 1e3 for x in res.lpx_s]
    n_batches = len(res.batches)
    out = {"phase": phase, "arch": arch, "dtype": cfg.dtype, "requests": requests,
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
           "launches": {kernel: n_launches}, "training_work": work,
           "max_memory_allocated_bytes": peak,
           **mfu(serve_flops(cfg, requests, SERVE_PROMPT, new_tokens), res.wall_s),
           "card": smi}
    emit(out)
    problems = []
    if any(work.values()):
        problems.append(f"serving wrote lse, kept K4's span states or ran a backward: {work}")
    if res.processed != requests:
        problems.append(f"answered {res.processed}/{requests}")
    if not ((res.tokens >= 0) & (res.tokens < cfg.vocab_size)).all():
        problems.append("tokens missing or outside the vocabulary")
    if n_launches < kernel_layers(cfg, kernel) * n_batches:
        problems.append(f"{kernel} launched {n_launches} < {kernel_layers(cfg, kernel)} x "
                        f"{n_batches} times")
    if problems:
        raise AssertionError(f"{phase}: {problems}")
    return out


def phase_serve_alone(torch, smi: str, params, arch: str,
                      phase: str = "serve-alone") -> dict:
    """One micro-batch (SERVE_BATCH prompts of SERVE_PROMPT tokens) through
    prefill and greedy decode in this one thread, with no engine: the
    model's own time, beside which the serve phase's per-step times show
    what its consumer threads add."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import model as M

    cfg = get_config(arch)
    prompts = torch.from_numpy(np.random.default_rng([SEED, 5]).integers(
        0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT))).to(DEVICE)
    reset_counts()
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
    work = training_work()
    out = {"phase": phase, "arch": arch, "batch": SERVE_BATCH, "prompt": SERVE_PROMPT,
           "new_tokens": SERVE_NEW, "prefill_ms": (t1 - t0) * 1e3,
           "decode_ms_per_step": (t2 - t1) * 1e3 / (SERVE_NEW - 1), "training_work": work,
           "card": smi}
    emit(out)
    if tuple(toks.shape) != (SERVE_BATCH, SERVE_NEW):
        raise AssertionError(f"{phase}: tokens of shape {tuple(toks.shape)}")
    if any(work.values()):
        raise AssertionError(f"{phase}: serving did training's work: {work}")
    return out


def phase_arch_configs(torch, smi: str, k3: dict | None) -> dict:
    """Each of ARCH_CONFIGS at its published width, cut to ARCH_LAYERS
    layers, in bf16 with random weights from SEED: one prefill of
    SERVE_BATCH x SERVE_PROMPT tokens (a frontend config's first
    ``n_prefix`` positions take embeddings drawn in numpy from SEED), then
    ARCH_NEW greedy tokens.  Finite logits, tokens inside the vocabulary,
    K3 launched once a layer by the prefill, and K3 held against
    ``mha_ref`` at that prefill's shape by the kernel-K3 phase (``k3``).
    An MoE config's row also gives its experts, top-k and the capacity of
    its prefill."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import model as M
    from repro_torch.models.moe import moe_capacity

    rows, problems = {}, []
    for arch in ARCH_CONFIGS:
        published = get_config(arch)
        cfg = dataclasses.replace(published, n_layers=ARCH_LAYERS)
        params = M.init_params(cfg, torch.Generator(device=DEVICE).manual_seed(SEED), DEVICE)
        rng = np.random.default_rng([SEED, 7])
        prompts = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                                (SERVE_BATCH, SERVE_PROMPT))).to(DEVICE)
        embeds = None
        if cfg.frontend is not None:
            embeds = torch.from_numpy(rng.standard_normal(
                (SERVE_BATCH, cfg.n_prefix, cfg.d_model), dtype=np.float32)).to(DEVICE)
        before = launches("flash_attention")
        with torch.inference_mode():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, caches = M.prefill(params, cfg, prompts, SERVE_PROMPT + ARCH_NEW,
                                       embeds=embeds)
            first = torch.argmax(logits, dim=-1)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            n_launches = launches("flash_attention") - before
            toks = M.decode_greedy(params, cfg, first, caches, SERVE_PROMPT, ARCH_NEW)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
        finite = bool(torch.isfinite(logits).all())
        k3_row = (k3 or {}).get(fa_prefill_shape(cfg) + (cfg.dtype,))
        k3_ok = k3_row is not None and k3_row["ok"]
        in_vocab = bool(((toks >= 0) & (toks < cfg.vocab_size)).all())
        row = {"phase": "arch-configs", "arch": arch, "dtype": cfg.dtype,
               "layers": cfg.n_layers, "published_layers": published.n_layers,
               "depth_cut": f"{ARCH_LAYERS} of {published.n_layers} layers; width as "
                            f"published", "d_model": cfg.d_model, "heads": cfg.n_heads,
               "kv_heads": cfg.n_kv_heads, "d_head": cfg.head_dim, "d_ff": cfg.d_ff,
               "vocab": cfg.vocab_size,
               "params": sum(t.numel() for t in params.parameters()),
               "batch": SERVE_BATCH, "prompt": SERVE_PROMPT,
               "prefix_embeds": 0 if embeds is None else cfg.n_prefix,
               "new_tokens": ARCH_NEW, "prefill_ms": (t1 - t0) * 1e3,
               "decode_ms_per_step": (t2 - t1) * 1e3 / (ARCH_NEW - 1),
               "finite_logits": finite, "tokens_in_vocab": in_vocab,
               "tokens_shape": list(toks.shape), "launches": {"flash_attention": n_launches},
               "k3_shape": list(fa_prefill_shape(cfg)),
               "k3_max_abs_err": None if k3_row is None else k3_row["max_abs_err"],
               "k3_against_plain": k3_ok, "card": smi}
        if cfg.n_experts:
            row["moe"] = {"experts": cfg.n_experts, "top_k": cfg.experts_per_token,
                          "d_ff_expert": cfg.d_ff,
                          "capacity": moe_capacity(cfg, SERVE_PROMPT)}
        emit(row)
        rows[arch] = row
        if not (finite and in_vocab and k3_ok
                and n_launches == kernel_layers(cfg, "flash_attention")
                and tuple(toks.shape) == (SERVE_BATCH, ARCH_NEW)):
            problems.append(arch)
        del params, caches, logits, embeds
        torch.cuda.empty_cache()
    if problems:
        raise AssertionError(f"arch-configs: {problems} failed their checks")
    return rows


def serve_params(torch, arch: str):
    """Full-width ``arch`` weights in bf16, drawn on the card from SEED."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import model as M

    return M.init_params(get_config(arch),
                         torch.Generator(device=DEVICE).manual_seed(SEED), DEVICE)


def model_spans(cfg) -> dict:
    """The plain-torch stages of ``cfg``'s layers that a profile times as
    spans: the RG-LRU scan, and the MoE layer's routing, dispatch, expert
    GEMMs and combine."""
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import rglru as rglru_mod

    named = {}
    if "rglru" in cfg.layer_kinds:
        named["rglru.scan"] = (rglru_mod, "_scan")
    if "moe" in cfg.layer_kinds:
        named.update({"moe.route": (moe_mod, "_route"), "moe.dispatch": (moe_mod, "_dispatch"),
                      "moe.expert_ffn": (moe_mod, "_expert_ffn"),
                      "moe.combine": (moe_mod, "_combine")})
    return named


def gemm_device_ms(rows: list[dict]) -> float:
    """Summed device time of the matrix-product kernels among ``rows``."""
    return sum(r["device_ms"] for r in rows
               if re.search(r"gemm|gemv|nvjet|xmma|cutlass", r["name"], re.I))


def micro_batch_spans(torch, params, arch: str, kernel: str, named: dict) -> dict:
    """One micro-batch (SERVE_BATCH prompts of SERVE_PROMPT tokens, prefill
    and SERVE_NEW greedy tokens) in this thread under ``torch.profiler``,
    the model's stages ``named`` as spans: each span's device ms beside
    the run's summed device ms, ``kernel``'s and the GEMMs'.  The serve's
    consumer threads give no spans (the profiler records host-side ranges
    only on the thread that runs it)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.base import get_config
    from repro_torch.models import model as M

    cfg = get_config(arch)
    prompts = torch.from_numpy(np.random.default_rng([SEED, 5]).integers(
        0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT))).to(DEVICE)
    with torch.inference_mode():
        M.greedy_generate(params, cfg, prompts, 2)              # warm-up
        torch.cuda.synchronize()
        with spans(torch, named), profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            M.greedy_generate(params, cfg, prompts, SERVE_NEW)
            torch.cuda.synchronize()
    rows = device_time_rows(prof)
    return {"batch": SERVE_BATCH, "prompt": SERVE_PROMPT, "new_tokens": SERVE_NEW,
            "device_ms": sum(r["device_ms"] for r in rows) if rows else "not measured",
            f"{kernel}_device_ms": kernel_device_ms(rows, kernel) if rows else "not measured",
            "matmul_device_ms": gemm_device_ms(rows) if rows else "not measured",
            "spans": span_device_ms(prof, named)}


def phase_serve_profile(torch, smi: str, params, arch: str, kernel: str,
                        phase: str = "serve-profile",
                        serve_phase: str = "profiled-serve") -> dict:
    """Where the time of the serving path goes: a shorter serve run under
    ``torch.profiler``; device time by kernel (``kernel``'s and the matrix
    products' summed), host self time by op, and the busy share = summed
    device self time over the run's wall time; for a config with
    plain-torch stages worth naming (``model_spans``), their device time in
    one micro-batch (``micro_batch_spans``)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.base import get_config

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run = phase_serve(torch, smi, params, arch, kernel, PROFILE_REQUESTS, PROFILE_NEW,
                          serve_phase)
    rows = device_time_rows(prof)
    device_ms = sum(r["device_ms"] for r in rows)
    kernel_ms = kernel_device_ms(rows, kernel)
    gemm_ms = gemm_device_ms(rows)
    host = sorted(averages(prof), key=lambda ev: -ev.self_cpu_time_total)
    wall_ms = run["wall_s"] * 1e3
    measured = bool(rows)
    out = {"phase": phase, "arch": arch, "requests": PROFILE_REQUESTS,
           "new_tokens": PROFILE_NEW, "wall_ms": wall_ms,
           "device_ms": device_ms if measured else "not measured",
           "device_busy_share": busy_share(device_ms, wall_ms) if measured else "not measured",
           f"{kernel}_device_ms": kernel_ms if measured else "not measured",
           "matmul_device_ms": gemm_ms if measured else "not measured",
           "top": rows[:16],
           "top_host": [{"name": ev.key[:96], "calls": ev.count,
                         "host_self_ms": ev.self_cpu_time_total / 1e3} for ev in host[:12]],
           "card": smi}
    named = model_spans(get_config(arch))
    if named:
        out["micro_batch"] = micro_batch_spans(torch, params, arch, kernel, named)
    emit(out)
    return out


# -- training ----------------------------------------------------------------------

def fa_bwd_bound(bh: int, bkv: int, s: int, dh: int, bytes_per_el: int, window: int = 0):
    """(least ms, what bounds it, ms of the operations at the f32 CUDA-core
    rate) of K3's backward: q, k, v, the output, dO and lse read once and
    dq, dk, dv written once at the HBM rate, against five products over the
    visible (query, key) pairs of each q row (QK^T, dO V^T, P^T dO, dS K,
    dS^T Q; 2 Dh operations each, 2.5x the forward's two) on the tensor
    cores (``product_ms``: bf16, or f32 in 3xTF32)."""
    t_bytes = ((4 * bh + 4 * bkv) * s * dh * bytes_per_el + 4 * bh * s) / peak("hbm_bw") * 1e3
    ops = 10.0 * bh * visible_pairs(s, window) * dh
    t_ops = product_ms(ops, bytes_per_el)
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            ops / peak("f32_flops") * 1e3)


def phase_kernel_k3_bwd(torch, smi: str) -> dict:
    """K3's backward against ``mha_bwd_ref`` on the same inputs (the
    forward's own output and lse), twice (the same bits), with CUDA-event
    times beside the bound, the plain version's, and the backward of SDPA
    through ``torch.autograd.grad`` on a kept graph (its forward outside the
    timed region), and the forward's without and with lse (the serving and
    the training launch); each row's worst error as a share of the
    tolerance, each CUDA kernel's device ms, and the route taken (bf16 rows,
    all of whose Dh are multiples of 8, must take TMA's)."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import lse_ref, mha_bwd_ref

    torch.backends.cuda.matmul.allow_tf32 = False     # mha_bwd_ref's products in full f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    results, failed = {}, []
    for bh, bkv, s, dh, window, dtype_name in FA_BWD_SHAPES:
        dtype = getattr(torch, dtype_name)
        rtol, share = FA_BWD_TOLERANCE[dtype_name]
        q, k, v, do = (torch.randn((n, s, dh), generator=gen, device=dev).to(dtype)
                       for n in (bh, bkv, bkv, bh))
        out, lse = fa_ops._forward(q, k, v, window, with_lse=True)
        routes = dict(fa_ops.BWD_ROUTES)
        got = fa_ops.flash_attention_bwd(q, k, v, out, do, lse, window)
        route = [r for r, n in fa_ops.BWD_ROUTES.items() if n != routes[r]]
        again = fa_ops.flash_attention_bwd(q, k, v, out, do, lse, window)
        want = mha_bwd_ref(q, k, v, out, do, lse, window=window)
        lse_err = float((lse - lse_ref(q, k, window=window)).abs().max())
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        errs, shares = {}, {}
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            g, w = g.float(), w.float()
            diff = (g - w).abs()
            errs[name] = float(diff.max())
            shares[name] = float((diff / (share * w.abs().max() + rtol * w.abs())).max())
        want_route = ["f32"] if dtype_name == "float32" else ["tma"]
        ok = same and max(shares.values()) <= 1.0 and lse_err <= 1e-5 and route == want_route
        q4, k4, v4 = (t[None].detach().requires_grad_(True) for t in (q, k, v))
        if 0 < window < s:
            idx = torch.arange(s, device=dev)
            mask = (idx[None, :] <= idx[:, None]) & (idx[None, :] > idx[:, None] - window)
            o4 = sdpa(q4, k4, v4, attn_mask=mask, enable_gqa=True)
        else:
            o4 = sdpa(q4, k4, v4, is_causal=True, enable_gqa=True)
        do4 = do[None]
        bound_ms, by, f32_core_ms = fa_bwd_bound(bh, bkv, s, dh, q.element_size(), window)
        row = {"phase": "kernel-K3-bwd", "bh": bh, "bkv": bkv, "s": s, "dh": dh,
               "window": window, "dtype": dtype_name, "ok": ok, "bit_identical": same,
               "tolerance": {"rtol": rtol, "atol_share_of_max": share},
               "max_abs_err": max(errs.values()), "max_abs_err_by_grad": errs,
               "worst_to_tolerance": max(shares.values()), "lse_max_abs_err": lse_err,
               "ms": cuda_ms(torch, lambda: fa_ops.flash_attention_bwd(
                   q, k, v, out, do, lse, window)),
               "plain_ms": cuda_ms(torch, lambda: mha_bwd_ref(q, k, v, out, do, lse,
                                                             window=window), iters=10),
               "library_ms": cuda_ms(torch, lambda: torch.autograd.grad(
                   o4, (q4, k4, v4), do4, retain_graph=True)),
               "forward_ms": cuda_ms(torch, lambda: fa_ops.flash_attention(
                   q, k, v, window=window)),
               "forward_lse_ms": cuda_ms(torch, lambda: fa_ops._forward(
                   q, k, v, window, with_lse=True)),
               "bound_ms": bound_ms, "bound_by": by, "f32_core_ms": f32_core_ms,
               "route": route,
               "device_ms_by_kernel": device_ms_by_kernel(
                   torch, lambda: fa_ops.flash_attention_bwd(q, k, v, out, do, lse, window),
                   FA_BWD_KERNELS[dtype_name], calls=5),
               "card": smi}
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        emit(row)
        results[(bh, bkv, s, dh, window, dtype_name)] = row
        if not ok:
            failed.append((bh, bkv, s, dh, window, dtype_name))
        del q, k, v, do, out, lse, got, again, want, q4, k4, v4, o4
        torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"K3's backward disagrees with mha_bwd_ref or repeats "
                             f"inexactly at {failed}")
    return results


def phase_train_parity(torch, smi: str, arch: str = TRAIN_ARCH, kernel: str = "flash_attention",
                       phase: str = "train-parity") -> dict:
    """``loss_fn`` and its gradient for full-width ``arch`` cut to
    TRAIN_PARITY_LAYERS layers, float32, one SyntheticLM batch: on the card
    (``kernel`` and its backward kernels) against the same weights on the
    CPU (the plain versions), the loss within rtol 1e-5 and every gradient
    leaf within 1e-4 of its largest entry + 1e-6; ``kernel`` backward once
    a layer that runs it and its forward as ``forward_launches`` counts it
    (twice in a layer of a checkpointed group: the registered remat)."""
    import copy

    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import model as M
    from repro_torch.training.train_loop import batch_to

    cfg = dataclasses.replace(get_config(arch), n_layers=TRAIN_PARITY_LAYERS, dtype="float32")
    cpu = M.init_params(cfg, torch.Generator().manual_seed(SEED), "cpu")
    cpu.requires_grad_(True)
    card = copy.deepcopy(cpu).to(DEVICE)
    batch = SyntheticLM(cfg.vocab_size, TRAIN_PARITY_SEQ, TRAIN_PARITY_BATCH,
                        seed=SEED).batch_at(0)
    out = {}
    reset_counts()
    for name, params, dev in (("card", card, DEVICE), ("cpu", cpu, "cpu")):
        t0 = time.perf_counter()
        loss = M.loss_fn(params, cfg, batch_to(batch, dev))
        grads = torch.autograd.grad(loss, list(params.parameters()))
        out[name] = (float(loss.detach()), [g.detach().cpu() for g in grads],
                     time.perf_counter() - t0)
    counts = {k: launches(k) for k in (kernel, f"{kernel}_bwd")}
    names = [n for n, _ in cpu.named_parameters()]
    worst = {n: float((g - w).abs().max()) / (1e-4 * float(w.abs().max()) + 1e-6)
             for n, g, w in zip(names, out["card"][1], out["cpu"][1])}
    loss_rel = abs(out["card"][0] - out["cpu"][0]) / abs(out["cpu"][0])
    row = {"phase": phase, "arch": arch, "dtype": "float32", "remat": cfg.remat,
           "layers": cfg.n_layers, "batch": TRAIN_PARITY_BATCH, "seq": TRAIN_PARITY_SEQ,
           "loss_card": out["card"][0], "loss_cpu": out["cpu"][0], "loss_rel_err": loss_rel,
           "leaves": len(names), "worst_leaf_to_tolerance": max(worst.values()),
           "worst_leaf": max(worst, key=worst.get), "launches": counts,
           "card_s": out["card"][2], "cpu_s": out["cpu"][2], "card": smi}
    emit(row)
    n = kernel_layers(cfg, kernel)
    if not (loss_rel <= 1e-5 and max(worst.values()) <= 1.0 and n >= 1
            and counts == {kernel: forward_launches(cfg, kernel), f"{kernel}_bwd": n}):
        raise AssertionError(f"{phase}: {row}")
    return row


# the device-time families of a training step: each kernel's forward and
# backward, by the wrapper's kernel names (kernel_device_ms) and the backward's
BWD_KERNEL_RE = {"flash_attention": r"\bfa_bwd_\w+_kernel\b",
                 "ssd_scan": r"\bssd_bwd_\w+_kernel\b"}
FAMILY = {"flash_attention": "k3", "ssd_scan": "k4"}


def train_step_profile(torch, cfg, params, opt_state, batch,
                       kernel: str = "flash_attention") -> dict:
    """One training step under ``torch.profiler``: its wall ms, the
    device's busy share, device ms by kernel family (``kernel``'s forward
    and backward, the GEMMs, the rest), each CUDA kernel of the two
    families with its recorded launches and ms a launch, the device ms of
    ``loss_fn``'s forward and of AdamW (``record_function`` spans), and the
    host's top ops."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import model as M
    from repro_torch.training import train_loop
    from repro_torch.training.optimizer import OptimizerConfig

    step = train_loop.make_train_step(cfg, OptimizerConfig(), TRAIN_MICRO)
    named = {"loss_fn.forward": (M, "loss_fn"), "adamw": (train_loop, "adamw_step")}
    torch.cuda.synchronize()
    with spans(torch, named), profile(activities=[ProfilerActivity.CPU,
                                                  ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(params, opt_state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = device_time_rows(prof)
    device_ms = sum(r["device_ms"] for r in rows)
    fwd = kernel_device_ms(rows, kernel)
    bwd = sum(r["device_ms"] for r in rows if re.search(BWD_KERNEL_RE[kernel], r["name"]))
    gemm = gemm_device_ms(rows)
    family = FAMILY[kernel]
    launched, summed = {}, {}       # by kernel name, its template instances together
    for r in rows:
        m = (re.search(rf"\b{kernel}(_\w+)?_kernel\b", r["name"])
             or re.search(BWD_KERNEL_RE[kernel], r["name"]))
        if m:
            launched[m.group(0)] = launched.get(m.group(0), 0) + r["calls"]
            summed[m.group(0)] = summed.get(m.group(0), 0.0) + r["device_ms"]
    by_kernel = {k: {"launches": n, "ms_per_launch": summed[k] / n} for k, n in launched.items()}
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "busy_share": busy_share(device_ms, wall_ms),
            "device_ms_by_family": {f"{family}_forward": fwd, f"{family}_backward": bwd,
                                    "gemm": gemm, "other": device_ms - fwd - bwd - gemm},
            "device_ms_by_kernel": by_kernel,
            "spans": span_device_ms(prof, named), "top_device": rows[:8],
            "top_host": host_time_rows(prof, top=6)}


def phase_train_lm(torch, smi: str, arch: str = TRAIN_ARCH, kernel: str = "flash_attention",
                   phase: str = "train-qwen2") -> dict:
    """``launch.train.train`` on ``arch`` at full width and depth (bf16,
    random weights from SEED): TRAIN_STEPS steps of TRAIN_BATCH x TRAIN_SEQ
    tokens in TRAIN_MICRO microbatches, a checkpoint at TRAIN_CKPT (and at
    the end); then a second run from a directory holding only that
    checkpoint, which resumes there and redoes the steps after it.  The loss
    must fall (the mean of the last 5 below the first), the restart must be
    bit-exact (losses, parameters and moments), and ``kernel`` backward
    must launch once a layer that runs it and microbatch a step run, its
    forward ``forward_launches`` times a microbatch (twice a layer under the
    registered remat ``"full"``: the backward recomputes each layer) with
    every forward launch writing lse (K3; every backward on TMA's route) or
    keeping its span states (K4); counts set to 0 just before the first run
    and read just after the second."""
    import shutil

    from repro_torch.configs.base import get_config
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.launch.train import train

    cfg = get_config(arch)
    root = ROOT / "build" / "chip_smoke_train"
    shutil.rmtree(root, ignore_errors=True)
    kw = dict(steps=TRAIN_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ, microbatches=TRAIN_MICRO,
              ckpt_every=TRAIN_CKPT, seed=SEED, device=DEVICE, log=lambda line: None)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    first = train(cfg, ckpt_dir=str(root / "a"), **kw)
    t1 = time.perf_counter()
    ckpt = f"step_{TRAIN_CKPT:09d}"
    shutil.copytree(root / "a" / ckpt, root / "b" / ckpt, copy_function=os.link)
    shutil.rmtree(root / "a")           # ~5 GB a checkpoint: keep at most two on disk
    second = train(cfg, ckpt_dir=str(root / "b"), **kw)
    t2 = time.perf_counter()
    counts = {k: launches(k) for k in (kernel, f"{kernel}_bwd")}
    routes = dict(fa_ops.BWD_ROUTES)
    lse_writes = fa_ops.LSE_WRITES["flash_attention"]
    states_kept = ssd_ops.STATES_KEPT["ssd_scan"]
    same_params = all(torch.equal(a, b) for a, b in zip(first.params.parameters(),
                                                        second.params.parameters()))
    same_moments = all(torch.equal(first.opt_state.mu[n], second.opt_state.mu[n])
                       and torch.equal(first.opt_state.nu[n], second.opt_state.nu[n])
                       for n in first.opt_state.mu)
    steps_run = (TRAIN_STEPS - first.start) + (TRAIN_STEPS - second.start)
    want = kernel_layers(cfg, kernel) * TRAIN_MICRO * steps_run
    want_fwd = forward_launches(cfg, kernel) * TRAIN_MICRO * steps_run
    step_ms = sorted(x * 1e3 for x in first.step_s[1:])          # the first step warms up
    row = {"phase": phase, "arch": arch, "dtype": cfg.dtype, "remat": cfg.remat,
           "layers": cfg.n_layers, "params": sum(p.numel() for p in first.params.parameters()),
           "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "microbatches": TRAIN_MICRO,
           "steps": TRAIN_STEPS, "checkpoint_step": TRAIN_CKPT, "restart_from": second.start,
           "losses": first.losses, "losses_after_restart": second.losses,
           "restart_bit_exact": {"losses": second.losses == first.losses[TRAIN_CKPT:],
                                 "params": same_params, "moments": same_moments},
           "ms_per_step": {"median": step_ms[len(step_ms) // 2], "min": step_ms[0],
                           "first": first.step_s[0] * 1e3},
           "tokens_per_s": first.tokens_per_s,
           **mfu(train_flops(cfg, TRAIN_BATCH, TRAIN_SEQ),
                 TRAIN_BATCH * TRAIN_SEQ / first.tokens_per_s),
           "peak_allocated_bytes": max(first.peak_bytes, second.peak_bytes),
           "launches": counts, "bwd_routes": routes, "lse_writes": lse_writes,
           "ssd_states_kept": states_kept, "steps_run": steps_run,
           "first_run_s": t1 - t0, "restart_run_s": t2 - t1,
           "deterministic_algorithms": torch.are_deterministic_algorithms_enabled(),
           "card": smi}
    emit(row)
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.training.optimizer import OptimizerConfig
    from repro_torch.training.train_loop import batch_to, make_train_step

    data = SyntheticLM(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=SEED)
    batch = batch_to(data.batch_at(TRAIN_STEPS), DEVICE)
    # what the remat costs a step, on the host and on the device
    make_train_step(dataclasses.replace(cfg, remat="none"), OptimizerConfig(), TRAIN_MICRO)(
        second.params, second.opt_state, batch)
    for policy in ("none", cfg.remat):
        emit({"phase": f"{phase}-profile", "arch": arch, "step": TRAIN_STEPS, "remat": policy,
              **train_step_profile(torch, dataclasses.replace(cfg, remat=policy),
                                   second.params, second.opt_state, batch, kernel),
              "card": smi})
    del first, second
    shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    problems = []
    if not np.mean(row["losses"][-5:]) < row["losses"][0]:
        problems.append("the loss did not fall")
    if not all(row["restart_bit_exact"].values()):
        problems.append(f"restart not bit-exact: {row['restart_bit_exact']}")
    kept = lse_writes if kernel == "flash_attention" else states_kept
    if want < 1 or counts != {kernel: want_fwd, f"{kernel}_bwd": want} or kept != want_fwd:
        problems.append(f"{kernel} launches {counts}, forwards keeping what the backward "
                        f"reads {kept}, want {want_fwd} forward (and kept), {want} backward")
    if routes != ({"tma": want, "copy": 0, "f32": 0} if kernel == "flash_attention"
                  else {"tma": 0, "copy": 0, "f32": 0}):
        problems.append(f"K3 backward routes {routes}")
    if problems:
        raise AssertionError(f"{phase}: {problems}")
    return row


def phase_train_recurrentgemma(torch, smi: str) -> dict:
    """``launch.train.train`` on RecurrentGemma-2B at full width and depth
    (26 layers, 8 of them local attention at Dh 256; bf16, random weights
    from SEED): TRAIN_RG_STEPS steps of TRAIN_RG_BATCH x TRAIN_RG_SEQ tokens
    in TRAIN_RG_MICRO microbatches, no checkpoint.  The loss must fall (the
    mean of the last 3 below the first), and K3 backward must launch once
    per attention layer and microbatch a step, every backward on the TMA
    route, and its forward (writing lse) ``forward_launches`` times a
    microbatch (its 8 attention layers are all in checkpointed groups, so
    twice each under the registered remat); counts set to 0 just before the
    run and read just after."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch.train import train

    cfg = get_config(HYBRID_ARCH)
    attn = kernel_layers(cfg, "flash_attention")
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    res = train(cfg, steps=TRAIN_RG_STEPS, batch=TRAIN_RG_BATCH, seq=TRAIN_RG_SEQ,
                microbatches=TRAIN_RG_MICRO, seed=SEED, device=DEVICE, log=lambda line: None)
    run_s = time.perf_counter() - t0
    counts = {k: launches(k) for k in ("flash_attention", "flash_attention_bwd")}
    routes = dict(fa_ops.BWD_ROUTES)
    lse_writes = fa_ops.LSE_WRITES["flash_attention"]
    want = attn * TRAIN_RG_MICRO * TRAIN_RG_STEPS
    want_fwd = forward_launches(cfg, "flash_attention") * TRAIN_RG_MICRO * TRAIN_RG_STEPS
    step_ms = sorted(x * 1e3 for x in res.step_s[1:])           # the first step warms up
    row = {"phase": "train-recurrentgemma", "arch": HYBRID_ARCH, "dtype": cfg.dtype,
           "remat": cfg.remat,
           "layers": cfg.n_layers, "attention_layers": attn,
           "params": sum(p.numel() for p in res.params.parameters()),
           "batch": TRAIN_RG_BATCH, "seq": TRAIN_RG_SEQ, "microbatches": TRAIN_RG_MICRO,
           "steps": TRAIN_RG_STEPS, "losses": res.losses,
           "ms_per_step": {"median": step_ms[len(step_ms) // 2], "min": step_ms[0],
                           "first": res.step_s[0] * 1e3},
           "tokens_per_s": res.tokens_per_s, "peak_allocated_bytes": res.peak_bytes,
           "launches": counts, "bwd_routes": routes, "lse_writes": lse_writes, "run_s": run_s,
           "card": smi}
    emit(row)
    del res
    torch.cuda.empty_cache()
    problems = []
    if not np.mean(row["losses"][-3:]) < row["losses"][0]:
        problems.append("the loss did not fall")
    if (counts != {"flash_attention": want_fwd, "flash_attention_bwd": want}
            or lse_writes != want_fwd):
        problems.append(f"K3 launches {counts}, lse writes {lse_writes}, want {want_fwd} "
                        f"forward (and lse), {want} backward")
    if routes != {"tma": want, "copy": 0, "f32": 0}:
        problems.append(f"backward routes {routes}, want {want} on TMA's")
    if problems:
        raise AssertionError(f"train-recurrentgemma: {problems}")
    return row


def phase_train_remat(torch, smi: str) -> dict:
    """One ``make_train_step`` step of each REMAT_ARCHS config at published
    width cut to its layers (bf16, weights from SEED, REMAT_BATCH x
    REMAT_SEQ tokens in REMAT_MICRO microbatches, AdamW), from the same
    parameters and batch under each of REMAT_POLICIES: the loss, every
    updated parameter and both moments ``torch.equal`` across the policies;
    K3's and K4's backward once a layer that runs it and microbatch, their
    forward ``forward_launches`` times a microbatch under each policy (each
    forward launch writing lse or keeping its span states, every K3
    backward on the TMA route); the step's peak allocated bytes under each
    policy, above what was allocated when it began (``step_bytes``), lower
    under ``full`` than under ``none``; and the activation bytes a layer,
    (step_bytes under ``none`` - under ``full``) / the checkpointed
    layers."""
    import copy

    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.models import model as M
    from repro_torch.training.optimizer import OptimizerConfig, init_opt_state
    from repro_torch.training.train_loop import batch_to, make_train_step

    names = ("flash_attention", "flash_attention_bwd", "ssd_scan", "ssd_scan_bwd")
    rows, problems = {}, []
    for arch, layers in REMAT_ARCHS.items():
        base = dataclasses.replace(get_config(arch), n_layers=layers)
        pristine = M.init_params(base, torch.Generator(device=DEVICE).manual_seed(SEED), DEVICE)
        data = SyntheticLM(base.vocab_size, REMAT_SEQ, REMAT_BATCH, seed=SEED,
                           n_prefix=base.n_prefix if base.frontend else 0,
                           d_model=base.d_model if base.frontend else 0)
        batch = batch_to(data.batch_at(0), DEVICE)
        done, policies = {}, {}
        for policy in REMAT_POLICIES:
            cfg = dataclasses.replace(base, remat=policy)
            params = copy.deepcopy(pristine).requires_grad_(True)
            state = init_opt_state(params)
            step = make_train_step(cfg, OptimizerConfig(lr=1e-3, warmup_steps=1), REMAT_MICRO)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            t0 = time.perf_counter()
            params, state, metrics = step(params, state, batch)
            loss = float(metrics["loss"])
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            peak = torch.cuda.max_memory_allocated()
            done[policy] = (metrics["loss"], dict(params.named_parameters()), state)
            policies[policy] = {
                "loss": loss, "grad_norm": float(metrics["grad_norm"]), "step_ms": ms,
                "peak_allocated_bytes": peak, "step_bytes": peak - before,
                "launches": {k: launches(k) for k in names},
                "lse_writes": fa_ops.LSE_WRITES["flash_attention"],
                "ssd_states_kept": ssd_ops.STATES_KEPT["ssd_scan"],
                "bwd_routes": dict(fa_ops.BWD_ROUTES)}
            del params, state, metrics, step
        loss0, params0, state0 = done["none"]
        bit_equal = {policy: {
            "loss": bool(torch.equal(done[policy][0], loss0)),
            "params": all(torch.equal(done[policy][1][n], t) for n, t in params0.items()),
            "moments": all(torch.equal(done[policy][2].mu[n], state0.mu[n])
                           and torch.equal(done[policy][2].nu[n], state0.nu[n])
                           for n in params0)} for policy in REMAT_POLICIES if policy != "none"}
        wrapped = wrapped_layers(base)
        row = {"phase": "train-remat", "arch": arch, "dtype": base.dtype, "layers": layers,
               "wrapped_layers": wrapped, "group": len(base.block_pattern),
               "params": sum(p.numel() for p in pristine.parameters()),
               "batch": REMAT_BATCH, "seq": REMAT_SEQ, "microbatches": REMAT_MICRO,
               "policies": policies, "bit_equal_to_none": bit_equal,
               "activation_bytes_per_layer": (policies["none"]["step_bytes"]
                                              - policies["full"]["step_bytes"]) / wrapped,
               "card": smi}
        emit(row)
        rows[arch] = row
        for policy, got in policies.items():
            cfg = dataclasses.replace(base, remat=policy)
            attn, ssm = kernel_layers(cfg, "flash_attention"), kernel_layers(cfg, "ssd_scan")
            fa_fwd = forward_launches(cfg, "flash_attention") * REMAT_MICRO
            ssd_fwd = forward_launches(cfg, "ssd_scan") * REMAT_MICRO
            want = dict(zip(names, (fa_fwd, attn * REMAT_MICRO, ssd_fwd, ssm * REMAT_MICRO)))
            if not (np.isfinite(got["loss"]) and attn + ssm >= 1 and got["launches"] == want
                    and got["lse_writes"] == fa_fwd and got["ssd_states_kept"] == ssd_fwd
                    and got["bwd_routes"] == {"tma": attn * REMAT_MICRO, "copy": 0, "f32": 0}):
                problems.append(f"{arch} under {policy}: launches {got['launches']}, lse "
                                f"{got['lse_writes']}, states {got['ssd_states_kept']}, routes "
                                f"{got['bwd_routes']}, want {want}")
        if not all(all(v.values()) for v in bit_equal.values()):
            problems.append(f"{arch}: not bit-equal across the policies: {bit_equal}")
        if not policies["full"]["step_bytes"] < policies["none"]["step_bytes"]:
            problems.append(f"{arch}: full's step bytes not below none's")
        del pristine, batch, done, params0, state0, loss0
        torch.cuda.empty_cache()
    if problems:
        raise AssertionError(f"train-remat: {problems}")
    return rows


def none_peak_estimate(full_peak: int, remat_row: dict, cfg) -> float:
    """The peak allocated bytes a full-depth run of ``cfg`` would reach
    under ``"none"``, from its peak under ``"full"`` and ``train-remat``'s
    cut: each checkpointed layer keeps its activations instead of its
    input, except those of one group, which ``full`` holds while it
    recomputes it: full_peak + (step_bytes none - full at the cut) x
    (W - g) / (W_cut - g), W the checkpointed layers, g the group's."""
    g = remat_row["group"]
    cut = remat_row["policies"]
    return full_peak + ((cut["none"]["step_bytes"] - cut["full"]["step_bytes"])
                        * (wrapped_layers(cfg) - g) / (remat_row["wrapped_layers"] - g))


def phase_train_full_depth(torch, smi: str, remat_rows: dict | None) -> dict:
    """``launch.train.train`` on each FULL_DEPTH_ARCHS config at published
    width and depth (bf16, random weights from SEED, the registered remat
    ``"full"``): FULL_DEPTH_STEPS steps of FULL_DEPTH_BATCH x FULL_DEPTH_SEQ
    tokens in FULL_DEPTH_MICRO microbatches at FULL_DEPTH_LR, no checkpoint.  The first loss
    finite and within 0.1-3 x log V, the mean of the last 3 below it, the
    gradient norm finite and nonzero at every step, K3's backward once an
    attention layer and microbatch a step (every one on the TMA route) and
    its forward ``forward_launches`` times (writing lse), the peak under the
    card's 80 GB; with ``train-remat``'s cut of the config, the estimate of
    the peak under ``"none"`` (``none_peak_estimate``; never run)."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch.train import train

    rows, problems = {}, []
    for arch in FULL_DEPTH_ARCHS:
        cfg = get_config(arch)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reset_counts()
        t0 = time.perf_counter()
        res = train(cfg, steps=FULL_DEPTH_STEPS, batch=FULL_DEPTH_BATCH, seq=FULL_DEPTH_SEQ,
                    lr=FULL_DEPTH_LR, microbatches=FULL_DEPTH_MICRO, seed=SEED, device=DEVICE,
                    log=lambda line: None)
        run_s = time.perf_counter() - t0
        counts = {k: launches(k) for k in ("flash_attention", "flash_attention_bwd")}
        routes = dict(fa_ops.BWD_ROUTES)
        lse_writes = fa_ops.LSE_WRITES["flash_attention"]
        want = kernel_layers(cfg, "flash_attention") * FULL_DEPTH_MICRO * FULL_DEPTH_STEPS
        want_fwd = (forward_launches(cfg, "flash_attention") * FULL_DEPTH_MICRO
                    * FULL_DEPTH_STEPS)
        step_ms = sorted(x * 1e3 for x in res.step_s[1:])          # the first step warms up
        log_v = float(np.log(cfg.vocab_size))
        row = {"phase": "train-full-depth", "arch": arch, "dtype": cfg.dtype,
               "remat": cfg.remat, "layers": cfg.n_layers,
               "params": sum(p.numel() for p in res.params.parameters()),
               "batch": FULL_DEPTH_BATCH, "seq": FULL_DEPTH_SEQ,
               "microbatches": FULL_DEPTH_MICRO, "steps": FULL_DEPTH_STEPS, "lr": FULL_DEPTH_LR,
               "prefix_embeds": cfg.n_prefix if cfg.frontend else 0,
               "losses": res.losses, "log_vocab": log_v, "grad_norms": res.grad_norms,
               "ms_per_step": {"median": step_ms[len(step_ms) // 2], "min": step_ms[0],
                               "first": res.step_s[0] * 1e3},
               "tokens_per_s": res.tokens_per_s,
               **mfu(train_flops(cfg, FULL_DEPTH_BATCH, FULL_DEPTH_SEQ),
                     FULL_DEPTH_BATCH * FULL_DEPTH_SEQ / res.tokens_per_s),
               "peak_allocated_bytes": res.peak_bytes,
               "none_peak_estimate_bytes": (
                   none_peak_estimate(res.peak_bytes, remat_rows[arch], cfg)
                   if remat_rows else None),
               "launches": counts, "bwd_routes": routes, "lse_writes": lse_writes,
               "run_s": run_s, "card": smi}
        emit(row)
        rows[arch] = row
        del res
        torch.cuda.empty_cache()
        losses, gnorms = row["losses"], row["grad_norms"]
        if not (np.isfinite(losses[0]) and 0.1 * log_v < losses[0] < 3 * log_v):
            problems.append(f"{arch}: first loss {losses[0]} against log V {log_v}")
        if not np.mean(losses[-3:]) < losses[0]:
            problems.append(f"{arch}: the loss did not fall")
        if not all(np.isfinite(g) and g > 0 for g in gnorms) or len(gnorms) != len(losses):
            problems.append(f"{arch}: gradient norms {gnorms}")
        if (want < 1 or counts != {"flash_attention": want_fwd, "flash_attention_bwd": want}
                or lse_writes != want_fwd or routes != {"tma": want, "copy": 0, "f32": 0}):
            problems.append(f"{arch}: K3 launches {counts}, lse {lse_writes}, routes {routes}, "
                            f"want {want_fwd} forward (and lse), {want} backward on TMA's")
        if not row["peak_allocated_bytes"] < CARD_BYTES:
            problems.append(f"{arch}: peak {row['peak_allocated_bytes']}")
    if problems:
        raise AssertionError(f"train-full-depth: {problems}")
    return rows


def mfu(flops: float, seconds: float) -> dict:
    """The model-FLOPs utilisation of ``flops`` useful operations in
    ``seconds`` against the bf16 peak, with what it leaves out."""
    return {"mfu": flops / (seconds * peak("peak_flops")), "mfu_note": MFU_NOTE}


def serve_flops(cfg, requests: int, prompt: int, new_tokens: int) -> float:
    """model_flops of a serve: each request's prefill, then its
    new_tokens - 1 decode steps of one token."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.roofline.analysis import model_flops

    return (model_flops(cfg, ShapeSpec("serve", prompt, requests, "prefill"), 1)
            + (new_tokens - 1) * model_flops(cfg, ShapeSpec("serve", prompt, requests,
                                                            "decode"), 1))


def train_flops(cfg, batch: int, seq: int) -> float:
    """model_flops of one training step of batch x seq tokens."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.roofline.analysis import model_flops

    return model_flops(cfg, ShapeSpec("train", seq, batch, "train"), 1)


def padding_helpers():
    """``tests/_padding.py`` of this checkout (the unpadded model inside a
    padded one, and the pad slots), loaded by its path: the CPU tests' own
    module, whatever else is named ``tests`` on the path."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("padding_helpers",
                                                  ROOT / "tests" / "_padding.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _pad_models(torch, arch: str, tp: int, pad_kv: bool, layers: int, dtype: str):
    """(padded config, its parameters on the card, the unpadded config of the
    same function, its parameters): the padded model drawn from SEED, the
    unpadded one its real slots (``tests/_padding.py``)."""
    from repro_torch.configs.base import get_config, pad_for_mesh
    from repro_torch.models import model as M

    base = dataclasses.replace(get_config(arch), dtype=dtype,
                               n_layers=layers or get_config(arch).n_layers)
    cfg = pad_for_mesh(base, tp, pad_kv)
    params = M.init_params(cfg, torch.Generator(device=DEVICE).manual_seed(SEED), DEVICE)
    uparams, ucfg = padding_helpers().unpadded(params, cfg, M)
    return cfg, params, ucfg, uparams


def _pad_serve_logits(torch, M, params, cfg, prompt, embeds, feed):
    """Prefill logits, then PAD_NEW decode steps' (fed ``feed``), on the host."""
    logits, caches = M.prefill(params, cfg, prompt, prompt.shape[1] + len(feed), embeds=embeds)
    out = [logits.float()]
    for i, tok in enumerate(feed):
        logits, caches = M.decode_step(params, cfg, tok, caches, prompt.shape[1] + i)
        out.append(logits.float())
    return out


def pad_mesh_model(torch, smi: str, arch: str, tp: int, pad_kv: bool, layers: int) -> dict:
    """One PAD_MESH_F32 row: serving logits and one training step of the
    padded model against the unpadded one, every pad slot's gradient."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch.steps import build_train
    from repro_torch.models import model as M
    from repro_torch.training import train_loop
    from repro_torch.training.optimizer import init_opt_state

    helpers = padding_helpers()

    cfg, params, ucfg, uparams = _pad_models(torch, arch, tp, pad_kv, layers, "float32")
    V = cfg.vocab_size
    rng = np.random.default_rng([SEED, 8])
    prompt = torch.from_numpy(rng.integers(0, V, (PAD_BATCH, PAD_PROMPT))).to(DEVICE)
    feed = [torch.from_numpy(t).to(DEVICE) for t in rng.integers(0, V, (PAD_NEW, PAD_BATCH))]
    embeds = None
    if cfg.frontend is not None:
        embeds = torch.from_numpy(rng.standard_normal(
            (PAD_BATCH, cfg.n_prefix, cfg.d_model), dtype=np.float32)).to(DEVICE)
    reset_counts()
    with torch.inference_mode():
        got = _pad_serve_logits(torch, M, params, cfg, prompt, embeds, feed)
        serve_launches = launches("flash_attention")
        want = _pad_serve_logits(torch, M, uparams, ucfg, prompt, embeds, feed)
    diffs = [float((g[:, :V] - w).abs().max()) for g, w in zip(got, want)]
    pad_logits_masked = all(bool((g[:, V:] == -1e30).all()) for g in got)
    del got, want
    data = SyntheticLM(vocab_size=V, seq_len=PAD_PROMPT, global_batch=PAD_BATCH, seed=SEED,
                       n_prefix=cfg.n_prefix if cfg.frontend else 0,
                       d_model=cfg.d_model if cfg.frontend else 0)
    batch = train_loop.batch_to(data.batch_at(0), DEVICE)
    with torch.no_grad():
        want_loss = float(M.loss_fn(uparams, ucfg, batch))
    del uparams
    torch.cuda.empty_cache()
    step, _ = build_train(cfg, ShapeSpec("pad-mesh", PAD_PROMPT, PAD_BATCH, "train"),
                          device=DEVICE)
    params.requires_grad_(True)
    seen, adamw = {}, train_loop.adamw_step
    train_loop.adamw_step = lambda p, grads, *a: (seen.update(grads), adamw(p, grads, *a))[1]
    reset_counts()
    try:
        t0 = time.perf_counter()
        _, _, metrics = step(params, init_opt_state(params), batch)
        loss = float(metrics["loss"])
        step_s = time.perf_counter() - t0
    finally:
        train_loop.adamw_step = adamw
    counts = {k: launches(k) for k in ("flash_attention", "flash_attention_bwd")}
    pad_entries, nonzero = {}, []
    for name, g in seen.items():
        mask = helpers.pad_slots(name, tuple(g.shape), cfg)
        if mask is None:
            continue
        kind = name.split(".")[-2] + "." + name.split(".")[-1]
        pad_entries[kind] = pad_entries.get(kind, 0) + int(mask.sum())
        if bool((g[mask.to(g.device)] != 0).any()):
            nonzero.append(name)
    loss_rel = abs(loss - want_loss) / abs(want_loss)
    row = {"phase": "pad-mesh", "arch": arch, "tp": tp, "pad_kv": pad_kv, "dtype": "float32",
           "layers": cfg.n_layers, "heads": [cfg.n_heads, cfg.heads_p],
           "kv_heads": [cfg.n_kv_heads, cfg.kv_heads_p],
           "group": [cfg.n_heads // cfg.n_kv_heads, cfg.heads_p // cfg.kv_heads_p],
           "regroups": helpers.regroups(cfg), "vocab": [V, cfg.vocab_p],
           "experts": [cfg.n_experts, cfg.experts_p], "d_head": cfg.head_dim,
           "unpadded_kv_heads": ucfg.n_kv_heads,
           "batch": PAD_BATCH, "prompt": PAD_PROMPT, "decode_steps": PAD_NEW,
           "logits_max_abs_diff": diffs, "tolerance": LM_PARITY_TOL,
           "pad_logits_minus_1e30": pad_logits_masked,
           "loss": loss, "loss_unpadded": want_loss, "loss_rel_err": loss_rel,
           "pad_grad_entries": pad_entries, "pad_grads_nonzero": nonzero,
           "step_s": step_s, "launches_serve": serve_launches, "launches_step": counts,
           "card": smi}
    emit(row)
    del params, seen, batch
    torch.cuda.empty_cache()
    n = kernel_layers(cfg, "flash_attention")
    problems = []
    if max(diffs) > LM_PARITY_TOL or not pad_logits_masked:
        problems.append(f"logits {diffs}, pad logits masked {pad_logits_masked}")
    if not loss_rel <= PAD_LOSS_RTOL:
        problems.append(f"loss {loss} against {want_loss}")
    if nonzero or not pad_entries:
        problems.append(f"pad slots with nonzero gradients {nonzero} of {pad_entries}")
    if serve_launches != n or counts != {"flash_attention": forward_launches(cfg, "flash_attention"),
                                         "flash_attention_bwd": n}:
        problems.append(f"K3 launches {serve_launches} serving, {counts} a step")
    row["ok"] = not problems
    if problems:
        raise AssertionError(f"pad-mesh {arch} tp {tp} pad_kv {pad_kv}: {problems}")
    return row


def _fwd_bwd_ms(torch, fa_ops, q, k, v, do, window: int) -> tuple[float, float]:
    """K3's training forward (with lse) and its backward, ms each."""
    out, lse = fa_ops._forward(q, k, v, window, with_lse=True)
    return (cuda_ms(torch, lambda: fa_ops._forward(q, k, v, window, with_lse=True), iters=10),
            cuda_ms(torch, lambda: fa_ops.flash_attention_bwd(q, k, v, out, do, lse, window),
                    iters=10))


def pad_mesh_k3(torch, smi: str) -> list[dict]:
    """K3 forward and backward at each PAD_K3 shape, bf16 and f32: dO zero
    on the pad heads, so their dq and the dk, dv of KV heads serving only
    pad heads must be exactly 0; the rest within FA_BWD_TOLERANCE of
    ``mha_bwd_ref``; the padded shape's ms beside the unpadded shape's."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import mha_bwd_ref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rows = []
    for h, kv, hp, kvp, dh, window in PAD_K3:
        for dtype_name in ("bfloat16", "float32"):
            dtype = getattr(torch, dtype_name)
            rtol, share = FA_BWD_TOLERANCE[dtype_name]
            g = hp // kvp
            q, k, v, do = (torch.randn((PAD_BATCH * n, PAD_PROMPT, dh), generator=gen,
                                       device=dev).to(dtype) for n in (hp, kvp, kvp, hp))
            pad_q = (torch.arange(PAD_BATCH * hp, device=dev) % hp) >= h
            pad_kv = (torch.arange(PAD_BATCH * kvp, device=dev) % kvp) * g >= h
            do[pad_q] = 0
            out, lse = fa_ops._forward(q, k, v, window, with_lse=True)
            dq, dk, dv = fa_ops.flash_attention_bwd(q, k, v, out, do, lse, window)
            want = mha_bwd_ref(q, k, v, out, do, lse, window=window)
            torch.cuda.synchronize()
            zero = (bool((dq[pad_q] == 0).all()) and bool((dk[pad_kv] == 0).all())
                    and bool((dv[pad_kv] == 0).all()))
            worst = max(float(((a.float() - w.float()).abs()
                               / (share * w.float().abs().max() + rtol * w.float().abs())).max())
                        for a, w in zip((dq, dk, dv), want))
            del want
            times = {"padded": _fwd_bwd_ms(torch, fa_ops, q, k, v, do, window)}
            times["unpadded"] = _fwd_bwd_ms(torch, fa_ops, *(
                torch.randn((PAD_BATCH * n, PAD_PROMPT, dh), generator=gen, device=dev)
                .to(dtype) for n in (h, kv, kv, h)), window)
            row = {"phase": "pad-mesh-k3", "heads": [h, hp], "kv_heads": [kv, kvp],
                   "group": [h // kv, g], "dh": dh, "window": window, "dtype": dtype_name,
                   "bh": PAD_BATCH * hp, "bkv": PAD_BATCH * kvp, "s": PAD_PROMPT,
                   "pad_grads_exactly_zero": zero, "worst_to_tolerance": worst,
                   "fwd_ms": times["padded"][0], "bwd_ms": times["padded"][1],
                   "unpadded_fwd_ms": times["unpadded"][0],
                   "unpadded_bwd_ms": times["unpadded"][1],
                   "padded_over_unpadded": (sum(times["padded"]) / sum(times["unpadded"])),
                   "fwd_bound_ms": fa_bound(PAD_BATCH * hp, PAD_BATCH * kvp, PAD_PROMPT, dh,
                                            q.element_size(), window)[0],
                   "bwd_bound_ms": fa_bwd_bound(PAD_BATCH * hp, PAD_BATCH * kvp, PAD_PROMPT, dh,
                                                q.element_size(), window)[0],
                   "heads_ratio": hp / h, "card": smi}
            row["ok"] = zero and worst <= 1.0
            emit(row)
            rows.append(row)
            del q, k, v, do, out, lse, dq, dk, dv
            torch.cuda.empty_cache()
    bad = [(r["heads"], r["kv_heads"], r["dtype"]) for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"pad-mesh-k3: {bad}")
    return rows


def pad_mesh_serve(torch, smi: str) -> dict:
    """PAD_SERVE at full depth in bf16, served as the serving cells are,
    beside the unpadded model served the same way just before it; then one
    micro-batch's prefill of each, timed in turns (unpadded, padded,
    padded, unpadded) after a warm-up of each."""
    from repro_torch.configs.base import get_config, pad_for_mesh
    from repro_torch.models import model as M

    arch, tp, pad_kv = PAD_SERVE
    base = get_config(arch)
    cfg = pad_for_mesh(base, tp, pad_kv)
    models = {"unpadded": (base, serve_params(torch, arch)),
              "padded": (cfg, M.init_params(cfg, torch.Generator(device=DEVICE).manual_seed(SEED),
                                            DEVICE))}
    rows = {name: phase_serve(torch, smi, params, arch, "flash_attention",
                              phase="pad-mesh-serve" + ("" if name == "padded" else "-unpadded"),
                              cfg=c) for name, (c, params) in models.items()}
    prompts = torch.from_numpy(np.random.default_rng([SEED, 5]).integers(
        0, base.vocab_size, (SERVE_BATCH, SERVE_PROMPT))).to(DEVICE)
    turns = {"unpadded": [], "padded": []}
    with torch.inference_mode():
        for c, params in models.values():
            M.prefill(params, c, prompts)                       # warm-up
        for name in ("unpadded", "padded", "padded", "unpadded"):
            c, params = models[name]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            M.prefill(params, c, prompts)
            torch.cuda.synchronize()
            turns[name].append((time.perf_counter() - t0) * 1e3)
    del models
    torch.cuda.empty_cache()
    u, pd = rows["unpadded"], rows["padded"]
    out = {"phase": "pad-mesh-serve-vs-unpadded", "arch": arch, "tp": tp, "pad_kv": pad_kv,
           "heads": [cfg.n_heads, cfg.heads_p], "kv_heads": [cfg.n_kv_heads, cfg.kv_heads_p],
           "req_per_s": [u["req_per_s"], pd["req_per_s"]],
           "k3_launches": [u["launches"]["flash_attention"], pd["launches"]["flash_attention"]],
           "prefill_ms_per_micro_batch": [u["prefill_ms_per_micro_batch"],
                                          pd["prefill_ms_per_micro_batch"]],
           "prefill_ms_in_turns": turns,
           "peak_allocated_bytes": [u["max_memory_allocated_bytes"],
                                    pd["max_memory_allocated_bytes"]],
           "mfu": [u["mfu"], pd["mfu"]], "card": smi}
    emit(out)
    return out


def phase_pad_mesh(torch, smi: str) -> dict:
    """Mesh padding through the port's entry points (the ``pad-mesh`` phase:
    PAD_MESH_F32, PAD_K3, PAD_SERVE), and its seconds."""
    t0 = time.perf_counter()
    rows = [pad_mesh_model(torch, smi, *case) for case in PAD_MESH_F32]
    k3 = pad_mesh_k3(torch, smi)
    serve = pad_mesh_serve(torch, smi)
    out = {"phase": "pad-mesh-summary", "models": len(rows), "k3_rows": len(k3),
           "groups_checked": sorted({r["group"][1] for r in k3}),
           "seconds": time.perf_counter() - t0, "card": smi}
    emit(out)
    return {"models": rows, "k3": k3, "serve": serve, **out}


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
    if run("build", phase_build, torch) is None:
        return 1
    smi = device["nvidia_smi"]
    run("lint", phase_lint, smi)
    kernels = run("kernel", phase_kernels, torch)
    run("parity", phase_parity, torch)
    streams = {k: run(f"stream-{k}", phase_stream, torch, k, device["nvidia_smi"])
               for k in MODEL_SIZES}
    run("profile", phase_profile, torch, smi)
    if streams[MODEL_SIZES[0]] is not None:
        run("stream-rate", phase_stream, torch, MODEL_SIZES[0], smi, N_MESSAGES,
            "stream-rate", streams[MODEL_SIZES[0]]["msgs_per_s"] / 2)
    run("lockwatch", phase_lockwatch, torch, smi)
    run("sim-cells", phase_sim_cells, smi)
    sim_kmeans = [run(f"sim-kmeans-{machine}{'-faults' if faults else ''}", phase_sim_kmeans,
                      torch, smi, machine, faults) for machine, faults in SIM_KMEANS_CELLS]
    run("characterize", phase_characterize, torch, smi)
    run("usl-batch", phase_usl_batch, torch, smi)
    run("adapt", phase_adapt, smi)
    whatif = run("whatif", phase_whatif, torch, smi)

    def serving_path(arch: str, kernel: str, suffix: str):
        """Weights, then serve-alone, serve and a profiled serve of ``arch``;
        the serve phase's result."""
        params = run(f"lm-init{suffix}", serve_params, torch, arch)
        if params is None:
            return None
        run(f"serve-alone{suffix}", phase_serve_alone, torch, smi, params, arch,
            f"serve-alone{suffix}")
        out = run(f"serve{suffix}", phase_serve, torch, smi, params, arch, kernel,
                  SERVE_REQUESTS, SERVE_NEW, f"serve{suffix}")
        run(f"serve-profile{suffix}", phase_serve_profile, torch, smi, params, arch, kernel,
            f"serve-profile{suffix}", f"profiled-serve{suffix}")
        del params
        torch.cuda.empty_cache()
        return out

    k3 = run("kernel-K3", phase_kernel_k3, torch, smi)
    k3_bwd = run("kernel-K3-bwd", phase_kernel_k3_bwd, torch, smi)
    run("lm-parity", phase_lm_parity, torch, smi, DENSE_ARCH, "flash_attention")
    serving = {"flash_attention": serving_path(DENSE_ARCH, "flash_attention", "")}
    run("arch-configs", phase_arch_configs, torch, smi, k3)
    run("lm-parity-14b", phase_lm_parity, torch, smi, LARGE_ARCH, "flash_attention",
        "lm-parity-14b", PARITY_14B_LAYERS, PARITY_PROMPT,
        "a float32 copy on the host at full depth would need 59 GB of host RAM")
    run("lm-parity-musicgen", phase_lm_parity, torch, smi, MUSICGEN_ARCH, "flash_attention",
        "lm-parity-musicgen", 0, MUSICGEN_PROMPT)
    serving["flash_attention_14b"] = serving_path(LARGE_ARCH, "flash_attention", "-14b")
    run("lm-parity-recurrentgemma", phase_lm_parity, torch, smi, HYBRID_ARCH,
        "flash_attention", "lm-parity-recurrentgemma")
    serving["flash_attention_recurrentgemma"] = serving_path(HYBRID_ARCH, "flash_attention",
                                                             "-recurrentgemma")
    run("lm-parity-granite", phase_lm_parity, torch, smi, MOE_ARCH, "flash_attention",
        "lm-parity-granite")
    serving["flash_attention_granite"] = serving_path(MOE_ARCH, "flash_attention", "-granite")
    k4 = run("kernel-K4", phase_kernel_k4, torch, smi)
    k4_bwd = run("kernel-K4-bwd", phase_kernel_k4_bwd, torch, smi)
    run("lm-parity-mamba", phase_lm_parity, torch, smi, SSM_ARCH, "ssd_scan",
        "lm-parity-mamba")
    serving["ssd_scan"] = serving_path(SSM_ARCH, "ssd_scan", "-mamba")
    run("train-parity", phase_train_parity, torch, smi)
    trained = run("train-qwen2", phase_train_lm, torch, smi)
    # Mamba2-130M through K4 and its backward, as the two phases above run Qwen2-0.5B
    run("train-parity-mamba", phase_train_parity, torch, smi, SSM_ARCH, "ssd_scan",
        "train-parity-mamba")
    trained_mamba = run("train-mamba2", phase_train_lm, torch, smi, SSM_ARCH, "ssd_scan",
                        "train-mamba2")
    trained_rg = run("train-recurrentgemma", phase_train_recurrentgemma, torch, smi)
    remat = run("train-remat", phase_train_remat, torch, smi)
    full_depth = run("train-full-depth", phase_train_full_depth, torch, smi, remat)
    pad_mesh = run("pad-mesh", phase_pad_mesh, torch, smi)
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
            "launches_k8192": streams[MODEL_SIZES[1]]["launches"][name],
            "launches_kernel_phase": kernels["launches"][name],
            "launches_sim_kmeans": [cell["launches"][name] for cell in sim_kmeans],
            "share_of_bound": row["share_of_bound"], "device_ms": row["device_ms"]})
    row, big = k3[FA_SERVING + (0, "bfloat16")], k3[FA_SERVING_14B + (0, "bfloat16")]
    rg, rg_window = k3[FA_SERVING_RG + ("bfloat16",)], k3[FA_WINDOWED[0]]
    f32 = k3[FA_SERVING + (0, "float32")]
    summary.append({
        "name": "flash_attention", "route": "cuda", "source": FA_SOURCE,
        "replaces": FA_REPLACES, "launches": serving["flash_attention"]["launches"][
            "flash_attention"],
        "max_abs_err": row["max_abs_err"], "ms": row["ms"], "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
        "library_ms": row["library_ms"],
        "shape": dict(zip(("bh", "bkv", "s", "dh"), FA_SERVING), dtype="bfloat16"),
        # the same shape in f32 (3xTF32; the parity phases' dtype)
        **{f"{key}_f32": f32[key] for key in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                              "bound_by", "library_ms", "f32_core_ms")},
        # Qwen2.5-14B's prefill, Dh 128
        "launches_serve_14b": serving["flash_attention_14b"]["launches"]["flash_attention"],
        "max_abs_err_dh128": big["max_abs_err"], "ms_dh128": big["ms"],
        "plain_ms_dh128": big["plain_ms"], "bound_ms_dh128": big["bound_ms"],
        "bound_by_dh128": big["bound_by"], "library_ms_dh128": big["library_ms"],
        "shape_dh128": dict(zip(("bh", "bkv", "s", "dh"), FA_SERVING_14B),
                            dtype="bfloat16"),
        # RecurrentGemma-2B's prefill (Dh 256, window 2,048) and its window at S 4,096
        "launches_serve_recurrentgemma": serving["flash_attention_recurrentgemma"][
            "launches"]["flash_attention"],
        "launches_serve_granite": serving["flash_attention_granite"]["launches"][
            "flash_attention"],
        "launches_train_qwen2": trained["launches"]["flash_attention"],
        # Qwen2-0.5B padded for tp 8 with pad_kv (56 heads over 8 KV heads), served
        "launches_serve_padded": pad_mesh["serve"]["k3_launches"][1],
        "launches_train_full_depth": {a: r["launches"]["flash_attention"]
                                      for a, r in full_depth.items()},
        **{f"{key}_dh256": rg[key] for key in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                               "bound_by", "library_ms")},
        "shape_dh256": dict(zip(("bh", "bkv", "s", "dh", "window"), FA_SERVING_RG),
                            dtype="bfloat16"),
        **{f"{key}_window": rg_window[key] for key in ("max_abs_err", "ms", "plain_ms",
                                                       "bound_ms", "bound_by", "library_ms")},
        "shape_window": dict(zip(("bh", "bkv", "s", "dh", "window"), FA_WINDOWED[0][:5]),
                             dtype="bfloat16")})
    row, big = k3_bwd[FA_BWD_TRAIN + ("bfloat16",)], k3_bwd[FA_BWD_SHAPES[2]]
    rg = k3_bwd[FA_BWD_TRAIN_RG + ("bfloat16",)]
    f32 = k3_bwd[FA_BWD_TRAIN + ("float32",)]
    summary.append({
        "name": "flash_attention_bwd", "route": "cuda", "source": FA_BWD_SOURCE,
        "replaces": FA_BWD_REPLACES,
        "replaces_note": "no TPU kernel: XLA differentiates the reference's attend",
        "launches": trained["launches"]["flash_attention_bwd"],
        "max_abs_err": row["max_abs_err"], "ms": row["ms"], "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
        "library_ms": row["library_ms"], "worst_to_tolerance": row["worst_to_tolerance"],
        "bit_identical": row["bit_identical"],
        "shape": dict(zip(("bh", "bkv", "s", "dh"), FA_BWD_TRAIN), dtype="bfloat16"),
        "device_ms_by_kernel": row["device_ms_by_kernel"],
        **{f"{key}_f32": f32[key] for key in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                              "bound_by", "library_ms", "f32_core_ms",
                                              "worst_to_tolerance")},
        **{f"{key}_dh128": big[key] for key in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                                "bound_by", "library_ms")},
        "shape_dh128": dict(zip(("bh", "bkv", "s", "dh"), FA_BWD_SHAPES[2]),
                            dtype="bfloat16"),
        # RecurrentGemma-2B's training shape (Dh 256) and its training run
        "launches_train_recurrentgemma": trained_rg["launches"]["flash_attention_bwd"],
        # the head groups of padded heads whose gradients came out exactly 0
        "pad_mesh_groups_zero": pad_mesh["groups_checked"],
        "launches_train_full_depth": {a: r["launches"]["flash_attention_bwd"]
                                      for a, r in full_depth.items()},
        **{f"{key}_dh256": rg[key] for key in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                               "bound_by", "library_ms")},
        "shape_dh256": dict(zip(("bh", "bkv", "s", "dh", "window"), FA_BWD_TRAIN_RG),
                            dtype="bfloat16")})
    row = k4[(SSD_SERVING, False)]
    summary.append({
        "name": "ssd_scan", "route": "cuda", "source": SSD_SOURCE, "replaces": SSD_REPLACES,
        "launches": serving["ssd_scan"]["launches"]["ssd_scan"],
        "max_abs_err": row["max_abs_err"], "ms": row["ms"], "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
        "library_ms": row["library_ms"], "chunked_ms": row["chunked_ms"],
        "f32_core_bound_ms": row["f32_core_bound_ms"],
        "launches_train_mamba2": trained_mamba["launches"]["ssd_scan"],
        "shape": dict(zip(("batch", "s", "h", "p", "n"), SSD_SERVING), dtype="float32")})
    row = k4_bwd[SSD_BWD_SHAPES[0]]
    summary.append({
        "name": "ssd_scan_bwd", "route": "cuda", "source": SSD_BWD_SOURCE,
        "replaces": SSD_BWD_REPLACES,
        "replaces_note": "no TPU kernel: XLA differentiates the reference's ssd_chunked",
        "launches": trained_mamba["launches"]["ssd_scan_bwd"],
        "max_abs_err": row["max_abs_err"], "ms": row["ms"], "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
        "library_ms": row["library_ms"], "chunked_autograd_ms": row["chunked_autograd_ms"],
        "f32_core_bound_ms": row["f32_core_bound_ms"],
        "worst_to_tolerance": row["worst_to_tolerance"],
        "worst_to_tolerance_f64": row["worst_to_tolerance_f64"],
        "bit_identical": row["bit_identical"], "device_ms_by_kernel": row["device_ms_by_kernel"],
        "shape": dict(zip(("batch", "s", "h", "p", "n"), SSD_SERVING), dtype="float32")})
    for name, replaces in LOCKSTEP_REPLACES.items():
        row = whatif["rows"][(name, LOCKSTEP_SEEDS[-1])]
        summary.append({
            "name": name, "route": "cuda", "source": LOCKSTEP_SOURCE, "replaces": replaces,
            "launches": whatif["launches"][name], "max_abs_err": row["max_abs_err"],
            "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "ms_8_seeds": whatif["rows"][(name, LOCKSTEP_SEEDS[0])]["ms"],
            "share_of_bound": row["share_of_bound"], "chain_floor_ms": row["chain_floor_ms"],
            "shape": {"seeds": row["seeds"], "steps": row["steps"], "dtype": "float32"}})
    emit({"kernels": summary})
    print(device["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": device["name"],
                                 "count": device["count"]}})
    return 0


def lockstep_tree_rows(root: Path, out: Path) -> int:
    """``whatif``'s four lockstep kernel rows (both kernels at each of
    LOCKSTEP_SEEDS) run by the ``chip_smoke.py`` and the package of the
    checkout at ``root``, on the operands of fig8's serverless step cell,
    then both kernels' outputs on those operands saved to ``out``: one side
    of the parent-against-change comparison."""
    import importlib.util

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(root / "src"))
    spec = importlib.util.spec_from_file_location("chip_smoke_at_root", root / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    runs = smoke.whatif_tournament("serverless")
    exp = runs["tournament"].summaries[("step", "usl", 0)].experiment.experiment
    smoke.lockstep_rows(torch, exp, smoke.nvidia_smi_line())
    from repro_torch.kernels.lockstep_scan import ops
    from repro_torch.sim import batched

    chain_exp = dataclasses.replace(exp, scaling_policy="static", static_partitions=1)
    saved = {}
    for n_seeds in LOCKSTEP_SEEDS:
        seeds = list(range(n_seeds))
        g = batched.grid_lockstep_inputs(exp, seeds)
        c = batched.lockstep_inputs(chain_exp, seeds)
        saved[f"grid_{n_seeds}"] = ops.grid_lockstep_scan(
            *(torch.from_numpy(g[k]).to(DEVICE) for k in ("floors", "parts", "conts", "dt")),
            g["n_parts"], g["n_conts"]).cpu()
        saved[f"chain_{n_seeds}"] = ops.lockstep_scan(
            *(torch.from_numpy(np.ascontiguousarray(c[k], dtype=np.float32)).to(DEVICE)
              for k in ("appends", "means", "z")), c["a"], c["b"]).cpu()
    torch.save(saved, out)
    return 0


def k3_tree_rows(root: Path) -> int:
    """K3's rows of the package of the checkout at ``root``, one side of the
    parent-against-change comparison, printed as JSON: the f32 forward at
    each K3_COMPARE_FWD shape and the f32 backward at each K3_COMPARE_BWD
    shape, each with its CUDA-event ms and its worst share of its tolerance
    against the plain version (TF32 off), and a sha256 of the bf16 forward's
    outputs (and the backward's) at the same shape on the same inputs."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(root / "src"))
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import mha_bwd_ref, mha_ref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE)

    def sha(*tensors) -> str:
        h = hashlib.sha256()
        for t in tensors:
            h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
        return h.hexdigest()

    def inputs(i: int, counts, s: int, dh: int):
        gen = torch.Generator(device=dev).manual_seed(SEED + i)
        return [torch.randn((n, s, dh), generator=gen, device=dev) for n in counts]

    tol = FA_TOLERANCE["float32"]
    for i, (bh, bkv, s, dh, window) in enumerate(K3_COMPARE_FWD):
        q, k, v = inputs(i, (bh, bkv, bkv), s, dh)
        got, want = fa_ops.flash_attention(q, k, v, window=window), mha_ref(q, k, v, window=window)
        worst = float(((got - want).abs() / (tol["atol"] + tol["rtol"] * want.abs())).max())
        del got, want
        ms = cuda_ms(torch, lambda: fa_ops.flash_attention(q, k, v, window=window))
        qb, kb, vb = (t.bfloat16() for t in (q, k, v))
        emit({"phase": "k3-compare", "kernel": "forward", "row": f"{bh},{bkv},{s},{dh},{window}",
              "ms": ms, "worst_to_tolerance": worst,
              "bf16_sha256": sha(fa_ops.flash_attention(qb, kb, vb, window=window))})
        del q, k, v, qb, kb, vb
        torch.cuda.empty_cache()
    rtol, share = FA_BWD_TOLERANCE["float32"]
    for i, (bh, bkv, s, dh, window) in enumerate(K3_COMPARE_BWD):
        q, k, v, do = inputs(i, (bh, bkv, bkv, bh), s, dh)
        out, lse = fa_ops._forward(q, k, v, window, with_lse=True)
        got = fa_ops.flash_attention_bwd(q, k, v, out, do, lse, window)
        want = mha_bwd_ref(q, k, v, out, do, lse, window=window)
        worst = max(float(((g - w).abs() / (share * w.abs().max() + rtol * w.abs())).max())
                    for g, w in zip(got, want))
        del got, want
        ms = cuda_ms(torch, lambda: fa_ops.flash_attention_bwd(q, k, v, out, do, lse, window))
        qb, kb, vb, dob = (t.bfloat16() for t in (q, k, v, do))
        outb, lseb = fa_ops._forward(qb, kb, vb, window, with_lse=True)
        emit({"phase": "k3-compare", "kernel": "backward", "row": f"{bh},{bkv},{s},{dh},{window}",
              "ms": ms, "worst_to_tolerance": worst,
              "bf16_sha256": sha(outb, lseb, *fa_ops.flash_attention_bwd(
                  qb, kb, vb, outb, dob, lseb, window))})
        del q, k, v, do, out, lse, qb, kb, vb, dob, outb, lseb
        torch.cuda.empty_cache()
    return 0


def compare_parent(parent: Path) -> int:
    """The lockstep kernels, then K3's rows, of the checkout at ``parent``
    and of this one on one card, in turns (parent, change, change, parent),
    one process each (both packages are named ``repro_torch``): for the
    lockstep kernels ``whatif``'s four rows each, each row's ms in the four
    turns, and every output of each turn bit for bit against the first
    parent's; for K3 each ``k3_tree_rows`` row's ms and worst share of its
    tolerance in the four turns, and its bf16 outputs' digest in each turn
    against the first parent's."""
    import torch

    turns = (("parent", parent), ("change", ROOT), ("change", ROOT), ("parent", parent))
    outs, ms = [], {}
    for k, (tree, root) in enumerate(turns):
        emit({"phase": "lockstep-compare", "tree": tree, "root": str(root)})
        outs.append(ROOT / "build" / f"lockstep_{k}_{tree}.pt")
        outs[-1].parent.mkdir(parents=True, exist_ok=True)
        proc = subprocess.run([sys.executable, __file__, "--lockstep-rows", str(root),
                               str(outs[-1])], capture_output=True, text=True, timeout=600)
        print(proc.stdout, end="", flush=True)
        print(proc.stderr, end="", file=sys.stderr, flush=True)
        if proc.returncode:
            return proc.returncode
        for line in proc.stdout.splitlines():
            row = json.loads(line) if line.startswith("{") else {}
            if row.get("phase") == "whatif-kernel":
                ms.setdefault(f"{row['kernel']}_{row['seeds']}", []).append(row["ms"])
    want = torch.load(outs[0])
    same = {f"{name}_turn{k}": torch.equal(want[name], torch.load(out)[name])
            for k, out in enumerate(outs[1:], 1) for name in want}
    emit({"phase": "lockstep-compare-ms", "turns": ["parent", "change", "change", "parent"],
          "ms": ms, "change_faster_in_every_row": all(
              max(v[1], v[2]) < min(v[0], v[3]) for v in ms.values())})
    emit({"phase": "lockstep-bits", "bit_identical": all(same.values()), "outputs": same})

    k3 = {}                            # (kernel, row) -> the turns' rows
    for tree, root in turns:
        emit({"phase": "k3-compare", "tree": tree, "root": str(root)})
        proc = subprocess.run([sys.executable, __file__, "--k3-rows", str(root)],
                              capture_output=True, text=True, timeout=900)
        print(proc.stdout, end="", flush=True)
        print(proc.stderr, end="", file=sys.stderr, flush=True)
        if proc.returncode:
            return proc.returncode
        for line in proc.stdout.splitlines():
            row = json.loads(line) if line.startswith("{") else {}
            if row.get("phase") == "k3-compare" and "ms" in row:
                k3.setdefault((row["kernel"], row["row"]), []).append(row)
    bits = {f"{kernel} {row}": all(r["bf16_sha256"] == rows[0]["bf16_sha256"] for r in rows)
            for (kernel, row), rows in k3.items()}
    emit({"phase": "k3-compare-ms", "turns": [t for t, _ in turns],
          "ms": {f"{kernel} {row}": [r["ms"] for r in rows] for (kernel, row), rows in k3.items()},
          "worst_to_tolerance": {f"{kernel} {row}": [r["worst_to_tolerance"] for r in rows]
                                 for (kernel, row), rows in k3.items()},
          "change_faster_in_every_row": all(
              max(r[1]["ms"], r[2]["ms"]) < min(r[0]["ms"], r[3]["ms"]) for r in k3.values())})
    emit({"phase": "k3-bf16-bits", "bit_identical": all(bits.values()), "outputs": bits})
    return 0 if all(same.values()) and all(bits.values()) else 1


if __name__ == "__main__":
    # no arguments: the whole run; `--compare-parent DIR`: the lockstep
    # kernels and K3's rows of the checkout at DIR (e.g. a `git archive` of
    # the parent) beside this one
    if len(sys.argv) == 3 and sys.argv[1] == "--compare-parent":
        sys.exit(compare_parent(Path(sys.argv[2]).resolve()))
    if len(sys.argv) == 4 and sys.argv[1] == "--lockstep-rows":
        sys.exit(lockstep_tree_rows(Path(sys.argv[2]).resolve(), Path(sys.argv[3])))
    if len(sys.argv) == 3 and sys.argv[1] == "--k3-rows":
        sys.exit(k3_tree_rows(Path(sys.argv[2]).resolve()))
    sys.exit(main())
