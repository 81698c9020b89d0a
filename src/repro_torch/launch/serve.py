"""Streaming LM serving: the paper's event-driven processing mode applied
to LM inference, on one torch device.

Ports ``repro.launch.serve``.  Requests arrive as broker messages; the
engine micro-batches up to ``batch_max`` of them per partition, and each
micro-batch runs prefill plus greedy decode as a compute-unit on a
``torch://`` pilot.  On the card the prefill runs kernel K3 as its
attention (the dense and frontend configs: ``qwen2-0.5b``, ``qwen2.5-3b``,
``qwen2.5-14b``, ``glm4-9b``, ``internvl2-1b``, ``musicgen-medium``; the
MoE configs ``granite-moe-3b-a800m`` and ``qwen3-moe-235b-a22b``; and
``recurrentgemma-2b``, whose local-attention layers run K3 at Dh 256 with
its 2,048-token window, and whose RG-LRU layers scan in plain torch) or
kernel K4 as its SSD scan (``mamba2-130m``).  Like the reference's serve,
it passes no frontend ``embeds``: a request is its token ids.  The model is
read-only and every micro-batch makes its own caches (K/V or SSM state), so
the consumer threads share it without a lock.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch musicgen-medium --reduced \\
        --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-130m --reduced --device cpu \\
        --prompt-len 16
    PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma-2b --reduced \\
        --device cpu                  # likewise granite-moe-3b-a800m, qwen3-moe-235b-a22b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-14b --requests 32 \\
        --prompt-len 1024 --new-tokens 8 --batch-max 4       # full width, on the card

A Mamba-2 prompt is at most the config's SSD chunk long or a multiple of it
(the reference's contract).  ``main`` refuses a configuration whose weights
outgrow the device's memory before it allocates them: Qwen3-235B-A22B at
its published depth holds ~470 GB of bf16 weights, against 80 GB on one
H100, so on one card it runs only cut in depth (``chip_smoke.py`` runs 2
of its 94 layers at published width).
"""

from __future__ import annotations

import argparse
import os
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import get_config
from repro_torch.core.metrics import MetricRegistry, new_run_id, percentile_summary
from repro_torch.models import model as M
from repro_torch.pilot.api import PilotComputeService, PilotDescription
from repro_torch.streaming.broker import Broker
from repro_torch.streaming.engine import ThreadedStreamingEngine, Workload

__all__ = ["ServeResult", "serve", "check_weights_fit", "main"]


@dataclass
class ServeResult:
    """What a serving run produced and what the engine counted."""

    tokens: np.ndarray              # (requests, new_tokens), in request order
    processed: int
    abandoned: int
    retried: int
    failed_batches: int
    wall_s: float                   # first append -> drained
    lpx_s: list[float]              # per request, append -> complete
    # per micro-batch run: (requests, prefill seconds, decode seconds)
    batches: list[tuple[int, float, float]] = field(default_factory=list)

    @property
    def req_per_s(self) -> float:
        return self.processed / self.wall_s

    @property
    def tokens_per_s(self) -> float:
        return self.processed * self.tokens.shape[1] / self.wall_s


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(cfg, params, prompts: np.ndarray, *, new_tokens: int, partitions: int = 2,
          batch_max: int = 4, device="cuda", timeout: float = 600.0) -> ServeResult:
    """Serve ``prompts`` (requests, prompt_len) of token ids through broker ->
    engine -> ``torch://`` pilot -> ``greedy_generate`` with ``params`` (on
    ``device``).  All requests are appended at once, as a burst."""
    n_req, prompt_len = prompts.shape
    cache_len = prompt_len + new_tokens
    metrics = MetricRegistry()
    run_id = new_run_id(f"serve-{cfg.name}")
    pcs = PilotComputeService()
    pilot = pcs.submit_pilot(PilotDescription(resource="torch://",
                                              attrs={"device": device}))
    dev = pilot.device
    results: dict[int, np.ndarray] = {}
    batches: list[tuple[int, float, float]] = []

    def handle(msgs):
        with torch.inference_mode():
            batch = torch.from_numpy(np.stack([m.value["tokens"] for m in msgs])).to(dev)
            t0 = time.perf_counter()
            logits, caches = M.prefill(params, cfg, batch, cache_len)
            first = torch.argmax(logits, dim=-1)
            _sync(dev)
            t1 = time.perf_counter()
            out = M.decode_greedy(params, cfg, first, caches, prompt_len,
                                  new_tokens).cpu().numpy()
            t2 = time.perf_counter()
        for m, row in zip(msgs, out):
            results[m.value["index"]] = row
        batches.append((len(msgs), t1 - t0, t2 - t1))

    broker = Broker()
    broker.create_topic("requests", partitions)
    engine = ThreadedStreamingEngine(broker, "requests", pilot,
                                     Workload(fn=handle, name="generate"),
                                     metrics, run_id, batch_max=batch_max)
    engine.start()
    t0 = time.perf_counter()
    try:
        for i in range(n_req):
            msg_id = f"{run_id}/{i}"
            tokens = np.asarray(prompts[i], np.int64)
            broker.append("requests", {"tokens": tokens, "index": i},
                          ts=time.perf_counter(), run_id=run_id, msg_id=msg_id,
                          size_bytes=tokens.nbytes)
            metrics.record(run_id, "broker", "append", time.perf_counter(), msg_id=msg_id)
        engine.drain(n_req, timeout=timeout)
        wall = time.perf_counter() - t0
    finally:
        engine.stop()
        pcs.close()
    core = engine.core
    missing = np.full((new_tokens,), -1, np.int64)
    return ServeResult(
        tokens=np.stack([results.get(i, missing) for i in range(n_req)]),
        processed=core.processed, abandoned=core.abandoned, retried=core.retried,
        failed_batches=core.failed_batches, wall_s=wall,
        lpx_s=list(metrics.latencies(run_id, "append", "complete")), batches=batches)


def _memory_bytes(device: torch.device) -> int:
    """The device's memory: the card's total, or the host's RAM for the CPU."""
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).total_memory
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")


def check_weights_fit(cfg, device: torch.device) -> None:
    """Raise ``ValueError`` if ``cfg``'s weights alone (its parameter count
    in ``cfg.dtype``) exceed the memory of ``device``."""
    need = cfg.param_count() * torch.empty((), dtype=getattr(torch, cfg.dtype)).element_size()
    have = _memory_bytes(device)
    if need > have:
        where = "the card's" if device.type == "cuda" else "the host's"
        raise ValueError(
            f"{cfg.name} at {cfg.n_layers} layers holds {need / 1e9:.1f} GB of {cfg.dtype} "
            f"weights ({cfg.param_count():,} parameters), more than {where} "
            f"{have / 1e9:.1f} GB of memory on {device}; run it cut in depth or "
            f"--reduced")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--partitions", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--batch-max", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, reduced=args.reduced)
    dev = resolve_device(args.device)
    check_weights_fit(cfg, dev)
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(args.seed), dev)
    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(0, cfg.vocab_size, size=(args.requests, args.prompt_len))
    res = serve(cfg, params, prompts, new_tokens=args.new_tokens,
                partitions=args.partitions, batch_max=args.batch_max,
                device=dev)
    print(f"served {res.processed}/{args.requests} requests in {res.wall_s:.2f}s  "
          f"T^px={res.req_per_s:.2f} req/s  {res.tokens_per_s:.1f} generated tok/s")
    print("L^px:", {k: round(v, 4) for k, v in percentile_summary(res.lpx_s).items()})
    print(f"retries={res.retried} failed={res.failed_batches}")


if __name__ == "__main__":
    main()
