"""StreamInsight end to end on the port: experimental design -> automated
runs on the virtual clock (process pool) -> USL models fitted on the card
-> prediction quality -> a configuration recommendation per machine.

The port's counterpart of ``examples/characterize.py``: the same two
designs and the same report, with every fit made by the float64 batched
Levenberg–Marquardt of ``repro_torch.core.usl`` (``backend="torch"``) on
``--device``.  The second design is the consistency-policy ablation on
HPC: ``full_fit_locked`` (what the paper's Dask numbers imply) against
``update_locked`` (the distance phase outside the shared-model lock).

    PYTHONPATH=src python -m repro_torch.launch.characterize               # on the card
    PYTHONPATH=src python -m repro_torch.launch.characterize --device cpu

The ``__main__`` guard is required: the pool's workers are started with a
non-fork context and re-import the main module.
"""

from __future__ import annotations

import argparse

from repro_torch import resolve_device
from repro_torch.core.autoscale import Autoscaler
from repro_torch.core.streaminsight import ExperimentDesign, StreamInsight

__all__ = ["PARTITIONS", "EVAL_SIZES", "sweep_design", "ablation_design",
           "characterize", "main"]

PARTITIONS = [1, 2, 4, 8, 12, 16]
EVAL_SIZES = [2, 3, 4]          # training configurations of the Fig-7 curve


def sweep_design() -> ExperimentDesign:
    """Serverless and wrangler across the partition grid, 16,000-point
    messages, 1,024 centroids, 50 messages a cell."""
    return ExperimentDesign(machines=["serverless", "wrangler"],
                            partitions=PARTITIONS, points=[16000],
                            centroids=[1024], n_messages=50)


def ablation_design() -> ExperimentDesign:
    """The wrangler consistency-policy ablation: 8,192 centroids, 40
    messages a cell, ``full_fit_locked`` against ``update_locked``."""
    return ExperimentDesign(machines=["wrangler"], partitions=PARTITIONS,
                            points=[16000], centroids=[8192], n_messages=40,
                            policy=["full_fit_locked", "update_locked"])


def characterize(device="cuda", parallel: bool | str = True,
                 verbose: bool = True) -> tuple[StreamInsight, StreamInsight]:
    """Run both designs and print the report, the Fig-7 evaluation and the
    recommendations, every fit on ``device``; returns the two insights."""
    fit = dict(backend="torch", device=device)
    print("=== running the experiment grid (virtual clock, process pool)")
    si = StreamInsight()
    si.run(sweep_design(), verbose=verbose, parallel=parallel)
    print()
    print(si.report(**fit))

    print("\n=== prediction quality vs training-set size (paper Fig 7)")
    for agg in si.evaluate(EVAL_SIZES, **fit):
        print(f"  {agg['n_train_configs']} train configs -> mean rel-RMSE "
              f"{agg['mean_rel_rmse'] * 100:.1f}%")

    print("\n=== recommendation per scenario")
    for m in si.fit_models(**fit):
        scaler = Autoscaler(m.fit)
        print(f"  {m.key[0]:>10}: run N={scaler.usable_peak_n()} partitions "
              f"(peak {scaler.max_sustainable_rate():.2f} msg/s)")

    print("\n=== beyond-paper: consistency-policy ablation on HPC")
    si2 = StreamInsight()
    si2.run(ablation_design(), parallel=parallel)
    for m in si2.fit_models(**fit):
        peak = m.fit.peak_n
        peak_s = f"{peak:.1f}" if peak != float("inf") else "inf"
        print(f"  {m.key[4]:>17}: sigma={m.fit.sigma:.3f} kappa={m.fit.kappa:.5f} "
              f"peak_N={peak_s:>5} T(16)={m.fit.predict(16):.2f} msg/s")
    return si, si2


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device of the USL fits (default: cuda)")
    args = ap.parse_args(argv)
    characterize(str(resolve_device(args.device)))
    print("characterize OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
