"""The roofline table of a directory of dry-run records (one JSON a cell).

Ports ``repro.roofline.report``: ``load`` reads and orders the records,
``table`` renders them as the reference's markdown table (OK, SKIP and
FAIL rows), ``main`` prints it with the cells farthest from their compute
bound and the most collective-bound ones.  The records are those the
port's dry run writes, in the reference's format.

    PYTHONPATH=src python -m repro_torch.roofline.report results/dryrun
"""

from __future__ import annotations

import glob
import json
import os
import sys


def load(dirpath: str) -> list[dict]:
    recs = []
    for f in sorted(glob.glob(os.path.join(dirpath, "*.json"))):
        with open(f) as fh:
            recs.append(json.load(fh))
    order = {"train_4k": 0, "prefill_32k": 1, "decode_32k": 2, "long_500k": 3}
    recs.sort(key=lambda r: (r["arch"], order.get(r["shape"], 9)))
    return recs


def table(recs: list[dict]) -> str:
    hdr = ("| arch | shape | status | compute_s | memory_s (HLO) | mem_floor_s | "
           "coll_s | wire_s | wire_adj_s | bottleneck | 6ND/HLO | compile s/p | args GB |")
    sep = "|" + "---|" * 13
    rows = [hdr, sep]
    for r in recs:
        if r["status"] == "SKIP":
            rows.append(f"| {r['arch']} | {r['shape']} | SKIP(full-attention) "
                        "| — | — | — | — | — | — | — | — | — | — |")
            continue
        if r["status"] != "OK":
            rows.append(f"| {r['arch']} | {r['shape']} | FAIL | — | — | — | — "
                        f"| — | — | — | — | — | — |")
            continue
        t = r["roofline"]
        mem = r["single_pod"]["memory"]
        rows.append(
            f"| {r['arch']} | {r['shape']} | OK "
            f"| {t['compute_s']:.4f} | {t['memory_s']:.4f} "
            f"| {t['memory_floor_s']:.4f} | {t['collective_s']:.4f} "
            f"| {t['collective_wire_s']:.4f} "
            f"| {t.get('collective_wire_bf16adj_s', t['collective_wire_s']):.4f} "
            f"| {t['bottleneck_calibrated']} "
            f"| {r['useful_flops_ratio']:.2f} "
            f"| {r['single_pod']['compile_s']:.0f}/{r.get('multi_pod', {}).get('compile_s', 0):.0f} "
            f"| {mem.get('argument_size_in_bytes', 0) / 1e9:.1f} |")
    return "\n".join(rows)


def main() -> None:
    recs = load(sys.argv[1] if len(sys.argv) > 1 else "results/dryrun")
    print(table(recs))
    ok = [r for r in recs if r["status"] == "OK"]
    print(f"\n{len(ok)} OK, {sum(r['status'] == 'SKIP' for r in recs)} SKIP, "
          f"{sum(r['status'] == 'FAIL' for r in recs)} FAIL / {len(recs)}")
    # hillclimb candidates
    def frac(r):
        return r["roofline"]["compute_fraction_calibrated"]
    worst = sorted(ok, key=frac)[:5]
    print("\nworst calibrated compute fraction (hillclimb candidates):")
    for r in worst:
        print(f"  {r['arch']} × {r['shape']}: {frac(r) * 100:.1f}% "
              f"(bottleneck {r['roofline']['bottleneck_calibrated']})")
    coll = sorted(ok, key=lambda r: -r["roofline"]["collective_wire_s"])[:5]
    print("most collective-bound:")
    for r in coll:
        print(f"  {r['arch']} × {r['shape']}: wire {r['roofline']['collective_wire_s']:.3f}s "
              f"vs compute {r['roofline']['compute_s']:.3f}s")


if __name__ == "__main__":
    main()
