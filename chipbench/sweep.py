"""The open-loop cell's rate sweep: the highest rate the engine sustains.

    python3 -m chipbench.sweep --workload vgg16-t1.open-ragged \
        --seconds 30 --seeds 1 2 --rates 160 180 200 ...

One engine, built as the cell builds it, serves the cell's traffic at each
rate in turn, once a seed, for ``--seconds`` each.  A run is sustained
when the engine completes what was offered (at least 97%) and the backlog
does not grow: the least-squares trend of latency against due time, over
the whole window, adds at most half the median latency (the medians of
the first and last quarters, which swing by 25% at low load, are printed
beside it).  The highest sustained rate is the highest rate at which every
run, and every run at every lower rate tried, was sustained; the cell runs
at ``LOAD`` times it.  Prints one JSON line a run, then the verdict.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys

from chipbench.run import ROOT  # noqa: F401  (puts the program on the path)
from chipbench import harness, reference


LOAD = 0.8


def growth(t: list, lat: list) -> float:
    """What the least-squares line of ``lat`` against ``t`` adds from the
    first ``t`` to the last."""
    n = len(t)
    mt, ml = sum(t) / n, sum(lat) / n
    var = sum((x - mt) ** 2 for x in t)
    if var == 0:
        return 0.0
    slope = sum((x - mt) * (y - ml) for x, y in zip(t, lat)) / var
    return slope * (max(t) - min(t))


def sustained(growth_s: float, median_s: float, completed_rps: float,
              offered_rps: float) -> bool:
    return growth_s <= 0.5 * median_s and completed_rps >= 0.97 * offered_rps


def highest_sustained(runs: list):
    """The highest rate at which every run, and every run at every lower
    rate, was sustained (None if the lowest rate was not)."""
    best = None
    for rate in sorted({r["rate_rps"] for r in runs}):
        if not all(r["sustained"] for r in runs if r["rate_rps"] == rate):
            break
        best = rate
    return best


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m chipbench.sweep")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--seeds", type=int, nargs="+", default=[1, 2])
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    args = ap.parse_args(argv)
    from chipbench.run import card
    cell, cfg = harness.load_cell(args.workload)
    device = card(cell["chips"])
    reference.set_precision(cfg)
    drv = harness.driver_for(cell)
    ctx = harness.Context(cell=cell, cfg=cfg, seed=args.seeds[0],
                          seconds=args.seconds, device=device)
    kernels, biases = reference.make_params(cfg["layers"], args.seeds[0],
                                            device)
    eng = drv.build(ctx, kernels, biases)
    runs = []
    for rate in sorted(args.rates):
        for seed in args.seeds:
            sched = drv.arrivals(rate, args.seconds,
                                 cell["traffic"]["max_batch"], seed)
            due, sub, done, _, _, _ = drv.serve(ctx, eng, sched)
            lat = [d - u for d, u in zip(done, due)]
            q = max(1, len(lat) // 4)
            head = statistics.median(lat[:q])
            tail = statistics.median(lat[-q:])
            span = max(done) - (due[0] - sched[0][0])
            offered = len(sched) / args.seconds
            completed = len(sched) / span
            grew = growth([t for t, _ in sched], lat)
            med = statistics.median(lat)
            runs.append({
                "rate_rps": rate, "seed": seed, "requests": len(sched),
                "offered_rps": offered, "completed_rps": completed,
                "median_ms": med * 1e3, "growth_ms": grew * 1e3,
                "p95_ms": drv.percentile(lat, 95) * 1e3,
                "p99_ms": drv.percentile(lat, 99) * 1e3,
                "first_quarter_median_ms": head * 1e3,
                "last_quarter_median_ms": tail * 1e3,
                "late_p95_ms": drv.percentile(
                    [s - u for s, u in zip(sub, due)], 95) * 1e3,
                "sustained": sustained(grew, med, completed, offered)})
            print(json.dumps(runs[-1]), flush=True)
    best = highest_sustained(runs)
    print(json.dumps({"highest_sustained_rps": best,
                      "rate_rps": None if best is None else LOAD * best}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
