"""The readings that a cell's limits are set from, in one process.

    python3 -m chipbench.calibrate --workload <cell> --seconds <s> \
        --seeds <n> [<n> ...]

For each seed: the cell's set-up and a short window at its own load, then
the numbers compared for the program (what the timed path produced
against the plain reference) and for the control (the reference computed
with TF32 operands in the program's place, on the same sample).  Prints
one JSON line a seed, then the largest program reading and the smallest
control reading of each number.  The benchmark's own runs never run the
control.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys

from chipbench.run import ROOT  # noqa: F401  (puts the program on the path)
from chipbench import harness, reference


def readings(cell, cfg, seed: int, seconds: float, device) -> dict:
    """(program, control) numbers of one seed."""
    import time

    import torch
    driver = harness.driver_for(cell)
    ctx = harness.Context(cell=cell, cfg=cfg, seed=seed, seconds=seconds,
                          device=device)
    state = driver.setup(ctx)
    ctx.deadline = time.perf_counter() + seconds
    rec = driver.window(ctx, state)
    driver.free(state)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return {"seed": seed, "attempted": rec["attempted"],
            "program": driver.check(ctx, state, rec),
            "control": driver.control(ctx, state, rec)}


def summary(rows: list) -> dict:
    names = rows[0]["program"]
    return {k: {"program_max": max(r["program"][k] for r in rows),
                "control_min": min(r["control"][k] for r in rows)}
            for k in names}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m chipbench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    from chipbench.run import card
    cell, cfg = harness.load_cell(args.workload)
    device = card(cell["chips"])
    reference.set_precision(cfg)
    rows = []
    for seed in args.seeds:
        rows.append(readings(cell, cfg, seed, args.seconds, device))
        print(json.dumps(rows[-1]), flush=True)
    print(json.dumps({"workload": args.workload, "limits": cell["limits"],
                      "summary": summary(rows)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
