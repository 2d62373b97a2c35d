"""Run one cell of the benchmark once and print its result line.

    python3 -m chipbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The run loads the program, makes its weights and inputs on the card from
the seed, warms up every shape the cell uses (all of that is ``setup_s``),
drives the cell's traffic for ``--seconds``, checks what the timed path
produced against the plain reference, and prints one JSON object as the
last line of standard output.  ``--trace 0`` reports the cell's
end-to-end metrics, ``--trace 1`` its per-layer metrics, read from a
profiler trace of a window of at most ``TRACE_S`` seconds (the trace of
a longer one outgrows the run's time), and a breakdown.  The metrics of a
cell are those of ``BENCHMARK.json`` that name it (or name no cells).

Without a CUDA card the run fails and prints no result.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
for _p in (ROOT / "src", ROOT):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

from chipbench import harness  # noqa: E402


TRACE_S = 10.0


class NoCard(RuntimeError):
    pass


def cell_metrics(name: str, bench: dict) -> tuple:
    """(end-to-end, per-layer) metric entries of ``BENCHMARK.json`` that
    apply to cell ``name``."""
    def mine(m):
        return "workloads" not in m or name in m["workloads"]
    return ([m for m in bench["end_to_end"] if mine(m)],
            [m for m in bench["per_layer"] if mine(m)])


def execute(cell, cfg, bench, *, seed, seconds, trace, device,
            t_start=None) -> dict:
    """One run of ``cell`` on ``device``: the result object, with the
    numbers compared under ``checks``, last."""
    import torch
    from chipbench import reference
    t_start = time.perf_counter() if t_start is None else t_start
    reference.set_precision(cfg)
    e2e_defs, layer_defs = cell_metrics(cell["name"], bench)
    if trace:
        seconds = min(seconds, TRACE_S)
    driver = harness.driver_for(cell)
    ctx = harness.Context(cell=cell, cfg=cfg, seed=seed, seconds=seconds,
                          device=device, trace=bool(trace), t_start=t_start)
    import repro_torch  # noqa: F401  (the program's import, stamped apart)
    ctx.stamp("program imported")
    state = driver.setup(ctx)
    ctx.sync()
    setup_s = time.perf_counter() - t_start
    ctx.stamp("done")

    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.__enter__()
    gc.collect()
    gc.freeze()        # set-up's objects stay out of the window's collections
    t0 = time.perf_counter()
    ctx.deadline = t0 + seconds
    with ctx.span("window"):
        rec = driver.window(ctx, state)
    window_s = time.perf_counter() - t0
    tr = None
    if prof is not None:
        prof.__exit__(None, None, None)
        tr = harness.read_chrome_trace(prof, pathlib.Path(
            tempfile.gettempdir()))
        del prof
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    found = harness.forbidden_modules()
    if found:
        raise harness.ForbiddenModule(
            f"loaded in the run: {', '.join(found)}")

    gc.unfreeze()
    driver.free(state)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks = driver.check(ctx, state, rec)
    limits = cell["limits"]
    correct = set(checks) == set(limits) and all(
        math.isfinite(v) and v <= limits[k] for k, v in checks.items())

    metrics = {}
    if not trace:
        values = dict(driver.end_to_end(ctx, rec, window_s),
                      setup_s=setup_s)
        for m in e2e_defs:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    else:
        run = harness.Run(cell=cell, cfg=cfg, rec=rec, trace=tr)
        for m in layer_defs:
            v = harness.reader_for(m["name"])(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = harness.device_record(device, peak)
    out = {"correct": bool(correct), "attempted": rec["attempted"],
           "failed": rec["failed"], "metrics": metrics, "device": dev}
    if tr is not None:
        dev["busy_s"] = tr.busy_s()
        dev["window_s"] = tr.window_s
        out["breakdown"] = {"device_ops": tr.top_ops(),
                            "idle_gaps": tr.idle_gaps()}
    out["checks"] = {k: {"value": v, "limit": limits.get(k)}
                     for k, v in checks.items()}
    return out


def parse(argv=None):
    ap = argparse.ArgumentParser(prog="python3 -m chipbench.run",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def card(chips: int):
    """The card, or ``NoCard`` when the run has fewer than ``chips``."""
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        raise NoCard(f"this cell needs {chips} CUDA card(s); "
                     f"torch sees {torch.cuda.device_count()}")
    return torch.device("cuda", 0)


def main(argv=None) -> int:
    args = parse(argv)
    cell, cfg = harness.load_cell(args.workload)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    try:
        device = card(cell["chips"])
    except NoCard as e:
        harness.log(f"chipbench: {e}")
        return 2
    import torch
    harness.log(f"chipbench: {args.workload} seed={args.seed} "
                f"seconds={args.seconds} trace={args.trace} on "
                f"{torch.cuda.get_device_name(device)} "
                f"torch {torch.__version__}")
    harness.log(f"setup: torch and the card at "
                f"{time.perf_counter() - T_START:.3f} s")
    try:
        out = execute(cell, cfg, bench, seed=args.seed,
                      seconds=args.seconds, trace=args.trace,
                      device=device, t_start=T_START)
    except harness.ForbiddenModule as e:
        harness.log(f"chipbench: {e}")
        return 3
    # read once the window has closed, so that set-up runs no subprocess
    harness.log(f"chipbench: card {harness.power_limit()}")
    for k, v in out["checks"].items():
        harness.log(f"check {k} = {v['value']!r} (limit {v['limit']!r})")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
