"""Open-loop serving in on/off bursts: ``open_serve``'s engine, replay,
records (through its ``window``) and check, with only the schedule
replaced.

Every ``period_ms`` a burst of ``burst_ms`` begins; arrivals are Poisson
at ``burst_factor`` times the rate between bursts, so that the mean over
a period is ``rate_rps``.  Request sizes are ``open_serve``'s (uniform on
1..``max_batch`` images).  One draw, the same for every seed, from
``DRAW_SEED``: each phase (bursts, gaps) a Poisson process on its own
clock, the phase's time inside the window laid end to end, cut where that
time runs out.  The run's ``seed`` then shuffles the gaps and, apart, the
sizes within the bursts, and again within the gaps: every seed offers the
same requests, the same images and the same number in the bursts, in
another order (a fresh draw would move the load by its own spread).
"""
from __future__ import annotations

import numpy as np

from chipbench import harness, reference

_open = harness.load_module("traffic", "open_serve")
build, serve, window, check, control, end_to_end, free = (
    _open.build, _open.serve, _open.window, _open.check, _open.control,
    _open.end_to_end, _open.free)
n_drawn, percentile = _open.n_drawn, _open.percentile

DRAW_SEED = 0


def rates(rate_rps: float, period_s: float, burst_s: float,
          factor: float) -> tuple:
    """(between bursts, in a burst), in requests a second, whose mean
    over a period is ``rate_rps``."""
    low = rate_rps * period_s / (factor * burst_s + period_s - burst_s)
    return low, factor * low


def phase_time(seconds: float, offset: float, length: float,
               period: float) -> float:
    """How much of ``[0, seconds)`` lies in the phase that starts
    ``offset`` into every period and lasts ``length``."""
    full = int(seconds // period)
    rest = seconds - full * period - offset
    return full * length + min(max(rest, 0.0), length)


def arrivals(rate_rps: float, seconds: float, max_batch: int, seed: int, *,
             period_s: float = 0.5, burst_s: float = 0.05,
             factor: float = 10.0) -> list:
    """(offset s, images) of each request due in the first ``seconds``,
    in time order."""
    low, high = rates(rate_rps, period_s, burst_s, factor)
    order = np.random.default_rng(seed)
    out = []
    for phase, (rate, offset, length) in enumerate(
            ((high, 0.0, burst_s), (low, burst_s, period_s - burst_s))):
        span = phase_time(seconds, offset, length, period_s)
        n = n_drawn(rate, span)
        rng = np.random.default_rng([DRAW_SEED, phase])
        gaps = rng.exponential(1.0 / rate, n)
        sizes = rng.integers(1, max_batch + 1, n)
        t = np.cumsum(gaps)
        if t[-1] < span:
            raise RuntimeError("the drawn gaps fall short of the window")
        k = int(np.searchsorted(t, span))
        tau = np.cumsum(order.permutation(gaps[:k]))
        sizes = order.permutation(sizes[:k])
        due = (tau // length) * period_s + offset + np.mod(tau, length)
        out.extend((float(d), int(b)) for d, b in zip(due, sizes))
    return sorted(out)


def schedule(traffic: dict, seconds: float, seed: int) -> list:
    return arrivals(traffic["rate_rps"], seconds, traffic["max_batch"],
                    seed, period_s=traffic["period_ms"] * 1e-3,
                    burst_s=traffic["burst_ms"] * 1e-3,
                    factor=traffic["burst_factor"])


def setup(ctx):
    layers = ctx.cfg["layers"]
    kernels, biases = reference.make_params(layers, ctx.seed, ctx.device)
    ctx.stamp("weights")
    eng = build(ctx, kernels, biases)
    ctx.stamp("plan, prepare, capture, warm")
    return {"eng": eng, "kernels": kernels, "biases": biases,
            "schedule": schedule(ctx.traffic, ctx.seconds, ctx.seed)}
