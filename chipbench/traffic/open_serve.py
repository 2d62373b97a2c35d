"""Open-loop serving through the port's engine: independent clients whose
requests arrive on a Poisson schedule at a fixed rate, each of 1 to
``max_batch`` images (``synthetic_trace``'s draw, copied here, in an
order of the seed's), whatever the server is doing.

Buckets are the powers of two up to ``max_batch``, one CUDA graph each,
with the engine's batching window and per-batch timing.  Each request is
timed by the host from when it was due to when the engine handed its
result back (``drain`` returned with it), so a stall counts against every
request it delays.  Requests due in the window are all waited for.  A
sample of ``sample`` requests, drawn from the seed, keeps its outputs for
the comparison with the reference.
"""
from __future__ import annotations

import math
import random
import time

import numpy as np
import torch

from chipbench import program, reference, work

SPIN_S = 2e-4            # sleep until this close to a deadline, then spin
GRACE_S = 60.0           # how long past the last due time results are awaited
DRAW_SEED = 0            # the one draw of gaps and sizes that every seed shuffles


def n_drawn(rate_rps: float, seconds: float) -> int:
    """Requests drawn for a window: ten deviations past the mean count."""
    mean = rate_rps * seconds
    return math.ceil(mean + 10 * math.sqrt(mean) + 10)


def arrivals(rate_rps: float, seconds: float, max_batch: int, seed: int):
    """(offset s, images) of each request due in the first ``seconds``.

    One draw, the same for every seed: ``synthetic_trace``'s (all
    exponential gaps at ``rate_rps`` first, then a size uniform on
    1..max_batch a request) from ``DRAW_SEED``, cut at ``seconds``.  The
    run's ``seed`` then shuffles its gaps and, apart, its sizes: every
    seed offers the same requests and images in the same time, in another
    order (a fresh Poisson count would move the load by its own spread).
    """
    n = n_drawn(rate_rps, seconds)
    rng = np.random.default_rng(DRAW_SEED)
    gaps = rng.exponential(1.0 / rate_rps, n)
    sizes = rng.integers(1, max_batch + 1, n)
    t = np.cumsum(gaps)
    if t[-1] < seconds:
        raise RuntimeError("the drawn gaps fall short of the window")
    k = int(np.searchsorted(t, seconds))
    order = np.random.default_rng(seed)
    gaps = order.permutation(gaps[:k])
    sizes = order.permutation(sizes[:k])
    return [(float(ti), int(b)) for ti, b in zip(np.cumsum(gaps), sizes)]


def _image_shape(ctx):
    l0 = ctx.cfg["layers"][0]
    return (l0["C"], l0["H"], l0["W"])


def build(ctx, kernels, biases):
    """The engine of this cell, every bucket captured."""
    from repro_torch.launch.batcher import BucketPolicy, ServeEngine
    layers = ctx.cfg["layers"]
    tr = ctx.traffic
    eng = ServeEngine(lambda batch: program.network(ctx.cfg, layers, batch),
                      kernels, policy=BucketPolicy(max_batch=tr["max_batch"]),
                      forward=program.trunk_forward(layers, biases),
                      window_s=tr["batch_window_ms"] * 1e-3,
                      timing="per-batch", clock=time.perf_counter,
                      device=ctx.device, backend=program.BACKEND)
    shape = _image_shape(ctx)
    for b in eng.policy.batch_buckets():        # the host path, warm
        eng.submit(torch.zeros((b,) + shape, device=ctx.device))
        eng.drain(force=True)
    eng.results.clear()
    return eng


def setup(ctx):
    layers = ctx.cfg["layers"]
    kernels, biases = reference.make_params(layers, ctx.seed, ctx.device)
    ctx.stamp("weights")
    eng = build(ctx, kernels, biases)
    ctx.stamp("plan, prepare, capture, warm")
    return {"eng": eng, "kernels": kernels, "biases": biases,
            "schedule": arrivals(ctx.traffic["rate_rps"], ctx.seconds,
                                 ctx.traffic["max_batch"], ctx.seed)}


def _wait_until(t):
    dt = t - time.perf_counter()
    if dt > SPIN_S:
        time.sleep(dt - SPIN_S)
    while time.perf_counter() < t:
        pass


def serve(ctx, eng, schedule, keep=()):
    """Replay ``schedule`` through ``eng`` in real time.  Returns per
    request (due, submitted, done) on the host clock, the engine's rid of
    each, the kept outputs by request index, and the requests that never
    came back within ``GRACE_S`` of the last due time."""
    shape = _image_shape(ctx)
    window_s = ctx.traffic["batch_window_ms"] * 1e-3
    keep = set(keep)
    n = len(schedule)
    due = [0.0] * n
    sub = [0.0] * n
    done = [0.0] * n
    rids = [0] * n
    index_of: dict = {}
    kept: dict = {}
    waiting: list = []                 # request indices in the queue
    t0 = time.perf_counter()
    give_up = t0 + (schedule[-1][0] if schedule else 0.0) + GRACE_S
    i = 0
    while i < n or waiting:
        now = time.perf_counter()
        if i >= n and now > give_up:
            break
        while i < n and t0 + schedule[i][0] <= now:
            due[i] = t0 + schedule[i][0]
            with ctx.span("make input"):
                x = reference.make_input((schedule[i][1],) + shape,
                                         ctx.seed, i, ctx.device)
            with ctx.span("submit"):
                sub[i] = time.perf_counter()
                rids[i] = eng.submit(x)
            index_of[rids[i]] = i
            waiting.append(i)
            i += 1
        with ctx.span("drain"):
            eng.drain(force=i >= n)
        now = time.perf_counter()
        for rid in list(eng.results):
            j = index_of.pop(rid)
            done[j] = now
            y = eng.results.pop(rid)
            if j in keep:
                kept[j] = y
        waiting = [j for j in waiting if done[j] == 0.0]
        nxt = t0 + schedule[i][0] if i < n else None
        if waiting:
            flush = sub[waiting[0]] + window_s
            nxt = flush if nxt is None else min(nxt, flush)
        if nxt is not None:
            with ctx.span("idle"):
                _wait_until(nxt)
    # a request never handed back waited until the loop gave up on it
    lost = [j for j in range(n) if done[j] == 0.0]
    for j in lost:
        done[j] = time.perf_counter()
    return due, sub, done, rids, kept, lost


def sample(n: int, k: int, seed: int) -> list:
    """``k`` request indices of ``n``, drawn from the seed."""
    return sorted(random.Random(seed).sample(range(n), min(k, n)))


def window(ctx, state):
    eng, schedule = state["eng"], state["schedule"]
    keep = sample(len(schedule), ctx.traffic["sample"], ctx.seed)
    state["keep"] = keep
    seen = {k: (len(v.service_s), len(v.latencies_s))
            for k, v in eng._stats.items()}
    n_placed = len(eng.placements)
    due, sub, done, rids, kept, lost = serve(ctx, eng, schedule, keep)
    ctx.sync()
    state["kept"] = kept
    batches = batches_of(eng, seen, n_placed)
    return dict(records(ctx, schedule, due, sub, done, rids, batches),
                failed=len(lost))


def batches_of(eng, seen, n_placed):
    """The batches the engine ran since it had placed ``n_placed``
    requests, in order, as (bucket, [(rid, engine latency)], service s):
    from its placements (a request placed at row 0 opens a batch) and its
    per-bucket records (``seen``: label -> how many batches and latencies
    it held before)."""
    ordinal = dict(seen)
    out = []
    for rid, (label, _, off) in list(eng.placements.items())[n_placed:]:
        st = eng._stats[label]
        nb, nl = ordinal.get(label, (0, 0))
        if off == 0:
            out.append([int(label[1:]), [], st.service_s[nb]])
            nb += 1
        out[-1][1].append((rid, st.latencies_s[nl]))
        ordinal[label] = (nb, nl + 1)
    return out


def records(ctx, schedule, due, sub, done, rids, batches):
    """The window's records: each request's latency from its due time, its
    wait from its due time to the start of its batch (the engine's clock
    is this one: the batch began its service time before the engine's
    latency ran out), and the bucket of every batch."""
    layers = ctx.cfg["layers"]
    index = {rid: j for j, rid in enumerate(rids)}
    waits, calls, real = [], {}, 0
    for bucket, members, service in batches:
        calls[bucket] = calls.get(bucket, 0) + 1
        for rid, lat in members:
            j = index[rid]
            real += schedule[j][1]
            waits.append(sub[j] + lat - service - due[j])
    images = sum(b for _, b in schedule)
    return {"attempted": len(schedule), "failed": 0, "images": images,
            "latency_s": [d - u for d, u in zip(done, due)],
            "queue_wait_s": waits, "real_rows": real,
            "padded_rows": sum(b * c for b, c in calls.items()),
            "late_s": [s - u for s, u in zip(sub, due)],
            "model_flops": work.model_flops(layers, images),
            "calls": [{"layer": l, "batch": b, "n": c, "pass": "fwd"}
                      for b, c in sorted(calls.items()) for l in layers]}


def percentile(values, q: float) -> float:
    """The ``q``-th percentile by nearest rank."""
    s = sorted(values)
    return s[max(0, min(len(s) - 1, -(-len(s) * q // 100) - 1))]


def end_to_end(ctx, rec, window_s):
    return {"req_p95_ms": percentile(rec["latency_s"], 95) * 1e3}


def free(state):
    state.pop("eng", None)


def _compare(ctx, state, *, control):
    layers, shape = ctx.cfg["layers"], _image_shape(ctx)
    if set(state["kept"]) != set(state["keep"]):
        return {"out_err": math.inf}          # a sampled answer never came
    err = 0.0
    for j, y in sorted(state["kept"].items()):
        x = reference.make_input((state["schedule"][j][1],) + shape,
                                 ctx.seed, j, ctx.device)
        with torch.no_grad():
            y_ref = reference.trunk(layers, state["kernels"],
                                    state["biases"], x)
            if control:
                y = reference.trunk(layers, state["kernels"],
                                    state["biases"], x, tf32=True)
        err = max(err, reference.scaled_err(y, y_ref))
    return {"out_err": err}


def check(ctx, state, rec):
    return _compare(ctx, state, control=False)


def control(ctx, state, rec):
    return _compare(ctx, state, control=True)
