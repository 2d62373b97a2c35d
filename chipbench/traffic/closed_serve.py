"""Closed-loop offline inference through the port's serving engine.

Every request is a full batch of ``batch`` images; ``in_flight`` requests
are kept on the device (the next is submitted once the one before the last
has finished).  ``ServeEngine`` runs one bucket, one CUDA graph,
``timing="async"``.  Inputs are made on the device from the seed, one per
request.  A reservoir sample of ``sample`` requests, drawn from the seed,
keeps its outputs for the comparison with the reference.
"""
from __future__ import annotations

import collections
import random

import torch

from chipbench import program, reference, work


def _shape(ctx):
    l0 = ctx.cfg["layers"][0]
    return (ctx.traffic["batch"], l0["C"], l0["H"], l0["W"])


def setup(ctx):
    from repro_torch.launch.batcher import BucketPolicy, ServeEngine
    layers, b = ctx.cfg["layers"], ctx.traffic["batch"]
    kernels, biases = reference.make_params(layers, ctx.seed, ctx.device)
    ctx.stamp("weights")
    eng = ServeEngine(lambda batch: program.network(ctx.cfg, layers, batch),
                      kernels, policy=BucketPolicy(max_batch=b, min_batch=b),
                      forward=program.trunk_forward(layers, biases),
                      timing="async", device=ctx.device,
                      backend=program.BACKEND)
    ctx.stamp("plan, prepare, capture")
    x = torch.zeros(_shape(ctx), device=ctx.device)
    for _ in range(ctx.traffic["in_flight"] + 1):     # the host path, warm
        eng.submit(x)
        eng.drain()
    eng.finish()
    eng.results.clear()
    return {"eng": eng, "kernels": kernels, "biases": biases}


class _Done:
    """Completion of the work enqueued so far."""

    def __init__(self, device):
        self.ev = None
        if device.type == "cuda":
            self.ev = torch.cuda.Event()
            self.ev.record()

    def wait(self):
        if self.ev is not None:
            self.ev.synchronize()


def window(ctx, state):
    eng, shape = state["eng"], _shape(ctx)
    k = ctx.traffic["sample"]
    rng = random.Random(ctx.seed)
    kept: dict = {}                   # request index -> its output rows
    slots: list = []                  # reservoir of request indices
    done = collections.deque()
    n = 0
    while ctx.time_left():
        with ctx.span("make input"):
            x = reference.make_input(shape, ctx.seed, n, ctx.device)
        with ctx.span("submit"):
            rid = eng.submit(x)
        with ctx.span("drain"):
            eng.drain()
        y = eng.results.pop(rid)
        if len(slots) < k:
            slots.append(n)
            kept[n] = y
        else:
            j = rng.randrange(n + 1)
            if j < k:
                kept.pop(slots[j])
                slots[j] = n
                kept[n] = y
        done.append(_Done(ctx.device))
        if len(done) >= ctx.traffic["in_flight"]:
            with ctx.span("wait"):
                done.popleft().wait()
        n += 1
    with ctx.span("finish"):
        eng.finish()
        ctx.sync()
    state["kept"] = kept
    b, layers = shape[0], ctx.cfg["layers"]
    return {"attempted": n, "failed": 0, "images": n * b,
            "model_flops": work.model_flops(layers, n * b),
            "calls": [{"layer": l, "batch": b, "n": n, "pass": "fwd"}
                      for l in layers]}


def end_to_end(ctx, rec, window_s):
    return {"infer_img_s": rec["images"] / window_s}


def free(state):
    state.pop("eng", None)


def _compare(ctx, state, *, control):
    layers, shape = ctx.cfg["layers"], _shape(ctx)
    err = 0.0
    for idx, y in sorted(state["kept"].items()):
        x = reference.make_input(shape, ctx.seed, idx, ctx.device)
        with torch.no_grad():
            y_ref = reference.trunk_rows(layers, state["kernels"],
                                         state["biases"], x)
            if control:
                y = reference.trunk_rows(layers, state["kernels"],
                                         state["biases"], x, tf32=True)
        err = max(err, reference.scaled_err(y, y_ref))
    return {"out_err": err}


def check(ctx, state, rec):
    return _compare(ctx, state, control=False)


def control(ctx, state, rec):
    return _compare(ctx, state, control=True)
