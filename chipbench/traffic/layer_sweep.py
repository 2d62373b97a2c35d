"""Each layer of the configuration as its own prepared plan, called in turn,
eager, the sweep repeated through the window (a library user calling one
conv layer at a time).  Each layer has one input, made on the device from
the seed; the outputs of the window's first and last sweeps are kept for
the comparison with the reference.
"""
from __future__ import annotations

import torch

from chipbench import program, reference, work


def _x_shape(layer, b):
    return (b, layer["C"], layer["H"], layer["W"])


def setup(ctx):
    layers, b = ctx.cfg["layers"], ctx.traffic["batch"]
    kernels, biases = reference.make_params(layers, ctx.seed, ctx.device)
    ctx.stamp("weights")
    prepared, inputs = [], []
    for i, l in enumerate(layers):
        plan = program.plan_layer(ctx.cfg, l, b)
        prepared.append(plan.prepare(kernels[l["name"]], weights_version=0))
        inputs.append(reference.make_input(_x_shape(l, b), ctx.seed, i,
                                           ctx.device))
    ctx.stamp("plan, prepare, inputs")
    with torch.inference_mode():
        for _ in range(2):
            for p, x, l in zip(prepared, inputs, layers):
                p(x, bias=biases[l["name"]])
    ctx.sync()
    return {"prepared": prepared, "inputs": inputs, "kernels": kernels,
            "biases": biases}


def window(ctx, state):
    layers = ctx.cfg["layers"]
    bias = [state["biases"][l["name"]] for l in layers]
    names = [l["name"] for l in layers]
    calls = list(zip(names, state["prepared"], state["inputs"], bias))
    sweeps, first, last = 0, None, None
    with torch.inference_mode():
        while ctx.time_left():
            ys = []
            for name, p, x, b in calls:
                with ctx.span(name):
                    ys.append(p(x, bias=b))
            if first is None:
                first = ys
            last = ys
            sweeps += 1
        with ctx.span("finish"):
            ctx.sync()
    state["outputs"] = (first, last)
    b = ctx.traffic["batch"]
    return {"attempted": sweeps * len(layers), "failed": 0,
            "images": sweeps * b,
            "model_flops": work.model_flops(layers, sweeps * b),
            "calls": [{"layer": l, "batch": b, "n": sweeps, "pass": "fwd"}
                      for l in layers]}


def end_to_end(ctx, rec, window_s):
    return {"conv_tflop_s": rec["model_flops"] / window_s / 1e12}


def free(state):
    state.pop("prepared", None)


def _compare(ctx, state, *, control):
    layers = ctx.cfg["layers"]
    err = 0.0
    for ys in state["outputs"]:
        for l, x, y in zip(layers, state["inputs"], ys):
            k, b = state["kernels"][l["name"]], state["biases"][l["name"]]
            with torch.no_grad():
                y_ref = reference.conv(x, k, b, l["pad"])
                if control:
                    y = reference.conv(x, k, b, l["pad"], tf32=True)
            err = max(err, reference.scaled_err(y, y_ref))
    return {"out_err": err}


def check(ctx, state, rec):
    return _compare(ctx, state, control=False)


def control(ctx, state, rec):
    return _compare(ctx, state, control=True)
