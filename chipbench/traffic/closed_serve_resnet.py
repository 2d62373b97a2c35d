"""Closed-loop offline inference of ResNet-50 v1.5 through the port's
serving engine: ``closed_serve``'s loop (full batches of ``batch``
images, ``in_flight`` requests on the device, one bucket, one CUDA graph,
``timing="async"``, a reservoir sample kept) over the port's ResNet
(``repro_torch.models.resnet``).

Set-up hands the port the configuration's unfolded parameters
(``reference_resnet.make_params``); the port folds batch norm into its
convs and plans its 53 convs: the 13 unit-stride 3x3 convs on
``fft-cuda``, the other 40 on ``direct``.  The port's conv list must be
the configuration's.  The window's ``calls`` hold the 13 FFT convs only
(all unit-stride, as ``work.py`` counts them); ``model_flops`` counts
every conv at its stride and the classifier.
"""
from __future__ import annotations

import torch

from chipbench import harness, program, reference, reference_resnet

_closed = harness.load_module("traffic", "closed_serve")
end_to_end = _closed.end_to_end
free = _closed.free

KEYS = ("name", "C", "Cout", "H", "W", "k", "pad", "stride", "block", "role")


def _form(cfg, resnet) -> dict:
    """The port's ``image`` and ``width_div`` of the configuration's conv
    list (the published form: 224, 1)."""
    stem = cfg["layers"][0]
    return {"image": stem["H"], "width_div": resnet.STEM // stem["Cout"]}


def _check_topology(cfg, resnet) -> None:
    """The port's convs are the configuration's, key for key."""
    mine = [{k: getattr(c, k) for k in KEYS}
            for c in resnet.convs(**_form(cfg, resnet))]
    theirs = [{k: l[k] for k in KEYS} for l in cfg["layers"]]
    if mine != theirs:
        bad = next(i for i, (a, b) in enumerate(zip(mine, theirs))
                   if a != b) if len(mine) == len(theirs) else None
        raise RuntimeError(f"the program's ResNet differs from "
                           f"{cfg['name']}: conv {bad}")


def setup(ctx):
    from repro_torch.launch.batcher import BucketPolicy, ServeEngine
    from repro_torch.models import resnet
    cfg, b = ctx.cfg, ctx.traffic["batch"]
    _check_topology(cfg, resnet)
    params = reference_resnet.make_params(cfg, ctx.seed, ctx.device)
    ctx.sync()
    ctx.stamp("weights")
    folded = resnet.fold_batchnorm(params)
    ctx.sync()
    ctx.stamp("batch norm folded")
    form = _form(cfg, resnet)
    eng = ServeEngine(lambda batch: resnet.network_convs(batch, **form),
                      folded.kernels,
                      policy=BucketPolicy(max_batch=b, min_batch=b),
                      forward=resnet.make_forward(folded), timing="async",
                      device=ctx.device, backend=program.BACKEND)
    ctx.stamp("plan, prepare, capture")
    x = torch.zeros(reference_resnet.input_shape(cfg, b), device=ctx.device)
    for _ in range(ctx.traffic["in_flight"] + 1):     # the host path, warm
        eng.submit(x)
        eng.drain()
    eng.finish()
    eng.results.clear()
    return {"eng": eng, "params": params}


def window(ctx, state):
    rec = _closed.window(ctx, state)
    n, b = rec["attempted"], ctx.traffic["batch"]
    rec["model_flops"] = reference_resnet.model_flops(ctx.cfg, n * b)
    rec["calls"] = [{"layer": l, "batch": b, "n": n, "pass": "fwd"}
                    for l in reference_resnet.fft_layers(ctx.cfg)]
    return rec


def _compare(ctx, state, *, control):
    cfg = ctx.cfg
    shape = reference_resnet.input_shape(cfg, ctx.traffic["batch"])
    err = 0.0
    for idx, y in sorted(state["kept"].items()):
        x = reference.make_input(shape, ctx.seed, idx, ctx.device)
        y_ref = reference_resnet.forward(cfg, state["params"], x)
        if control:
            y = reference_resnet.forward(cfg, state["params"], x, tf32=True)
        err = max(err, reference.scaled_err(y, y_ref))
    return {"out_err": err}


def check(ctx, state, rec):
    return _compare(ctx, state, control=False)


def control(ctx, state, rec):
    return _compare(ctx, state, control=True)
