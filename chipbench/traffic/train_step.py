"""Training the trunk through the port's plans: each step runs
``conv_block(..., backend="fft-cuda")`` with the bias and ReLU fused and
the port's ``maxpool2x2``, the loss sum(y * r) with r from the seed,
autograd through the plans' VJP (``conv/autodiff.py``), and the port's
``adamw_update``.  Every step takes a new batch, made on the device from
the seed.

Set-up builds the one training state and drives it through its first
``ref_steps`` steps, which the reference then follows from the same
start; the window goes on with the same state and the same step, and the
reference checks the window's last step from the state before it.
"""
from __future__ import annotations

import torch

from chipbench import program, reference, work
from chipbench.harness import log


def _shapes(ctx):
    layers, b = ctx.cfg["layers"], ctx.traffic["batch"]
    l0, ll = layers[0], layers[-1]
    hw = [ll["H"], ll["W"]]
    if ll.get("pool_after"):
        hw = [hw[0] // 2, hw[1] // 2]
    return (b, l0["C"], l0["H"], l0["W"]), (b, ll["Cout"], *hw)


def opt_config(ctx):
    from repro_torch.optim.adamw import AdamWConfig
    return AdamWConfig(**ctx.traffic["adamw"])


def step(ctx, params, opt, x, r, cfg, events=None):
    """One training step of the program: (loss, new params, new state)."""
    from repro_torch.models import layers as L
    from repro_torch.optim import adamw
    leaves = {g: {n: p.detach().requires_grad_() for n, p in t.items()}
              for g, t in params.items()}
    with ctx.span("forward"):
        h = x
        for l in ctx.cfg["layers"]:
            h = L.conv_block(h, leaves["kernel"][l["name"]],
                             leaves["bias"][l["name"]], activation="relu",
                             padding=l["pad"], backend=program.BACKEND)
            if l.get("pool_after"):
                h = L.maxpool2x2(h)
        loss = (h * r).sum()
    flat = adamw.tree_leaves(leaves)
    with ctx.span("backward"):
        if events is not None:
            events.append(torch.cuda.Event(enable_timing=True))
            events[-1].record()
        grads = torch.autograd.grad(loss, flat)
        if events is not None:
            events.append(torch.cuda.Event(enable_timing=True))
            events[-1].record()
    with ctx.span("optimizer"):
        new, opt, _ = adamw.adamw_update(
            adamw.tree_unflatten(leaves, grads), opt,
            adamw.tree_map(lambda t: t.detach(), leaves), cfg)
    return loss.detach(), new, opt


def _leaves(names, tree) -> list:
    """A parameter-shaped tree's leaves: kernels, then biases, layer by
    layer (the reference's order)."""
    return ([tree["kernel"][n] for n in names]
            + [tree["bias"][n] for n in names])


def _state_leaves(names, params, opt) -> list:
    return (_leaves(names, params) + _leaves(names, opt["mu"])
            + _leaves(names, opt["nu"]))


def _copies(ts) -> list:
    """Copies of ``ts`` in buffers of their own: an optimizer that writes
    in place cannot change what the check reads."""
    return [t.detach().clone() for t in ts]


def setup(ctx):
    from repro_torch.optim.adamw import adamw_init
    layers = ctx.cfg["layers"]
    names = [l["name"] for l in layers]
    kernels, biases = reference.make_params(layers, ctx.seed, ctx.device)
    x_shape, y_shape = _shapes(ctx)
    r = reference.make_input(y_shape, ctx.seed, -1, ctx.device)
    params = {"kernel": {n: t.clone() for n, t in kernels.items()},
              "bias": {n: t.clone() for n, t in biases.items()}}
    cfg = opt_config(ctx)
    opt = adamw_init(params)
    ctx.stamp("weights")
    losses = []
    for i in range(ctx.traffic["ref_steps"]):
        x = reference.make_input(x_shape, ctx.seed, i, ctx.device)
        loss, params, opt = step(ctx, params, opt, x, r, cfg)
        losses.append(loss.item())
        if i == 0:
            first_mu = _copies(_leaves(names, opt["mu"]))
            ctx.stamp("first step (plans, kernels)")
    ctx.sync()
    ctx.stamp(f"{ctx.traffic['ref_steps']} steps")
    return {"params": params, "opt": opt, "cfg": cfg, "r": r,
            "kernels": kernels, "biases": biases, "losses": losses,
            "first_mu": first_mu, "after": _copies(_leaves(names, params))}


def window(ctx, state):
    """Steps on new batches until the window closes.  Before each step the
    parameters and both moments are copied aside (about 0.4% of the window
    on an H100, PERF.md), so that the window's last step can be checked
    from the state it started from."""
    x_shape, _ = _shapes(ctx)
    names = [l["name"] for l in ctx.cfg["layers"]]
    params, opt, cfg, r = (state["params"], state["opt"], state["cfg"],
                           state["r"])
    events = [] if ctx.trace and ctx.device.type == "cuda" else None
    before = [torch.empty_like(t)
              for t in _state_leaves(names, params, opt)]
    i = ctx.traffic["ref_steps"]
    n, loss = 0, None
    while ctx.time_left():
        with ctx.span("make input"):
            x = reference.make_input(x_shape, ctx.seed, i + n, ctx.device)
        with ctx.span("copy state aside"):
            torch._foreach_copy_(before, _state_leaves(names, params, opt))
        loss, params, opt = step(ctx, params, opt, x, r, cfg, events)
        n += 1
    with ctx.span("finish"):
        ctx.sync()
    state["params"], state["opt"] = params, opt
    k = len(names) * 2
    state["last"] = {"step": i + n, "loss": loss.item(),
                     "params": before[:k], "mu": before[k:2 * k],
                     "nu": before[2 * k:],
                     "new_params": _leaves(names, params),
                     "new_mu": _leaves(names, opt["mu"])}
    layers, b = ctx.cfg["layers"], x_shape[0]
    bwd = None
    if events:
        bwd = [a.elapsed_time(e) for a, e in zip(events[::2], events[1::2])]
    calls = ([{"layer": l, "batch": b, "n": n, "pass": "fwd"}
              for l in layers]
             + [{"layer": l, "batch": b, "n": n, "pass": "dx"}
                for l in layers[1:]]
             + [{"layer": l, "batch": b, "n": n, "pass": "kernel"}
                for l in layers])
    return {"attempted": n, "failed": 0, "images": n * b,
            "model_flops": work.model_flops(layers, n * b, train=True),
            "calls": calls, "bwd_ms": bwd}


def end_to_end(ctx, rec, window_s):
    return {"train_img_s": rec["images"] / window_s}


def free(state):
    for k in ("params", "opt"):
        state.pop(k, None)


def _program_side(ctx, state):
    """What the program produced: the set-up steps' (losses, first
    gradient, parameters after them) and the window's last step's (loss,
    gradient, new parameters)."""
    b1 = state["cfg"].b1
    first = [m / (1 - b1) for m in state["first_mu"]]
    last = state["last"]
    return ((state["losses"], first, state["after"]),
            (last["loss"], reference.first_moment_grad(
                last["mu"], last["new_mu"], b1), last["new_params"]))


def _gaps(leaf_names, got_grad, want_grad, got_new, want_new, p0):
    """The worst live leaf's gap of the gradient and of the change from
    ``p0``.  Leaves whose gradient is nought to rounding move under Adam
    by round-off alone: they are left out by the reference's own gradient,
    under a thousandth of the median leaf's."""
    norms = [g.double().norm().item() for g in want_grad]
    med = sorted(norms)[len(norms) // 2]
    live = [i for i, v in enumerate(norms) if v >= 1e-3 * med]
    grad = reference.norm_gaps([got_grad[i] for i in live],
                               [want_grad[i] for i in live])
    change = reference.norm_gaps([got_new[i] - p0[i] for i in live],
                                 [want_new[i] - p0[i] for i in live])
    log(f"train check: {len(leaf_names) - len(live)} leaves left out; "
        f"worst grad {leaf_names[live[grad.index(max(grad))]]}, worst "
        f"change {leaf_names[live[change.index(max(change))]]}")
    return max(grad), max(change)


def _compare(ctx, state, got):
    """The numbers compared: ``got`` (``_program_side``'s form, or the
    control's) against the plain reference.  The set-up steps are followed
    from the benchmark's own start; the window's last step from the state
    the program had before it, which the reference cannot reach by itself
    after hundreds of steps."""
    layers = ctx.cfg["layers"]
    names = [l["name"] for l in layers]
    leaf_names = [f"{n}/{kind}" for kind in ("kernel", "bias")
                  for n in names]
    x_shape, _ = _shapes(ctx)
    opt, r = ctx.traffic["adamw"], state["r"]
    (g_losses, g_first, g_after), (g_loss, g_grad, g_new) = got
    # the set-up steps, from the start
    batches = [reference.make_input(x_shape, ctx.seed, i, ctx.device)
               for i in range(ctx.traffic["ref_steps"])]
    k0, b0 = state["kernels"], state["biases"]
    losses, first, after = reference.train(layers, k0, b0, batches, r, opt)
    scale = reference.loss_scale(layers, k0, b0, batches[0], r)
    p0 = [k0[n] for n in names] + [b0[n] for n in names]
    grad, change = _gaps(leaf_names, g_first, first, g_after, after, p0)
    # the window's last step, from the program's state before it
    last = state["last"]
    x = reference.make_input(x_shape, ctx.seed, last["step"] - 1,
                             ctx.device)
    n = len(names)
    kd = dict(zip(names, last["params"][:n]))
    bd = dict(zip(names, last["params"][n:]))
    loss, grad_l, new = reference.step_from(
        layers, last["params"], last["mu"], last["nu"], last["step"], x, r,
        opt)
    scale_l = reference.loss_scale(layers, kd, bd, x, r)
    last_grad, last_change = _gaps(leaf_names, g_grad, grad_l, g_new, new,
                                   last["params"])
    # the first step's loss: later set-up steps' losses carry Adam's sign
    # noise on gradients that are nought to rounding (PERF.md)
    return {"loss_gap": abs(g_losses[0] - losses[0]) / scale,
            "grad_gap": grad, "change_gap": change,
            "last_loss_gap": abs(g_loss - loss) / scale_l,
            "last_grad_gap": last_grad, "last_change_gap": last_change}


def check(ctx, state, rec):
    return _compare(ctx, state, _program_side(ctx, state))


def control(ctx, state, rec):
    """The reference with TF32 operands in the program's place, on the
    same start and the same state before the last step."""
    layers = ctx.cfg["layers"]
    x_shape, _ = _shapes(ctx)
    opt, r, last = ctx.traffic["adamw"], state["r"], state["last"]
    batches = [reference.make_input(x_shape, ctx.seed, i, ctx.device)
               for i in range(ctx.traffic["ref_steps"])]
    setup_side = reference.train(layers, state["kernels"], state["biases"],
                                 batches, r, opt, tf32=True)
    x = reference.make_input(x_shape, ctx.seed, last["step"] - 1,
                             ctx.device)
    last_side = reference.step_from(layers, last["params"], last["mu"],
                                    last["nu"], last["step"], x, r, opt,
                                    tf32=True)
    return _compare(ctx, state, (setup_side, last_side))
