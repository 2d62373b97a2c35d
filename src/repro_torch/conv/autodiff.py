"""Plan-level reverse-mode autodiff for the stage-graph conv engine.

Differentiability is a property of the *plan*, not of one backend's
implementation: every backend that executes through a stage pipeline gets
the same ``torch.autograd.Function``, defined once here over the whole
pipeline —

  dx : a *transposed* plan (same backend, schedule and precision as the
       forward) applied to the conv-output cotangent and the spatially
       flipped, channel-transposed kernel, "full"-correlation padding,
       cropped by the forward padding;
  dk : direct correlation of x with the conv-output cotangent, batch as
       the contraction axis (dy's spatial extent exceeds the FFT tile, so
       the direct path — cuDNN's weight-gradient routine on the card — is
       the right algorithm).

Fused-epilogue plans train through the same machinery: the forward
computes the *pre-activation* value ``z`` via a plan whose epilogue keeps
bias/residual fused but drops the activation, the activation is applied
outside, and the backward pass first pulls ``dy`` back through the
activation at ``z`` —

  dz         = dy * act'(z)      (the conv-output cotangent)
  d_bias     = sum dz over (B, H, W)
  d_residual = dz
  dx, dk     = the unfused rules above, driven by dz.

Because the backward pass is expressed as plans, it runs through the same
stage graph as the forward: on ``fft-cuda`` the dx plan runs the tile DFT
kernels, the CUDA CGEMM and the unfused inverse kernel.  The kernels
themselves are never differentiated through.  Each grad is computed only
when autograd asks for it (``ctx.needs_input_grad``), and the dx plan goes
through ``ConvPlan.__call__`` again, so a double backward
(``create_graph=True``) differentiates the backward pass itself; ``z`` is
then recomputed with a graph, so second-order terms through the
activation are carried.

Nothing saved for backward may be an inference tensor (autograd refuses
to save one): a saved operand that was made under ``torch.inference_mode()``
is cloned first.  Prepared slabs are never saved; the ``PreparedConv`` is
held on the context.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.conv.epilogue import ACTIVATIONS, activation_vjp, bias_grad


def _pipeline(plan):
    from repro_torch.conv import registry
    return registry.get_backend(plan.backend).make_pipeline(plan)


def _pre_activation_plan(plan):
    """The same plan with the activation dropped from its epilogue (bias
    and residual stay fused): its output is the pre-activation ``z`` the
    backward pass needs."""
    return dataclasses.replace(
        plan, epilogue=dataclasses.replace(plan.epilogue, activation="none"))


def _transposed_plan(plan):
    """The plan computing dx: conv of dy (B, C', Ho, Wo) with the flipped,
    transposed kernel (C, C', kh, kw) at full-correlation padding, on the
    same backend x schedule (and precision and tile knobs) as the
    forward.
    No epilogue — cotangents propagate through the raw conv."""
    from repro_torch.conv.plan import plan_conv
    s = plan.spec
    return plan_conv(
        (s.B, s.Cout, s.Ho, s.Wo), (s.C, s.Cout, s.kh, s.kw),
        padding=(s.kh - 1, s.kw - 1), delta=s.delta, backend=plan.backend,
        schedule=plan.schedule, three_m=plan.three_m,
        bm=plan.bm, bn=plan.bn, bk=plan.bk,
        compute_dtype=plan.compute_dtype, spectrum=plan.spectrum)


def _dx_via_transposed_plan(plan, k, dz):
    """dx: transposed plan on the flipped/channel-transposed kernel; the
    call goes through ``ConvPlan.__call__``, so under ``create_graph`` it
    is itself differentiable."""
    s, pad = plan.spec, plan.padding
    kt = torch.flip(k, dims=(-2, -1)).transpose(0, 1)   # (C, C', kh, kw)
    dx_full = _transposed_plan(plan)(dz, kt)
    return dx_full[:, :, pad[0]:pad[0] + s.H, pad[1]:pad[1] + s.W]


def _dk_direct(plan, x, dz, k_dtype):
    """dk: correlation of x with dz, batch as the contraction axis. The
    "kernel" (dz) spatial extent exceeds the tile, so use the direct path:
    cuDNN's weight-gradient routine on the card.  (Posed as a forward
    convolution whose kernel spans the image, as the JAX package poses it,
    cuDNN takes two orders of magnitude longer on an H100: PERF.md.)"""
    s = plan.spec
    return torch.nn.grad.conv2d_weight(
        x, (s.Cout, s.C, s.kh, s.kw), dz.to(x.dtype),
        padding=plan.padding).to(k_dtype)


def _saveable(t):
    """``t`` as autograd may save it: an inference tensor is cloned."""
    return t.clone() if t is not None and t.is_inference() else t


class _PipelineConv(torch.autograd.Function):
    """``plan(x, k, bias=, residual=)`` with the plan-level VJP."""

    @staticmethod
    def forward(ctx, plan, x, k, bias, residual):
        ep = plan.epilogue
        if ep.activation == "none":
            # no activation: the fused output IS the pre-activation value
            y = _pipeline(plan).full(plan, x, k, bias=bias,
                                     residual=residual)
            z = None
        else:
            pre = _pre_activation_plan(plan)
            z = _pipeline(pre).full(pre, x, k, bias=bias, residual=residual)
            y = ACTIVATIONS[ep.activation](z)
        ctx.plan = plan
        ctx.save_for_backward(*map(_saveable, (x, k, bias, residual, z)))
        return y

    @staticmethod
    def backward(ctx, dy):
        x, k, bias, residual, z = ctx.saved_tensors
        plan = ctx.plan
        ep = plan.epilogue
        if z is not None and torch.is_grad_enabled():
            # double backward: z with its graph to the operands
            z = _pre_activation_plan(plan)(x, k, bias=bias,
                                           residual=residual)
        # activation grad first: the conv-output cotangent dz drives all
        dz = dy if z is None else activation_vjp(ep, z, dy)
        _, need_x, need_k, need_bias, need_res = ctx.needs_input_grad
        dx = _dx_via_transposed_plan(plan, k, dz).to(x.dtype) \
            if need_x else None
        dk = _dk_direct(plan, x, dz, k.dtype) if need_k else None
        dbias = bias_grad(dz).to(bias.dtype) if need_bias else None
        dres = dz.to(residual.dtype) if need_res else None
        return None, dx, dk, dbias, dres


class _PreparedConv(torch.autograd.Function):
    """``prepared(x, bias=, residual=)`` with grads w.r.t. ``x`` and the
    epilogue operands.  The conv kernel is frozen in a prepared plan; there
    is no dk."""

    @staticmethod
    def forward(ctx, prepared, x, bias, residual):
        plan = prepared.plan
        ep = plan.epilogue
        run = plan if ep.activation == "none" else _pre_activation_plan(plan)
        z = _pipeline(run).execute(run, x, prepared.state, bias=bias,
                                   residual=residual)
        y = z if ep.activation == "none" else ACTIVATIONS[ep.activation](z)
        ctx.prepared = prepared
        ctx.save_for_backward(*map(_saveable, (
            x, bias, residual, None if ep.activation == "none" else z)))
        return y

    @staticmethod
    def backward(ctx, dy):
        x, bias, residual, z = ctx.saved_tensors
        prepared = ctx.prepared
        plan = prepared.plan
        ep = plan.epilogue
        if z is not None and torch.is_grad_enabled():
            pre = dataclasses.replace(prepared,
                                      plan=_pre_activation_plan(plan))
            z = pre(x, bias=bias, residual=residual)
        dz = dy if z is None else activation_vjp(ep, z, dy)
        _, need_x, need_bias, need_res = ctx.needs_input_grad
        dx = None
        if need_x:
            if prepared.kernel is None:
                raise ValueError(
                    "dx of a PreparedConv needs its kernel: build it with "
                    "plan.prepare(k) (or pass kernel=)")
            dx = _dx_via_transposed_plan(plan, prepared.kernel,
                                         dz).to(dy.dtype)
        dbias = bias_grad(dz).to(bias.dtype) if need_bias else None
        dres = dz.to(residual.dtype) if need_res else None
        return None, dx, dbias, dres


def _refuse_sharded(plan):
    """The dx plan of a sharded plan would be sharded too, and its
    operands DTensors: not ported yet."""
    if plan.mesh is not None:
        raise NotImplementedError(
            f"grads through schedule {plan.schedule!r} (the plan-level "
            "VJP of the sharded schedules) are not yet ported to "
            "repro_torch (ROADMAP Queue 1 item 12)")


def pipeline_conv(plan, x, k, bias=None, residual=None):
    """Differentiable execution of a stage-pipeline plan (epilogue fused)."""
    _refuse_sharded(plan)
    return _PipelineConv.apply(plan, x, k, bias, residual)


def prepared_conv(prepared, x, bias=None, residual=None):
    """Execute a ``PreparedConv`` with grads w.r.t. ``x`` (and bias /
    residual, when the epilogue carries them) defined by the same
    transposed-plan VJP as ``pipeline_conv``."""
    _refuse_sharded(prepared.plan)
    return _PreparedConv.apply(prepared, x, bias, residual)
