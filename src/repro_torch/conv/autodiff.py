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

The sharded schedules (``nfft``, ``wfft``) train through the same rules,
SPMD on every rank of the plan's mesh, as the reference's do under
``shard_map``: the dx plan is sharded like the forward (mesh, axes,
overlap, replicated kernel transform), so the gradient of an ``nfft`` conv
is an ``nfft`` conv, collectives and all.  The cotangent arrives as a
``DTensor``; each rank pulls its block of it back through the activation,
hands the dx plan ``dz`` as a ``DTensor`` placed like the output, and
crops the dx plan's ``DTensor`` output on its local block.  dk and d_bias
are computed from each rank's batch block and reduced by counted
collectives (``stages.grad_kernel``, ``stages.grad_bias``) into plain
tensors equal on every rank; dx or d_residual of a plain operand is
gathered whole by a counted one (``stages.grad_full``).  Each grad is
the kind of its operand: a plain operand gets a plain global grad, a
``DTensor`` operand a ``DTensor`` placed like it.  A double backward
through a sharded plan is not tested (nor is it in the reference).

Nothing saved for backward may be an inference tensor (autograd refuses
to save one): a saved operand that was made under ``torch.inference_mode()``
is cloned first.  Prepared slabs are never saved; the ``PreparedConv`` is
held on the context.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.conv import stages
from repro_torch.conv.epilogue import ACTIVATIONS, activation_vjp, bias_grad
from repro_torch.core.trace import span


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
    same backend x schedule (and mesh, precision, tile, ``dft_bt`` and
    overlap knobs) as the forward.
    No epilogue — cotangents propagate through the raw conv."""
    from repro_torch.conv.plan import plan_conv
    s = plan.spec
    return plan_conv(
        (s.B, s.Cout, s.Ho, s.Wo), (s.C, s.Cout, s.kh, s.kw),
        padding=(s.kh - 1, s.kw - 1), delta=s.delta, backend=plan.backend,
        schedule=plan.schedule, mesh=plan.mesh, three_m=plan.three_m,
        bm=plan.bm, bn=plan.bn, bk=plan.bk, dft_bt=plan.dft_bt,
        compute_dtype=plan.compute_dtype, data_axis=plan.data_axis,
        model_axis=plan.model_axis,
        replicate_kernel_transform=plan.replicate_kernel_transform,
        spectrum=plan.spectrum, overlap=plan.overlap)


def _dx_via_transposed_plan(plan, k, dz):
    """dx: transposed plan on the flipped/channel-transposed kernel; the
    call goes through ``ConvPlan.__call__``, so under ``create_graph`` it
    is itself differentiable.  On a mesh ``dz`` is a ``DTensor`` placed
    like the output, and so is the dx plan's output over (B, C): it is
    cropped on each rank's local block (slicing a ``DTensor`` of uneven
    shards would redistribute it)."""
    s, pad = plan.spec, plan.padding
    kt = torch.flip(k, dims=(-2, -1)).transpose(0, 1)   # (C, C', kh, kw)
    dx_full = _transposed_plan(plan)(dz, kt)
    if plan.mesh is None:
        return dx_full[:, :, pad[0]:pad[0] + s.H, pad[1]:pad[1] + s.W]
    from torch.distributed.tensor import DTensor
    crop = dx_full.to_local()[:, :, pad[0]:pad[0] + s.H,
                              pad[1]:pad[1] + s.W]
    return DTensor.from_local(
        crop.contiguous(), plan.mesh, dx_full.placements, run_check=False,
        shape=torch.Size((s.B, s.C, s.H, s.W)),
        stride=(s.C * s.H * s.W, s.H * s.W, s.W, 1))


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


def _like(t, g):
    """The grad ``g`` (a ``DTensor`` on a mesh) in the kind of its operand
    ``t``, in ``t``'s dtype: a ``DTensor`` for a ``DTensor`` operand, the
    global tensor for a plain one, gathered by a counted collective
    (autograd would store a ``DTensor`` as the ``.grad`` of a plain tensor
    without complaint)."""
    from torch.distributed.tensor import DTensor
    if isinstance(g, DTensor) and not isinstance(t, DTensor):
        g = stages.grad_full(g)
    return g.to(t.dtype)


def _activate(ep, z):
    """The epilogue's activation of the pre-activation ``z`` (on each
    rank's local block of a ``DTensor``)."""
    return stages.on_local(ACTIVATIONS[ep.activation], z)


def _grads(plan, k, x, z, dy, bias, residual, need):
    """(dx, dk, d_bias, d_residual) of a plan, each computed only where
    ``need`` (the operands' ``needs_input_grad``) asks for it: the rules
    of the module docstring, on one device or on each rank's blocks of a
    mesh."""
    need_x, need_k, need_bias, need_res = need
    ep = plan.epilogue
    dx = dk = dbias = None
    if plan.mesh is None:
        # activation grad first: the conv-output cotangent dz drives all
        dz = dy
        if z is not None:
            with span("vjp/act"):
                dz = activation_vjp(ep, z, dy)
        if need_x:
            with span("vjp/dx"):
                dx = _dx_via_transposed_plan(plan, k, dz).to(x.dtype)
        if need_k:
            with span("vjp/dk"):
                dk = _dk_direct(plan, x, dz, k.dtype)
        if need_bias:
            with span("vjp/dbias"):
                dbias = bias_grad(dz).to(bias.dtype)
        return dx, dk, dbias, dz.to(residual.dtype) if need_res else None
    sh = stages._shard(plan)
    # the rank's block of dz, zero-padded (padded rows and channels carry
    # zero cotangent), and dz as a DTensor placed like the output
    dzb = stages.output_block(plan, dy, sh)
    if z is not None:
        with span("vjp/act"):
            dzb = activation_vjp(ep, stages.output_block(plan, z, sh), dzb)
    dz = stages._global_output(plan, dzb, sh, dzb.dtype)
    if need_x:
        with span("vjp/dx"):
            dx = _like(x, _dx_via_transposed_plan(plan, k, dz))
    if need_k:
        with span("vjp/dk"):
            dk = stages.grad_kernel(plan, x, dzb, sh, k.dtype)
    if need_bias:
        with span("vjp/dbias"):
            dbias = stages.grad_bias(plan, dzb, sh).to(bias.dtype)
    return dx, dk, dbias, _like(residual, dz) if need_res else None


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
            y = _activate(ep, z)
        ctx.plan = plan
        ctx.traces = stages.active_traces()
        ctx.save_for_backward(*map(_saveable, (x, k, bias, residual, z)))
        return y

    @staticmethod
    def backward(ctx, dy):
        x, k, bias, residual, z = ctx.saved_tensors
        plan = ctx.plan
        with stages.counted_in(ctx.traces):
            if z is not None and torch.is_grad_enabled():
                # double backward: z with its graph to the operands
                z = _pre_activation_plan(plan)(x, k, bias=bias,
                                               residual=residual)
            return (None,) + _grads(plan, k, x, z, dy, bias, residual,
                                    ctx.needs_input_grad[1:])


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
        y = z if ep.activation == "none" else _activate(ep, z)
        ctx.prepared = prepared
        ctx.traces = stages.active_traces()
        ctx.save_for_backward(*map(_saveable, (
            x, bias, residual, None if ep.activation == "none" else z)))
        return y

    @staticmethod
    def backward(ctx, dy):
        x, bias, residual, z = ctx.saved_tensors
        prepared = ctx.prepared
        plan = prepared.plan
        _, need_x, need_bias, need_res = ctx.needs_input_grad
        if need_x and prepared.kernel is None:
            raise ValueError(
                "dx of a PreparedConv needs its kernel: build it with "
                "plan.prepare(k) (or pass kernel=)")
        with stages.counted_in(ctx.traces):
            if z is not None and torch.is_grad_enabled():
                pre = dataclasses.replace(prepared,
                                          plan=_pre_activation_plan(plan))
                z = pre(x, bias=bias, residual=residual)
            dx, _, dbias, dres = _grads(plan, prepared.kernel, x, z, dy,
                                        bias, residual,
                                        (need_x, False, need_bias,
                                         need_res))
        return None, dx, dbias, dres


def pipeline_conv(plan, x, k, bias=None, residual=None):
    """Differentiable execution of a stage-pipeline plan (epilogue fused)."""
    return _PipelineConv.apply(plan, x, k, bias, residual)


def prepared_conv(prepared, x, bias=None, residual=None):
    """Execute a ``PreparedConv`` with grads w.r.t. ``x`` (and bias /
    residual, when the epilogue carries them) defined by the same
    transposed-plan VJP as ``pipeline_conv``."""
    return _PreparedConv.apply(prepared, x, bias, residual)
