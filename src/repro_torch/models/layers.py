"""Layers around the planned convolutions: conv through the plan/execute
engine (trainable through the plan-level VJP) and pooling."""
from __future__ import annotations

import torch
import torch.nn.functional as TF


def conv2d_planned(x, k, *, padding=1, backend="auto", schedule="auto",
                   mesh=None, compute_dtype=None, weights_version=None):
    """NCHW convolution through ``repro_torch.conv`` for model layers.

    Training (``weights_version=None``): executes ``plan(x, k)`` — fully
    differentiable in ``x`` and ``k`` via the plan-level VJP, on every
    backend.

    Serving (``weights_version`` given, e.g. the train step the weights
    were loaded from): executes a *prepared* plan — the kernel transform is
    cached under (plan, version) and skipped on every call; passing a new
    version after a weight update invalidates and re-prepares.
    """
    from repro_torch.conv import plan_conv
    plan = plan_conv(tuple(x.shape), tuple(k.shape), padding=padding,
                     backend=backend, schedule=schedule, mesh=mesh,
                     compute_dtype=compute_dtype)
    if weights_version is None:
        return plan(x, k)
    return plan.prepare(k, weights_version=weights_version)(x)


def maxpool2x2(x):
    """2x2/stride-2 max pool over the spatial axes of NCHW ``x``.  A
    ``DTensor`` (a sharded plan's output: B and channels sharded, the
    spatial axes whole) is pooled on each rank's local block, with no
    collective."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return TF.max_pool2d(x, 2, 2)
    B, C, H, W = x.shape
    Ho, Wo = H // 2, W // 2
    t = x.to_local()
    # a rank past the end of an uneven split holds an empty block, which
    # max_pool2d refuses
    y = TF.max_pool2d(t, 2, 2) if t.numel() \
        else t.new_empty(t.shape[:2] + (Ho, Wo))
    return DTensor.from_local(y.contiguous(), x.device_mesh, x.placements,
                              run_check=False,
                              shape=torch.Size((B, C, Ho, Wo)),
                              stride=(C * Ho * Wo, Ho * Wo, Wo, 1))


def conv_block(x, k, bias=None, *, activation="none", residual=None,
               padding=1, backend="auto", schedule="auto", mesh=None,
               compute_dtype=None, weights_version=None):
    """Conv + bias + activation (+ residual) as ONE fused plan.

    The elementwise tail is an ``Epilogue`` frozen into the plan and
    executed inside the pipeline's stage 4 (on ``fft-cuda``, inside the
    inverse kernel's tail) instead of as separate ops on the output.
    Differentiable in ``x``, ``k`` AND ``bias``/``residual`` via the
    plan-level VJP; ``weights_version`` routes through a prepared plan
    exactly like ``conv2d_planned``.
    """
    from repro_torch.conv import Epilogue, plan_conv
    ep = Epilogue(bias=bias is not None, activation=activation,
                  residual=residual is not None)
    plan = plan_conv(tuple(x.shape), tuple(k.shape), padding=padding,
                     backend=backend, schedule=schedule, mesh=mesh,
                     compute_dtype=compute_dtype, epilogue=ep)
    if weights_version is None:
        return plan(x, k, bias=bias, residual=residual)
    return plan.prepare(k, weights_version=weights_version)(
        x, bias=bias, residual=residual)
