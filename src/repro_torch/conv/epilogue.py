"""Fused epilogue spec for the stage-graph convolution engine.

An ``Epilogue`` freezes *which* elementwise tail a plan executes (bias add,
activation, residual add); the pipelines fuse it into stage 4
(``stage_output_inverse``) in float32, before the cast to the output dtype.
On the ``fft-cuda`` backend the bias and activation run inside the
inverse-transform kernel itself.

The operand *values* (the bias vector, the residual tensor) are execution
arguments — ``plan(x, k, bias=b, residual=r)`` — only the *shape* of the
epilogue lives in the plan (and therefore in the plan-cache key).

Semantics (cuDNN-style runtime-fusion order):

    y = activation(conv(x, k) + bias[None, :, None, None] + residual)

i.e. the residual is added *before* the activation (the ResNet basic-block
form ``relu(conv + shortcut)``).
"""
from __future__ import annotations

import dataclasses
import functools

import torch
import torch.nn.functional as TF


# Activation registry: name -> elementwise callable.  ``gelu`` is the tanh
# approximation, the one the kernel tails implement.
ACTIVATIONS = {
    "none": lambda y: y,
    "relu": TF.relu,
    "gelu": functools.partial(TF.gelu, approximate="tanh"),
    "silu": TF.silu,
}


@dataclasses.dataclass(frozen=True)
class Epilogue:
    """Frozen spec of the elementwise tail fused into stage 4.

    Hashable and part of the plan-cache key: two plans that differ only in
    their epilogue are distinct cached plans.
    """
    bias: bool = False
    activation: str = "none"        # "none" | "relu" | "gelu" | "silu"
    residual: bool = False

    def __post_init__(self):
        if self.activation not in ACTIVATIONS:
            raise ValueError(
                f"unknown epilogue activation {self.activation!r}; "
                f"available: {tuple(sorted(ACTIVATIONS))}")

    @property
    def is_noop(self) -> bool:
        return (not self.bias and self.activation == "none"
                and not self.residual)

    def describe(self) -> str:
        if self.is_noop:
            return "none"
        parts = []
        if self.bias:
            parts.append("bias")
        if self.residual:
            parts.append("residual")
        if self.activation != "none":
            parts.append(self.activation)
        return "+".join(parts)


def apply_epilogue(y, epilogue: Epilogue | None, *, bias=None, residual=None):
    """Apply an epilogue to an NCHW output ``y`` (channels on axis 1),
    in ``y``'s dtype (float32 at the fusion point, before the output
    cast)."""
    if epilogue is None or epilogue.is_noop:
        return y
    if epilogue.bias:
        y = y + bias.to(y.dtype)[None, :, None, None]
    if epilogue.residual:
        y = y + residual.to(y.dtype)
    return ACTIVATIONS[epilogue.activation](y)


def activation_vjp(epilogue: Epilogue, z, dy):
    """Cotangent of the activation at pre-activation value ``z``.

    Used by the plan-level VJP: the activation gradient is applied to the
    incoming cotangent *before* it enters the transposed plan / the bias
    reduction.  The derivative is autograd's of ``ACTIVATIONS`` itself
    (relu' is 0 at 0, as ``jax.nn.relu`` has it; gelu is the tanh form).
    Under grad mode (a double backward) the result stays differentiable in
    ``dy`` and, where ``z`` carries a graph, in ``z``.
    """
    if epilogue.activation == "none":
        return dy
    create_graph = torch.is_grad_enabled()
    with torch.enable_grad():
        zz = z if create_graph and z.requires_grad \
            else z.detach().requires_grad_()
        y = ACTIVATIONS[epilogue.activation](zz)
        (dz,) = torch.autograd.grad(y, zz, dy.to(z.dtype),
                                    create_graph=create_graph)
    return dz


def bias_grad(dz):
    """d_bias: reduce the conv-output cotangent over batch and space."""
    return dz.sum(dim=(0, 2, 3))
