"""Composable stage graph for the FFT-convolution engine.

The paper's pipeline is four stage *ops* —

  1. input transform    I (B,C,H,W)    -> D (P, M, C)
  2. kernel transform   K (C',C,kh,kw) -> G (P, C, C')
  3. CGEMM              Z[p] = D[p] @ G[p]            (hot stage)
  4. output inverse     Z (P, M, C')   -> O (B,C',Ho,Wo)

— and a *schedule* is a composition of those ops with data movement in
between.  This module defines the stage ops once (thin, counted wrappers
over ``repro_torch.core.fftconv``) plus the ``local`` pipeline, which runs
them back-to-back on one device.  The sharded ``nfft``/``wfft`` pipelines
are not ported yet.

The pipeline accepts a plan-frozen ``Epilogue`` (bias add, activation,
residual add — see ``repro_torch.conv.epilogue``) executed *inside* stage 4,
in float32, before the cast to the output dtype.  Backends may hand the
pipeline tile kernels for the compact ``real`` layout (the CUDA
``dft_tile`` kernels): ``tile_rfft`` for the tile transforms of stages 1
and 2, ``tile_irfft`` for an unfused stage 4, and a fused ``inverse_fn``
that runs the bias and activation inside the inverse transform.  The stage
ops also take the ``rect`` layout's kernels, ``tile_fft`` and
``tile_ifft``, for direct callers of that layout (no plan uses it).

Every pipeline exposes the prepare/execute split:

  ``prepare(plan, k)``    run stage 2 once, returning the transformed kernel
                          ``G`` in the layout execution consumes;
  ``execute(plan, x, G)`` run stages 1/3/4 against a prepared ``G``;
  ``full(plan, x, k)``    the one-shot path: stage 2 inline.

Stage-op invocations are counted when they run, through the thread-local
context manager::

    with stage_trace() as counts:
        plan(x, k)
    assert counts["cgemm"] == 1

Each ``cgemm`` call also records dtype and shape facts as
``("cgemm_dtype", <dtype>)`` and ``("cgemm_shape", (M, N, K))`` tuple keys
beside the plain string op counts.
"""
from __future__ import annotations

import collections
import contextlib
import functools
import threading

import torch

from repro_torch.core.conv_spec import ConvSpec
from repro_torch.core import fftconv as F
from repro_torch.core.cgemm import cgemm
from repro_torch.conv.epilogue import Epilogue, apply_epilogue


# --------------------------------------------------------------------------
# Stage-op counters (thread-safe, context-managed)
# --------------------------------------------------------------------------

_tls = threading.local()                 # per-thread stack of active traces


def _count(name) -> None:
    for counter in getattr(_tls, "stack", ()):
        counter[name] += 1


@contextlib.contextmanager
def stage_trace():
    """Scoped, thread-local stage-op counter.

    Counts only the stage ops run by *this* thread while the context is
    active, so concurrent callers don't bleed into each other.  Nested
    traces each observe the ops run inside them.
    """
    counts: collections.Counter = collections.Counter()
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    stack.append(counts)
    try:
        yield counts
    finally:
        # remove by IDENTITY: two traces may hold equal contents
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] is counts:
                del stack[i]
                break


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")        # "float32", "bfloat16"


# --------------------------------------------------------------------------
# Stage ops (counted)
# --------------------------------------------------------------------------

def stage_input_transform(x, spec: ConvSpec, spectrum: str = "rect",
                          tile_rfft=None, tile_fft=None):
    _count("input_transform")
    return F.input_transform(x, spec, spectrum=spectrum, tile_rfft=tile_rfft,
                             tile_fft=tile_fft)


def stage_kernel_transform(k, spec: ConvSpec, spectrum: str = "rect",
                           tile_rfft=None, tile_fft=None):
    _count("kernel_transform")
    return F.kernel_transform(k, spec, spectrum=spectrum,
                              tile_rfft=tile_rfft, tile_fft=tile_fft)


def stage_cgemm(Dr, Di, Gr, Gi, *, three_m: bool, cgemm_fn=None):
    _count("cgemm")
    # which dtype the hot stage actually consumed
    _count(("cgemm_dtype",
            _dtype_name(torch.promote_types(Dr.dtype, Gr.dtype))))
    # (M, N, K) of this invocation
    _count(("cgemm_shape",
            (int(Dr.shape[-2]), int(Gr.shape[-1]), int(Dr.shape[-1]))))
    mm = cgemm_fn if cgemm_fn is not None else functools.partial(
        cgemm, three_m=three_m)
    return mm(Dr, Di, Gr, Gi)


def stage_output_inverse(Zr, Zi, spec: ConvSpec, *, epilogue: Epilogue = None,
                         bias=None, residual=None, inverse_fn=None,
                         tile_irfft=None, tile_ifft=None,
                         spectrum: str = "rect"):
    """Stage 4 with the fused elementwise epilogue.

    The epilogue rides inside this single stage op (the counter increments
    once, fused or not).  ``inverse_fn`` is a backend-supplied fused
    inverse+epilogue kernel ``(Zr, Zi, spec, epilogue, bias) -> y`` matched
    to the plan's spectrum layout; it cannot fold a residual — the residual
    lives in output layout, not tile layout — so residual and no-op
    epilogues take the composed path: the inverse (through the
    ``tile_irfft`` or ``tile_ifft`` kernel when the caller gives one), then
    the epilogue.
    """
    _count("output_inverse")
    if (inverse_fn is not None and epilogue is not None
            and not epilogue.is_noop and not epilogue.residual):
        return inverse_fn(Zr, Zi, spec, epilogue, bias)
    y = F.output_inverse(Zr, Zi, spec, spectrum=spectrum,
                         tile_irfft=tile_irfft, tile_ifft=tile_ifft)
    return apply_epilogue(y, epilogue, bias=bias, residual=residual)


def _maybe_cast(pair, dtype):
    if dtype is None:
        return pair
    return pair[0].to(dtype), pair[1].to(dtype)


# --------------------------------------------------------------------------
# local schedule
# --------------------------------------------------------------------------

class LocalPipeline:
    """Single device: stages back-to-back, no collectives.  The epilogue is
    fused into stage 4; ``inverse_fn`` (CUDA backend) fuses it into the
    tile-inverse kernel tail itself.  ``tile_rfft`` / ``tile_irfft``
    (CUDA backend) run the tile transforms of stages 1, 2 and the unfused
    stage 4."""

    def __init__(self, cgemm_fn=None, inverse_fn=None, tile_rfft=None,
                 tile_irfft=None):
        self.cgemm_fn = cgemm_fn
        self.inverse_fn = inverse_fn
        self.tile_rfft = tile_rfft
        self.tile_irfft = tile_irfft

    def prepare(self, plan, k):
        return stage_kernel_transform(k, plan.spec, plan.spectrum,
                                      self.tile_rfft)

    def execute(self, plan, x, G, bias=None, residual=None):
        spec = plan.spec
        Dr, Di = stage_input_transform(x, spec, plan.spectrum,
                                       self.tile_rfft)
        Gr, Gi = G
        Dr, Di = _maybe_cast((Dr, Di), plan.compute_dtype)
        Gr, Gi = _maybe_cast((Gr, Gi), plan.compute_dtype)
        Zr, Zi = stage_cgemm(Dr, Di, Gr, Gi, three_m=plan.three_m,
                             cgemm_fn=self.cgemm_fn)
        Zr, Zi = Zr.float(), Zi.float()
        y = stage_output_inverse(Zr, Zi, spec, epilogue=plan.epilogue,
                                 bias=bias, residual=residual,
                                 inverse_fn=self.inverse_fn,
                                 tile_irfft=self.tile_irfft,
                                 spectrum=plan.spectrum)
        return y.to(x.dtype)

    def full(self, plan, x, k, bias=None, residual=None):
        return self.execute(plan, x, self.prepare(plan, k), bias=bias,
                            residual=residual)


PIPELINES = {"local": LocalPipeline}


def pipeline_for(schedule: str, cgemm_fn=None, inverse_fn=None,
                 tile_rfft=None, tile_irfft=None):
    return PIPELINES[schedule](cgemm_fn, inverse_fn, tile_rfft, tile_irfft)
