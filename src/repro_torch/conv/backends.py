"""Built-in backends/schedules for the plan-execute convolution engine.

Schedules:
  local  single device, no collectives.
  nfft   the paper's NUMA-aware tuple partitioning: transforms run where
         the data lives, one all-to-all per stage boundary, collective-free
         hot CGEMM.
  wfft   the Wang et al. baseline: channel-sharded CGEMM with an
         all-reduce inside the hot stage.

Backends:
  direct     ``F.conv2d`` (cuDNN on the card; the oracle path, and the
             winner for small channel counts / tiny kernels by the cost
             model).  Opaque execute, native autograd; the plan epilogue
             is applied right after the conv, or on the card, in inference,
             a ReLU epilogue (with its bias and residual) inside cuDNN's
             fused conv call.  The only backend that runs a strided plan
             (the FFT pipelines refuse one at planning).
  fft-torch  the paper's 4-stage pipeline composed from
             ``repro_torch.conv.stages`` with the PyTorch matmul CGEMM.
  fft-cuda   the same stage graph on the hand-written CUDA kernels: the
             hot CGEMM (``kernels/cgemm``) on every spectrum, and with
             the ``real`` spectrum, on every schedule, the ``dft_tile``
             kernels for the tile transforms — stage 1 through the
             forward tile DFT's image form (the tiles read from the image,
             the spectra written in the CGEMM's layout: one pass), stage 2
             through its tile form, stage 4 through the inverse with a
             bias/activation epilogue fused into its tail (the inverse never
             round-trips to device memory before the elementwise pass), or
             through the plain inverse followed by the epilogue when there
             is no bias or activation to fuse or a residual; on
             ``nfft``/``wfft`` each on the rank's C'/N stage-4 slab (the
             reference's sharded bodies fuse the epilogue at the stage
             level instead: the same function).  Every inverse it launches
             runs at the plan's ``dft_bt`` tiles a block (``None``: the
             kernel's default).  On CPU tensors every kernel runs its plain
             PyTorch version.

``_cuda_fused_inverse`` is the fused stage-4 tail of the ``rect`` layout,
which no plan uses: direct callers of the raw stage ops pass it to
``stages.stage_output_inverse`` as ``inverse_fn``, as the JAX package's
``_pallas_fused_inverse`` is passed.

The two FFT backends differ *only* in the stage ops they inject into the
pipeline; transforms and prepare/execute are shared composition.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.conv import stages
from repro_torch.conv.epilogue import apply_epilogue
from repro_torch.conv.registry import register_backend, register_schedule
from repro_torch.core import fftconv as F
from repro_torch.core.trace import span


def _cuda_cgemm_fn(plan):
    """The plan's CGEMM: its pinned tile row, or the chooser's pick."""
    from repro_torch.kernels.cgemm import cgemm_cuda, shape_for_blocks
    return functools.partial(cgemm_cuda, three_m=plan.three_m,
                             shape=shape_for_blocks(plan.bm, plan.bn,
                                                    plan.bk))


def _tile_bias(bias, spec, like):
    """One bias scalar per output tile, in (B, C', X, Dl) order: the
    channel's bias broadcast over the tile indices (zeros without one)."""
    B, Co, X, Dl = spec.B, spec.Cout, spec.X, spec.D
    with span("copy/planes"):
        b = bias if bias is not None else torch.zeros(
            (Co,), dtype=like.dtype, device=like.device)
        return b.to(like.dtype)[None, :, None, None].expand(
            B, Co, X, Dl).reshape(-1).contiguous()


def _cuda_fused_inverse(Zr, Zi, spec, epilogue, bias, *, tiles=None):
    """The ``spectrum="rect"`` fused stage-4 tail: inverse DFT + bias +
    activation in one ``dft_tile`` kernel pass (the twin of the JAX
    package's ``_pallas_fused_inverse``), on the CGEMM's (P, M, C')
    output made contiguous (n, delta, dh) planes, at ``tiles`` tiles a
    block."""
    from repro_torch.kernels.dft_tile import tile_ifft_epilogue_cuda
    d = spec.delta
    y = tile_ifft_epilogue_cuda(F.z_to_rect_planes(Zr, spec),
                                F.z_to_rect_planes(Zi, spec),
                                _tile_bias(bias, spec, Zr),
                                activation=epilogue.activation, delta=d,
                                tiles=tiles)
    return F.assemble_output_tiles(
        y.reshape(spec.B, spec.Cout, spec.X, spec.D, d, d), spec)


def _cuda_fused_inverse_real(Zr, Zi, spec, epilogue, bias, *, tiles=None):
    """The ``spectrum="real"`` fused stage-4 tail: compact-layout scatter +
    inverse DFT + bias + activation in one ``dft_tile`` kernel pass.

    The activation runs on whole tiles before the overlap-save crop; the
    crop only *selects* elements, so elementwise-before-crop equals
    crop-then-elementwise on everything kept.  The kernel reads one tile's
    spectrum per row, so the CGEMM's (P, M, C') output is transposed to
    (tiles, P) first.  ``tiles``: the kernel's tiles a block.
    """
    from repro_torch.kernels.dft_tile import tile_irfft_epilogue_cuda
    from repro_torch.core.dft import num_freq_real
    P = num_freq_real(spec.delta)
    d = spec.delta
    y = tile_irfft_epilogue_cuda(F.z_to_tile_planes(Zr, spec, P),
                                 F.z_to_tile_planes(Zi, spec, P),
                                 _tile_bias(bias, spec, Zr),
                                 activation=epilogue.activation, delta=d,
                                 tiles=tiles)
    return F.assemble_output_tiles(
        y.reshape(spec.B, spec.Cout, spec.X, spec.D, d, d), spec)


def _cudnn_fused(plan, x, k, bias, residual):
    """The conv and a ReLU epilogue (bias and residual optional) in one
    cuDNN call, where one serves: CUDA operands that autograd need not
    see, no operand cast.  cuDNN fuses the tail into the conv kernel's
    store (its fallback, where no fused engine fits, runs the tail in
    place).  ``None`` where it does not serve."""
    if plan.epilogue.activation != "relu" or not x.is_cuda \
            or plan.compute_dtype is not None or (
                torch.is_grad_enabled() and any(
                    t is not None and t.requires_grad
                    for t in (x, k, bias, residual))):
        return None
    stride, pad = list(plan.stride), list(plan.padding)
    if residual is None:
        return torch.cudnn_convolution_relu(x, k, bias, stride, pad, [1, 1],
                                            1)
    return torch.cudnn_convolution_add_relu(x, k, residual, 1.0, bias,
                                            stride, pad, [1, 1], 1)


def _exec_direct(plan, x, k, bias=None, residual=None):
    with span("conv/direct"):
        y = _cudnn_fused(plan, x, k, bias, residual)
        if y is not None:
            return y
        y = F.conv2d_direct(x, k, padding=plan.padding, stride=plan.stride,
                            compute_dtype=plan.compute_dtype)
    if plan.epilogue.is_noop:
        return y
    with span("epilogue/direct"):
        return apply_epilogue(y, plan.epilogue, bias=bias,
                              residual=residual).to(y.dtype)


def _fft_torch_pipeline(plan):
    return stages.pipeline_for(plan.schedule, cgemm_fn=None)


def _fft_cuda_pipeline(plan):
    hooks = {}
    if plan.spectrum == "real":
        # the dft_tile kernels read and write the compact layout; the
        # full-spectrum twin takes the composed stage ops.  Both inverses
        # run at the plan's dft_bt tiles a block; stage 1's image form
        # runs only the specialised tile.
        from repro_torch.kernels.dft_tile import (
            image_rfft_cuda, tile_irfft_cuda, tile_rfft_cuda)
        from repro_torch.kernels.dft_tile.ops import SPECIALISED_DELTA
        hooks = dict(
            inverse_fn=functools.partial(_cuda_fused_inverse_real,
                                         tiles=plan.dft_bt),
            tile_rfft=tile_rfft_cuda,
            tile_irfft=functools.partial(tile_irfft_cuda,
                                         tiles=plan.dft_bt),
            image_rfft=(image_rfft_cuda
                        if plan.spec.delta == SPECIALISED_DELTA else None))
    return stages.pipeline_for(plan.schedule,
                               cgemm_fn=_cuda_cgemm_fn(plan), **hooks)


def register_builtin() -> None:
    register_schedule("local", requires_mesh=False,
                      description="single device, no collectives")
    register_schedule("nfft", requires_mesh=True,
                      description="paper: tuple partitioning, a2a at stage "
                                  "boundaries, collective-free CGEMM")
    register_schedule("wfft", requires_mesh=True,
                      description="baseline: all-reduce inside the hot CGEMM")

    register_backend("direct", _exec_direct, schedules=("local",),
                     native_autodiff=True, supports_epilogue=True,
                     description="torch.nn.functional.conv2d (cuDNN)")
    register_backend("fft-torch", pipeline_factory=_fft_torch_pipeline,
                     schedules=("local", "nfft", "wfft"),
                     description="FFT conv stage graph, PyTorch matmul "
                                 "CGEMM")
    register_backend("fft-cuda", pipeline_factory=_fft_cuda_pipeline,
                     schedules=("local", "nfft", "wfft"),
                     description="FFT conv stage graph, CUDA CGEMM and "
                                 "tile DFT kernels")
