"""Quickstart: the paper's FFT-based convolution behind the plan/execute
API.  The twin of the JAX package's ``examples/quickstart.py``: the same
layer, inputs (numpy draws, seed 0) and steps.

    # on the card:
    PYTHONPATH=src python -m repro_torch.examples.quickstart
    # on the host:
    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu

``plan_conv`` picks the algorithm (direct vs FFT) from the geometry's cost
model, freezes the schedule, and the returned plan executes (and
differentiates, through ``torch.autograd``) like a plain function.  Plans
are cached by shape, so planning inside a layer loop is free after the
first call.  The direct oracle runs in full float32 (TF32 off).
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.conv import plan_cache_info, plan_conv
from repro_torch.core import conv2d_direct
from repro_torch.core.fftconv import freq_count
from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class QuickstartResult:
    """What one run printed: its lines, and the numbers in them."""
    lines: tuple
    rel_err: float               # max|y_fft - y_direct| / max|y_direct|
    backend: str                 # auto's choice for the VGG-ish layer
    tiny_backend: str            # auto's choice for a 1x1-kernel layer
    grad_norm: float             # |d loss / d k| through the plan
    prepared_matches: bool       # prepared call within 1e-5 of one-shot


def run(args) -> QuickstartResult:
    device = resolve_device(args.device)
    lines = []

    def say(line):
        print(line)
        lines.append(line)

    rng = np.random.default_rng(0)

    def draw(shape):
        return torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)).to(device)

    # A VGG-ish layer: 64 -> 128 channels, 56x56, 3x3, unit stride, pad 1.
    x = draw((2, 64, 56, 56))
    k = draw((128, 64, 3, 3))

    plan = plan_conv(tuple(x.shape), tuple(k.shape), padding=1)  # "auto"
    with torch.no_grad():
        y_fft = plan(x, k)                                       # execute
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            y_ref = conv2d_direct(x, k, padding=1)               # oracle

    err = float((y_fft - y_ref).abs().max() / y_ref.abs().max())
    say(f"output {tuple(y_fft.shape)}, rel err vs direct conv: {err:.2e}")
    say(plan.describe())

    spec = plan.spec
    say(f"tiling: {spec.X}x{spec.D} tiles of {spec.delta}x{spec.delta}, "
        f"P={freq_count(spec, plan.spectrum)} frequency points "
        f"({plan.spectrum} layout), CGEMM {spec.M}x{spec.C}x{spec.Cout}")

    # The cost model sends small geometries to the direct backend instead.
    tiny = plan_conv((1, 3, 16, 16), (4, 3, 1, 1))
    say(f"auto backend for a 1x1-kernel layer: {tiny.backend} "
        f"(vs {plan.backend} for the VGG layer)")

    # Plans are differentiable on every backend x schedule (plan-level VJP).
    kg = k.clone().requires_grad_()
    loss = torch.mean((plan(x, kg) - y_ref) ** 2)
    (g,) = torch.autograd.grad(loss, kg)
    grad_norm = float(torch.linalg.norm(g))
    say(f"grad norm through the plan: {grad_norm}")
    say(f"plan cache: {plan_cache_info()}")

    # Serving: prepare once (the kernel transform is cached under a weights
    # version), then every call runs stages 1/3/4 only.
    with torch.no_grad():
        y_prep = plan.prepare(k, weights_version=0)(x)
    matches = bool(torch.allclose(y_prep, y_fft, atol=1e-5))
    say(f"prepared exec matches one-shot: {matches}")
    return QuickstartResult(lines=tuple(lines), rel_err=err,
                            backend=plan.backend, tiny_backend=tiny.backend,
                            grad_norm=grad_norm, prepared_matches=matches)


def main(argv=None) -> QuickstartResult:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="where to run (default: the GPU; 'cpu' runs the "
                         "plain PyTorch path on the host)")
    return run(ap.parse_args(argv))


if __name__ == "__main__":
    main()
