"""Time every compiled tile shape of the CGEMM at the served trunk's
shapes, on the card:

    PYTHONPATH=src python -m repro_torch.kernels.cgemm.sweep [--rect]

For each layer of the VGG trunk at 224x224, batch 4 (P = 130, or 144 with
``--rect``), float32 3M, every shape of ``ops.SHAPES`` is launched on the
same operands (any shape is right for any M; the small-M ones read G once
only when BM >= M), held to the plain version at 2e-5 scaled, and timed
with CUDA events.  Prints one JSON line per layer: each shape's ms, and
the shape ``choose_variant`` picks.  The numbers steer the chooser's
table; the wrapper never asks this module.
"""
from __future__ import annotations

import argparse
import json
import statistics

import torch

from repro_torch.configs.paper_convs import network_convs
from repro_torch.conv import plan_network
from repro_torch.core.fftconv import freq_count
from repro_torch.kernels.cgemm import ops
from repro_torch.kernels.cgemm.ref import cgemm_ref


def _ms(fn, reps=10, groups=5):
    fn()
    torch.cuda.synchronize()
    means = []
    for _ in range(groups):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        means.append(start.elapsed_time(end) / reps)
    return statistics.median(means)


def main(argv=None):
    from repro_torch.launch import serve
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rect", action="store_true",
                    help="the rect layout's P = 144, not the compact 130")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("cgemm sweep: no CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(0)
    layers = network_convs(serve._vgg_scale(224), 4)
    for name, plan in plan_network(layers, backend="fft-cuda").items():
        s = plan.spec
        P = freq_count(s, "rect" if args.rect else "real")
        M, C, N = s.M, s.C, s.Cout
        Dr, Di = (torch.randn((P, M, C), generator=gen, device="cuda")
                  for _ in range(2))
        Gr, Gi = (torch.randn((P, C, N), generator=gen, device="cuda")
                  for _ in range(2))
        Zr, Zi = (torch.empty((P, M, N), device="cuda") for _ in range(2))
        Rr, _ = cgemm_ref(Dr, Di, Gr, Gi)
        chosen = ops.operand_variant(Dr, Di, Gr, Gi)
        times = {}
        for shape in range(len(ops.SHAPES)):
            code = shape + len(ops.SHAPES) * chosen.scalar
            ops.launch(Dr, Di, Gr, Gi, Zr, Zi, True, code)
            err = (Zr - Rr).abs().max().item() / Rr.abs().max().item()
            if not err <= 2e-5:
                raise AssertionError(f"{name} shape {shape}: {err:.3e}")
            bm, bn, _, tm, tn, stages = ops.SHAPES[shape]
            key = f"{bm}x{bn}/{(bm // tm) * (bn // tn)}t/s{stages}"
            times[key] = _ms(
                lambda: ops.launch(Dr, Di, Gr, Gi, Zr, Zi, True, code))
        print(json.dumps({"layer": name, "shape": [P, M, C, N],
                          "chosen": chosen.name, "ms": times}), flush=True)


if __name__ == "__main__":
    main()
