"""Continuous batching: the shape-bucketed serve engine end to end.  The
twin of the JAX package's ``examples/serve_batcher.py``: the same trunk,
buckets, trace and numpy draws (seed 0).

    # on the card (one CUDA graph per bucket, the CUDA kernels):
    PYTHONPATH=src python -m repro_torch.examples.serve_batcher
    # on the host (the eager executor, the kernels' plain versions):
    PYTHONPATH=src python -m repro_torch.examples.serve_batcher --device cpu

Ragged requests (every client its own batch size) hit a small fixed set
of padded batch buckets, each planned (``plan_network``) + prepared
(``NetworkPlan.prepare``) ONCE at startup, and on the card captured as one
CUDA graph.  The drain loop FIFO-packs the queue into bucket batches,
pads, executes, unpads per request: zero re-planning on the hot path,
certified by the plan-cache miss counter in the report.
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.conv import Epilogue, NetworkConv
from repro_torch.device import resolve_device
from repro_torch.launch.batcher import (
    BucketPolicy, RequestTooLarge, ServeEngine, run_trace, synthetic_trace,
)


@dataclasses.dataclass(frozen=True)
class ServeBatcherResult:
    """What one run printed: its lines, and the report and engine behind
    them."""
    lines: tuple
    report: dict                  # the trace's ``ServeEngine.report()``
    bucket_report: dict           # ``ServeEngine.bucket_report()``
    rejected: bool                # the oversize request was refused
    updated_shape: tuple          # a request's result after the update
    engine: ServeEngine


# A two-layer conv trunk, shaped per bucket batch size.
def make_layers(batch):
    ep = Epilogue(bias=True, activation="relu")
    return [
        NetworkConv("c1", (batch, 8, 32, 32), (16, 8, 3, 3), padding=1,
                    epilogue=ep),
        NetworkConv("c2", (batch, 16, 32, 32), (16, 16, 3, 3), padding=1,
                    epilogue=ep),
    ]


def run(args) -> ServeBatcherResult:
    device = resolve_device(args.device)
    lines = []

    def say(line):
        print(line)
        lines.append(line)

    rng = np.random.default_rng(0)

    def init(shape, s=0.05):
        return torch.from_numpy(
            (s * rng.standard_normal(shape)).astype(np.float32)).to(device)

    kernels = {"c1": init((16, 8, 3, 3)), "c2": init((16, 16, 3, 3))}
    biases = {"c1": init((16,)), "c2": init((16,))}

    def forward(prepared, x):
        for name in prepared:
            x = prepared[name](x, bias=biases[name])
        return x

    policy = BucketPolicy(max_batch=4)            # buckets (1, 2, 4)
    engine = ServeEngine(make_layers, kernels, policy=policy,
                         forward=forward, window_s=2e-3, device=device,
                         backend="fft-cuda")
    br = engine.bucket_report()
    say(f"buckets: {policy.batch_buckets()} "
        f"(dedupe: {br['n_distinct_plans']} distinct plans for "
        f"{br['n_layer_plans']} layer slots)")

    # Oversize requests are rejected up front, not padded into oblivion.
    rejected = False
    try:
        engine.submit(torch.zeros((9, 8, 32, 32), device=device))
    except RequestTooLarge as e:
        rejected = True
        say(f"rejected: {e}")

    # Replay a ragged Poisson trace (burst mode: deterministic backlog).
    trace = synthetic_trace(n_requests=16, max_batch=4, rate_rps=50.0,
                            seed=0)
    rep = run_trace(engine, trace, realtime=False,
                    make_input=lambda b, img: init((b, 8, 32, 32), 1.0))

    say(f"served {rep['n_requests']} requests in {rep['wall_s']:.3f}s "
        f"({rep['throughput_rows_s']:.0f} rows/s), "
        f"p50={rep['p50_us'] / 1e3:.1f}ms p99={rep['p99_us'] / 1e3:.1f}ms "
        f"[{rep['executor']} on {rep['device']}]")
    for label, b in sorted(rep["buckets"].items()):
        say(f"  {label}: {b['n_requests']} requests in {b['n_batches']} "
            f"batches, occupancy {b['occupancy']:.2f}")
    assert rep["plan_cache_misses_after_warmup"] == 0   # hot path never plans

    # A weight update is ONE invalidation sweep across every bucket.
    engine.update_weights({k: v * 2.0 for k, v in kernels.items()},
                          weights_version=1)
    rid = engine.submit(init((3, 8, 32, 32), 1.0))
    engine.drain(force=True)
    shape = tuple(engine.results[rid].shape)
    say(f"after weight update: result {shape} "
        f"(request rows preserved through pad/unpad)")
    return ServeBatcherResult(lines=tuple(lines), report=rep,
                              bucket_report=br, rejected=rejected,
                              updated_shape=shape, engine=engine)


def main(argv=None) -> ServeBatcherResult:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="where to serve (default: the GPU; 'cpu' runs the "
                         "plain PyTorch path on the host)")
    return run(ap.parse_args(argv))


if __name__ == "__main__":
    main()
