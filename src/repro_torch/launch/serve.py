"""Serving launcher: the paper's VGG conv trunk through whole-net planning
and prepared kernels, on the GPU unless ``--device cpu`` is given.

    # on the card, the hand-written CUDA kernels on the hot path:
    PYTHONPATH=src python -m repro_torch.launch.serve --convnet vgg \
        --conv-backend fft-cuda --timing per-request

    # on the host, the kernels' plain PyTorch versions at a small size:
    PYTHONPATH=src python -m repro_torch.launch.serve --convnet vgg \
        --conv-backend fft-cuda --smoke --batch 1 --gen 2 --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device


# Table-I VGG entries chain into a sequential trunk with a 2x2 max-pool
# after each of these layers (the Table geometries already reflect it).
_VGG_POOL_AFTER = frozenset(
    {"Vconv1.2", "Vconv2.2", "Vconv3.2", "Vconv4.2", "Vconv5"})


def _vgg_scale(image):
    """Table-I VGG geometries scaled to a square ``image`` input."""
    from repro_torch.configs.paper_convs import TABLE1
    if image % 32:
        raise SystemExit("--image must be a multiple of 32 (5 pool halvings)")
    return [dataclasses.replace(l, H=l.H * image // 224,
                                W=l.W * image // 224)
            for l in TABLE1 if l.name.startswith("V")]


def _vgg_forward(biases):
    """Prepared-network forward for the VGG trunk: chained prepared
    layers with fused bias+ReLU epilogues, 2x2 max-pool after each
    block."""
    def forward(prepared, x):
        from repro_torch.models.layers import maxpool2x2
        for name in prepared:
            x = prepared[name](x, bias=biases[name])
            if name in _VGG_POOL_AFTER:
                x = maxpool2x2(x)
        return x
    return forward


def _percentile(values, q: float) -> float:
    """p-th percentile (nearest-rank on the sorted sample)."""
    if not values:
        return float("nan")
    s = sorted(values)
    idx = min(len(s) - 1, max(0, int(round(q / 100.0 * (len(s) - 1)))))
    return s[idx]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass(frozen=True, eq=False)
class ServeResult:
    """What one ``serve_convnet`` run served and measured."""
    y: Any                       # output of the last request batch
    x: Any                       # the request batch
    kernels: dict                # layer name -> OIHW kernel (version 0)
    biases: dict                 # layer name -> (C',) bias
    net: Any                     # the NetworkPlan
    prepare_s: float             # stage-2 sweep, version 0
    serve_s: float               # wall time of the request loop
    latencies_s: Optional[list]  # per-batch latencies (per-request timing)


def serve_convnet(args) -> ServeResult:
    """Serve the paper's VGG conv trunk through the network planner.

    The whole net is planned once (``plan_network``), every kernel is
    transformed once per weights version (``NetworkPlan.prepare``), and each
    request batch runs through the prepared, epilogue-fused plans.  A
    weight update is one invalidation sweep (new ``weights_version``).
    Weights and the request batch are drawn from ``--seed`` with numpy, in
    the same order as ``repro.launch.serve``, so both packages serve the
    same numbers.
    """
    from repro_torch.configs.paper_convs import network_convs
    from repro_torch.conv import plan_network, prepared_cache_info

    device = resolve_device(args.device)
    image = args.image if args.image else (64 if args.smoke else 224)
    layers = network_convs(_vgg_scale(image), args.batch)
    net = plan_network(layers, backend=args.conv_backend)
    print(net.describe())

    rng = np.random.default_rng(args.seed)

    def init(shape, s=0.05):
        return torch.as_tensor(s * rng.standard_normal(shape),
                               dtype=torch.float32).to(device)
    kernels = {n: init(net[n].k_shape) for n in net}
    biases = {n: init((net[n].spec.Cout,)) for n in net}
    forward = _vgg_forward(biases)

    with torch.inference_mode():
        t0 = time.perf_counter()
        prepared = net.prepare(kernels, weights_version=0)
        _sync(device)
        t_prepare = time.perf_counter() - t0
        x = init((args.batch,) + net[net.layer_names[0]].x_shape[1:], 1.0)
        t0 = time.perf_counter()
        if args.timing == "per-request":
            # synchronized per-batch latencies: every iteration waits, so
            # percentiles describe real request completion, not enqueue
            lats = []
            for _ in range(args.gen):
                tb = time.perf_counter()
                y = forward(prepared, x)
                _sync(device)
                lats.append(time.perf_counter() - tb)
        else:
            # throughput mode: asynchronous launches, ONE final sync —
            # t_serve is a wall-clock total; per-request latency is NOT
            # derivable
            for _ in range(args.gen):
                y = forward(prepared, x)
            _sync(device)
            lats = None
        t_serve = time.perf_counter() - t0

        # weight update -> ONE invalidation sweep; transforms re-run once
        # per layer
        kernels2 = {n: k + 0.01 for n, k in kernels.items()}
        prepared2 = net.prepare(kernels2, weights_version=1)
        forward(prepared2, x)
        _sync(device)
    info = prepared_cache_info()
    print(f"convnet=vgg image={image} batch={args.batch} device={device} "
          f"prepare={t_prepare*1e3:.1f}ms "
          f"serve={t_serve*1e3:.1f}ms/{args.gen} batches "
          f"(prepared cache: {info.hits} hits, {info.misses} misses, "
          f"{info.invalidations} invalidations)")
    if lats is not None:
        print(f"per-request latency: p50={_percentile(lats, 50)*1e3:.2f}ms "
              f"p99={_percentile(lats, 99)*1e3:.2f}ms over {len(lats)} "
              "synchronized batches")
    print("output:", tuple(y.shape), float(y.float().mean()))
    return ServeResult(y=y, x=x, kernels=kernels, biases=biases, net=net,
                       prepare_s=t_prepare, serve_s=t_serve,
                       latencies_s=lats)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--convnet", choices=["vgg"], default="vgg",
                    help="the conv trunk to serve (the paper's VGG)")
    # "auto" matches the planner's cost-model default (direct for tiny
    # layers, fft-torch past the crossover); fft-cuda puts the hand-written
    # CUDA kernels on the hot path.
    ap.add_argument("--conv-backend", default="auto",
                    choices=["auto", "direct", "fft-torch", "fft-cuda"])
    ap.add_argument("--timing", choices=["async", "per-request"],
                    default="async",
                    help="async: throughput mode, one final sync (per-"
                         "request latency NOT derivable); per-request: "
                         "synchronize every batch and report p50/p99")
    ap.add_argument("--image", type=int, default=0,
                    help="input size (default 224, smoke 64)")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--gen", type=int, default=16,
                    help="request batches to serve")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' runs the "
                         "kernels' plain PyTorch versions)")
    args = ap.parse_args(argv)
    return serve_convnet(args)


if __name__ == "__main__":
    main()
