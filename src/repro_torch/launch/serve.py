"""Serving launcher, on the GPU unless ``--device cpu`` is given: an LM
architecture (prefill + greedy decode over the KV/SSM cache, random
weights from ``--seed``), or with ``--convnet vgg`` the paper's VGG conv
trunk through whole-net planning and prepared kernels.

    # an LM: qwen3-14b at full width by default; --smoke for the small form
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-14b \
        --batch 4 --prompt-len 32 --gen 16
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-2.7b \
        --smoke --device cpu

    # the conv trunk on the card, the hand-written CUDA kernels on the hot
    # path:
    PYTHONPATH=src python -m repro_torch.launch.serve --convnet vgg \
        --conv-backend fft-cuda --timing per-request

    # on the host, the kernels' plain PyTorch versions at a small size:
    PYTHONPATH=src python -m repro_torch.launch.serve --convnet vgg \
        --conv-backend fft-cuda --smoke --batch 1 --gen 2 --device cpu

    # the measured autotuner picks each layer's backend, spectrum and
    # CGEMM tile on the device before the first request (cached per
    # machine; --serve-trace takes it too):
    PYTHONPATH=src python -m repro_torch.launch.serve --convnet vgg --tune

    # continuous batching: the shape-bucketed dynamic batcher over
    # per-bucket prepared plans, one CUDA graph per bucket, on a synthetic
    # ragged trace (repro_torch.launch.batcher; --serve-compare A/Bs the
    # pad-to-max and re-plan-per-shape baselines and fails unless the
    # bucketed engine wins):
    PYTHONPATH=src python -m repro_torch.launch.serve --serve-trace \
        --conv-backend fft-cuda --max-batch 8 --serve-compare

    # fleet cold-start: one worker exports every bucket's plans and
    # prepared slabs, a fresh one serves from the artifact (no planning,
    # no tuning, no kernel transform) and certifies it:
    PYTHONPATH=src python -m repro_torch.launch.serve --serve-trace \
        --conv-backend fft-cuda --export-plans vgg.rpa
    PYTHONPATH=src python -m repro_torch.launch.serve --serve-trace \
        --conv-backend fft-cuda --load-plans vgg.rpa --coldstart-out cs.json
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.device import resolve_device
from repro_torch.launch.batcher import _percentile, _sync
from repro_torch.models import lm as LM
from repro_torch.models import whisper as WH
from repro_torch.train.step import make_decode_step, make_prefill_step


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


def _print_tuning(net, seconds=None, label=""):
    """The tuned sweep's time, the cache path and one line per layer (as
    ``repro.launch.serve --tune`` prints them)."""
    from repro_torch.conv import autotune
    if seconds is not None:
        print(f"autotune sweep: {seconds:.1f}s "
              f"(cache: {autotune.cache_path()})")
    for name, r in net.tuning_report().items():
        us = "cached/unmeasured" if r["us_per_call"] is None \
            else f"{r['us_per_call']:.0f}us"
        print(f"  {label}{name}: {r['backend']}/{r['schedule']} "
              f"spectrum={r['spectrum']} bm={r['bm']} bn={r['bn']} "
              f"bk={r['bk']} dft_bt={r['dft_bt']} overlap={r['overlap']} "
              f"{us} [{r['source']}]")


def serve_convnet(args) -> ServeResult:
    """Serve the paper's VGG conv trunk through the network planner.

    The whole net is planned once (``plan_network``), every kernel is
    transformed once per weights version (``NetworkPlan.prepare``), and each
    request batch runs through the prepared, epilogue-fused plans.  A
    weight update is one invalidation sweep (new ``weights_version``).
    Weights and the request batch are drawn from ``--seed`` with numpy, in
    the same order as ``repro.launch.serve``, so both packages serve the
    same numbers.  ``--serve-trace`` switches to the continuous-batching
    engine (``serve_trace``).
    """
    from repro_torch.configs.paper_convs import network_convs
    from repro_torch.conv import autotune, plan_network, prepared_cache_info

    if args.serve_trace:
        return serve_trace(args)

    device = resolve_device(args.device)
    image = args.image if args.image else (64 if args.smoke else 224)
    layers = network_convs(_vgg_scale(image), args.batch)
    backend = "tuned" if args.tune else args.conv_backend
    with autotune.measure_on(device):
        t0 = time.perf_counter()
        net = plan_network(layers, backend=backend, overlap=args.overlap)
        if args.tune:
            # the tuned planning sweep IS the cache warm-up: every
            # distinct layer geometry was measured (or served from the
            # persistent cache) before the first request executes
            _print_tuning(net, time.perf_counter() - t0)
    print(net.describe())
    if args.analyze:
        prof = net.analyze().raise_if_failed()
        t = prof.total_collectives
        print(f"plan-lint: OK — {len(prof.layers)} layers certified, "
              f"collectives/pass: all_to_all={t.get('all_to_all', 0)} "
              f"psum={t.get('psum', 0)}, "
              f"peak live ~{prof.peak_live_bytes / 1e6:.1f} MB/rank")

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


@dataclasses.dataclass(frozen=True, eq=False)
class TraceResult:
    """What one ``serve_trace`` run served and measured."""
    reports: dict                # mode -> ServeEngine.report()
    engines: dict                # mode -> ServeEngine (graphs, results)
    kernels: dict                # layer name -> OIHW kernel (version 0)
    biases: dict                 # layer name -> (C',) bias
    inputs: dict                 # batch size -> the request tensor
    trace: tuple                 # the TraceRequests replayed
    make_layers: Any             # batch -> NetworkConv sequence
    forward: Any                 # forward(prepared, x), the engines'


def compare_modes(reports) -> tuple:
    """The ``--serve-compare`` gates over the three modes' reports, as
    ``repro.launch.serve`` states them: bucketed throughput at least 1.05x
    pad-max's, bucketed p99 at most half of replan's, zero plan-cache
    misses after warm-up.  Returns (throughput ratio bucketed / pad-max,
    p99 ratio replan / bucketed, the failed gates)."""
    b, pm, rp = (reports[m] for m in ("bucketed", "pad-max", "replan"))
    fails = []
    if not b["throughput_rows_s"] >= 1.05 * pm["throughput_rows_s"]:
        fails.append(
            f"bucketed throughput {b['throughput_rows_s']:.1f} rows/s "
            f"does not beat pad-max {pm['throughput_rows_s']:.1f} "
            "by >= 1.05x")
    if not b["p99_us"] <= rp["p99_us"] / 2:
        fails.append(
            f"bucketed p99 {b['p99_us']/1e3:.2f}ms not <= half of "
            f"replan p99 {rp['p99_us']/1e3:.2f}ms")
    if b["plan_cache_misses_after_warmup"] != 0:
        fails.append(
            f"bucketed engine planned on the hot path: "
            f"{b['plan_cache_misses_after_warmup']} plan-cache misses "
            "after warmup")
    tput_x = b["throughput_rows_s"] / max(pm["throughput_rows_s"], 1e-9)
    p99_x = rp["p99_us"] / max(b["p99_us"], 1e-9)
    return tput_x, p99_x, fails


def serve_trace(args) -> TraceResult:
    """Continuous batching on a synthetic ragged Poisson trace.

    Buckets ragged request batches into padded power-of-two shapes, plans
    and prepares one network per bucket at startup and captures one CUDA
    graph per bucket (CPU: runs the eager forward), then drains the queue
    through them: zero re-planning and no kernel launched from the host on
    the hot path.  ``--serve-compare`` also replays the SAME trace through
    the two degenerate strategies (pad everything to ``--max-batch``;
    re-plan and recapture per exact shape) and fails unless the bucketed
    engine beats both.  ``--export-plans`` writes the bucketed engine's
    plan artifact after the trace; ``--load-plans`` starts the bucketed
    engine from one and, after the trace, certifies it (``verify``: every
    layer's fingerprint equals a live plan's, and zero plan-cache misses
    after warm-up), raising ``SystemExit`` on a failure.  Weights and
    inputs are drawn from ``--seed`` in
    ``repro.launch.serve``'s order: kernels of the probe layers, biases,
    then one input per batch size in the order the trace first asks for
    it, all before the first engine starts.  Every mode keeps each
    request's result (``engine.results``), so every mode pays the same
    copies out.
    """
    from repro_torch.configs.paper_convs import network_convs
    from repro_torch.conv import autotune
    from repro_torch.launch.batcher import (
        BucketPolicy, ServeEngine, run_trace, synthetic_trace)

    device = resolve_device(args.device)
    backend = "tuned" if args.tune else args.conv_backend
    image = args.image if args.image else (64 if args.smoke else 224)
    scale = _vgg_scale(image)

    def make_layers(batch):
        return network_convs(scale, batch)

    rng = np.random.default_rng(args.seed)

    def init(shape, s=0.05):
        return torch.as_tensor(s * rng.standard_normal(shape),
                               dtype=torch.float32).to(device)

    probe = make_layers(1)
    kernels = {l.name: init(l.k_shape) for l in probe}
    biases = {l.name: init((l.k_shape[0],)) for l in probe}
    forward = _vgg_forward(biases)

    policy = BucketPolicy(max_batch=args.max_batch)
    trace = synthetic_trace(n_requests=args.trace_requests,
                            max_batch=args.max_batch,
                            rate_rps=args.trace_rate or 1.0,
                            seed=args.seed)
    inputs = {}                     # one tensor per batch size, reused

    def make_input(batch, image_size):
        if batch not in inputs:
            inputs[batch] = init(
                (batch,) + probe[0].x_shape[1:], 1.0)
        return inputs[batch]

    # drawn before any engine runs (set-up, the same draws in the same
    # order), so that no mode's timed replay pays for making them
    for tr in trace:
        make_input(tr.batch, tr.image)

    modes = ("bucketed", "pad-max", "replan") if args.serve_compare \
        else ("bucketed",)
    reports, engines = {}, {}
    for mode in modes:
        eng = ServeEngine(
            make_layers, kernels, policy=policy, forward=forward,
            replicas=args.replicas,
            window_s=args.batch_window_ms * 1e-3, mode=mode,
            # the A/B compares real completion latencies, so
            # --serve-compare forces synchronized per-batch timing
            timing="async" if (args.timing == "async"
                               and not args.serve_compare) else "per-batch",
            load_plans=(args.load_plans or None) if mode == "bucketed"
            else None,
            device=device, backend=backend, overlap=args.overlap)
        rep = run_trace(eng, trace, make_input=make_input,
                        realtime=args.trace_rate > 0)
        reports[mode] = rep
        engines[mode] = eng
        pool = rep["graph_pool_bytes"]
        print(f"serve-trace mode={mode} [{eng.plan_source}, "
              f"{rep['executor']} on {device}]: "
              f"startup={rep['startup_s']:.2f}s (load "
              f"{rep['startup_load_s']:.2f}s, plan+prepare "
              f"{rep['startup_plan_prepare_s']:.2f}s, capture "
              f"{rep['startup_capture_s']:.2f}s) "
              f"wall={rep['wall_s']:.3f}s "
              f"tput={rep['throughput_rows_s']:.1f} rows/s "
              f"p50={rep['p50_us']/1e3:.2f}ms p99={rep['p99_us']/1e3:.2f}ms "
              f"occupancy={rep['occupancy']:.2f} "
              f"queue_max={rep['queue_depth_max']} "
              f"plan_misses_after_warmup="
              f"{rep['plan_cache_misses_after_warmup']} "
              f"graph_replays={sum(map(sum, rep['graph_replays'].values()))}"
              f" graph_pool="
              f"{'n/a' if pool is None else f'{pool / 2**20:.1f}MiB'}")
        for label, b in sorted(rep["buckets"].items()):
            print(f"    {label}: n={b['n_requests']} "
                  f"batches={b['n_batches']} "
                  f"p50={b['p50_us']/1e3:.2f}ms "
                  f"p99={b['p99_us']/1e3:.2f}ms occ={b['occupancy']:.2f}")
        if args.replicas > 1:
            print(f"    replica batches: {rep['replica_batches']}")
        if args.tune and mode == "bucketed":
            # the engine tuned every bucket's layers while planning, in
            # its start-up, before any capture
            print(f"autotune sweep: in the start-up's plan+prepare "
                  f"{rep['startup_plan_prepare_s']:.1f}s "
                  f"(cache: {autotune.cache_path()})")
            with autotune.measure_on(device):
                for key, net in eng.nets.items():
                    _print_tuning(net, label=f"b{key[0]} ")
    bucketed = engines["bucketed"]
    if bucketed.nets:
        br = bucketed.bucket_report()
        print(f"buckets: {policy.batch_buckets()} x image={image} — "
              f"{br['n_layer_plans']} layer plans, "
              f"{br['n_distinct_plans']} distinct (shared-cache dedupe)")
    else:
        print(f"buckets: {policy.batch_buckets()} x image={image} — "
              f"loaded from plan artifact {args.load_plans}")

    if args.export_plans:
        p = bucketed.export_plans(args.export_plans)
        print(f"exported plan artifact: {p}")

    fingerprints_ok = None
    if args.load_plans and bucketed.plan_source == "aot":
        fingerprints_ok = certify_loaded(args.load_plans, reports["bucketed"])
    elif args.load_plans:
        print(f"load-plans: artifact fell back to live planning "
              f"(source={bucketed.plan_source})")

    if args.coldstart_out:
        import json
        rep = reports["bucketed"]
        payload = {
            "coldstart_s": bucketed.startup_s,
            "startup_load_s": rep["startup_load_s"],
            "startup_plan_prepare_s": rep["startup_plan_prepare_s"],
            "startup_capture_s": rep["startup_capture_s"],
            "source": bucketed.plan_source,
            "plan_cache_misses_after_warmup":
                rep["plan_cache_misses_after_warmup"],
            "fingerprints_verified": fingerprints_ok,
            "n_buckets": len(policy.batch_buckets()),
            "image": image,
        }
        with open(args.coldstart_out, "w") as fh:
            json.dump(payload, fh, indent=1, sort_keys=True)
        print(f"wrote cold-start report to {args.coldstart_out}")

    if args.bench_out:
        import json
        rows = bucketed.bench_rows()
        with open(args.bench_out, "w") as fh:
            json.dump(rows, fh, indent=1, sort_keys=True)
        print(f"wrote {len(rows)} serve/* bench rows to {args.bench_out}")

    if args.serve_compare:
        tput_x, p99_x, fails = compare_modes(reports)
        print(f"serve-compare: bucketed tput {tput_x:.2f}x pad-max, p99 "
              f"{p99_x:.2f}x better than replan")
        if fails:
            raise SystemExit("serve-compare FAILED:\n  " +
                             "\n  ".join(fails))
        print("serve-compare OK: bucketed beats pad-max on throughput "
              "and replan on p99, zero plan-cache misses after warmup")
    return TraceResult(reports=reports, engines=engines, kernels=kernels,
                       biases=biases, inputs=inputs, trace=trace,
                       make_layers=make_layers, forward=forward)


def certify_loaded(path: str, report: dict) -> bool:
    """The plan-lint certificate of an engine loaded from ``path``: a live
    plan of every stored config must give the export-time fingerprint,
    and the engine planned nothing after warm-up.  Run after the trace,
    so that its planning never touches the report's miss count.  Raises
    ``SystemExit`` on a failure; returns True."""
    from repro_torch.conv import export as planx
    v = planx.verify(path)
    fails = []
    if not v["ok"]:
        fails.append(f"export fingerprints diverge from a live plan: "
                     f"{v['mismatches']}")
    if report["plan_cache_misses_after_warmup"] != 0:
        fails.append(
            f"engine loaded ahead of time planned on the hot path: "
            f"{report['plan_cache_misses_after_warmup']} plan-cache misses "
            "after warmup")
    if fails:
        raise SystemExit("load-plans certification FAILED:\n  "
                         + "\n  ".join(fails))
    print(f"load-plans OK: {v['n_checked']} layer fingerprints match a "
          "live plan, zero plan-cache misses after warmup")
    return True


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_NAMES, default="qwen3-14b")
    ap.add_argument("--convnet", choices=["vgg"], default=None,
                    help="serve the paper's conv trunk via plan_network "
                         "instead of an LM arch")
    # "auto" matches the planner's cost-model default (direct for tiny
    # layers, fft-torch past the crossover); fft-cuda puts the hand-written
    # CUDA kernels on the hot path.
    ap.add_argument("--conv-backend", default="auto",
                    choices=["auto", "direct", "fft-torch", "fft-cuda"])
    ap.add_argument("--serve-trace", action="store_true",
                    help="continuous batching: run the shape-bucketed "
                         "dynamic batcher (repro_torch.launch.batcher, one "
                         "CUDA graph per bucket) on a synthetic ragged "
                         "Poisson trace")
    ap.add_argument("--serve-compare", action="store_true",
                    help="with --serve-trace: replay the same trace "
                         "through the pad-to-max and re-plan-per-shape "
                         "baselines and FAIL unless the bucketed engine "
                         "beats both (throughput / p99) with zero "
                         "plan-cache misses after warmup")
    ap.add_argument("--max-batch", type=int, default=8,
                    help="largest batch bucket (powers of two up to "
                         "this; requests above it are rejected)")
    ap.add_argument("--batch-window-ms", type=float, default=2.0,
                    help="batching window: a queued request is flushed "
                         "after waiting this long even if its bucket "
                         "is not full")
    ap.add_argument("--replicas", type=int, default=1,
                    help="replicas of the prepared network and its graphs "
                         "on the device, round-robin dispatch")
    ap.add_argument("--trace-requests", type=int, default=0,
                    help="synthetic trace length (default 64, smoke 24)")
    ap.add_argument("--trace-rate", type=float, default=0.0,
                    help="Poisson arrival rate in requests/s; 0 replays "
                         "the trace instantaneously (deterministic)")
    ap.add_argument("--timing", choices=["async", "per-request"],
                    default=None,
                    help="async: throughput mode, one final sync (per-"
                         "request latency NOT derivable); per-request: "
                         "synchronize every batch and report p50/p99. "
                         "Defaults: async for the fixed-shape loop, "
                         "per-request for --serve-trace")
    ap.add_argument("--bench-out", default="",
                    help="with --serve-trace: write the serve/* bench "
                         "rows (BENCH_conv.json schema) to this path")
    ap.add_argument("--coldstart-out", default="",
                    help="with --serve-trace: write a cold-start JSON "
                         "report (coldstart_s and its load, plan+prepare "
                         "and capture split, source, plan-cache misses "
                         "after warmup)")
    ap.add_argument("--export-plans", default="",
                    help="with --serve-trace: after the trace, export the "
                         "bucketed engine's plans and prepared slabs "
                         "(every bucket) to this plan artifact "
                         "(repro_torch.conv.export)")
    ap.add_argument("--load-plans", default="",
                    help="with --serve-trace: start the bucketed engine "
                         "from this plan artifact (no planning, tuning or "
                         "kernel transform; falls back to live planning "
                         "with a warning on a mismatch) and certify it "
                         "after the trace")
    ap.add_argument("--overlap", default="off",
                    help="conv sub-slab comm/compute overlap: off | "
                         "slab:<k> | auto (sharded schedules only; the "
                         "served trunk is local, where slab:<k> is a "
                         "ValueError)")
    ap.add_argument("--tune", action="store_true",
                    help="backend='tuned': measure each layer's backend, "
                         "spectrum and CGEMM tile on --device while "
                         "planning (cached per machine; overrides "
                         "--conv-backend)")
    ap.add_argument("--analyze", action="store_true",
                    help="plan-lint the planned convnet (static analyzer, "
                         "repro_torch.conv.analyze, on fake tensors) "
                         "before serving; aborts if any layer violates a "
                         "structural invariant (the fixed-shape loop "
                         "only, as in the reference)")
    ap.add_argument("--image", type=int, default=0,
                    help="input size (default 224, smoke 64)")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16,
                    help="LM: tokens to generate; --convnet: request "
                         "batches to serve")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' runs the "
                         "kernels' plain PyTorch versions)")
    args = ap.parse_args(argv)
    if (args.export_plans or args.load_plans) and not args.serve_trace:
        ap.error("--export-plans and --load-plans go with --serve-trace")
    if (args.tune or args.serve_trace) and not args.convnet:
        args.convnet = "vgg"        # conv-only flags imply the convnet path
    if not args.trace_requests:
        args.trace_requests = 24 if args.smoke else 64
    if args.timing is None:
        args.timing = "per-request" if args.serve_trace else "async"
    if args.convnet:
        return serve_convnet(args)
    return serve_lm(args)


@dataclasses.dataclass
class Generated:
    """What ``generate`` produced: the greedy tokens (B, gen), each step's
    logits (the prefill's, then each decode step's), and the host seconds
    of prefill and of the decode loop (each ending in a device sync)."""
    tokens: torch.Tensor
    steps: list
    prefill_s: float
    decode_s: float


def decode_start(cfg, prompt_len: int) -> int:
    """``serve``'s first decode position after a prompt of ``prompt_len``
    tokens: 1 for whisper (its prefill feeds one token), else past the meta
    tokens and the prompt.  The vision stub's image tokens are counted
    though no image is passed, as in the reference: its decode writes clamp
    to the cache end."""
    if cfg.encdec:
        return 1
    return prompt_len + (cfg.n_meta_tokens or 0) + (
        cfg.n_frontend_tokens if cfg.frontend == "vision_stub" else 0)


def generate(cfg, params, prompts, gen, frames=None, pos0=None) -> Generated:
    """Prefill ``prompts`` (B, Sp), then greedy-decode until ``gen`` tokens
    are out, one step at a time over the cache, as ``repro.launch.serve``
    does.  Whisper prefills the first prompt token over the encoded
    ``frames`` (B, T, d_model).  Decoding starts at ``pos0``, by default
    ``decode_start(cfg, Sp)``."""
    device = prompts.device
    B, Sp = prompts.shape
    if pos0 is None:
        pos0 = decode_start(cfg, Sp)
    decode = make_decode_step(cfg)
    with torch.inference_mode():
        if cfg.encdec:
            cache = WH.init_dec_cache(cfg, B, frames.shape[1], device=device)
            prefill = make_prefill_step(cfg)
            batch = {"frames": frames, "tokens": prompts[:, :1]}
        else:
            max_len = Sp + gen + (cfg.n_meta_tokens or 0) + 8
            cache = LM.init_cache(cfg, B, max_len, device=device)
            prefill = make_prefill_step(cfg, use_flash=False)
            batch = {"tokens": prompts}
        _sync(device)
        t0 = time.perf_counter()
        logits, cache = prefill(params, batch, cache)
        _sync(device)
        prefill_s = time.perf_counter() - t0

        steps, out = [logits], [torch.argmax(logits[:, -1:], dim=-1)]
        t0 = time.perf_counter()
        for i in range(gen - 1):
            logits, cache = decode(params, out[-1], pos0 + i, cache)
            steps.append(logits)
            out.append(torch.argmax(logits[:, -1:], dim=-1))
        _sync(device)
        decode_s = time.perf_counter() - t0
    return Generated(tokens=torch.cat(out, dim=1), steps=steps,
                     prefill_s=prefill_s, decode_s=decode_s)


@dataclasses.dataclass
class LMServed:
    """What ``serve --arch`` served: the generated tokens (B, gen), the
    last step's logits, the host seconds of prefill and of the decode
    loop, and the weights and prompts it used."""
    cfg: Any
    params: Any
    prompts: torch.Tensor
    tokens: torch.Tensor
    logits: torch.Tensor
    prefill_s: float
    decode_s: float
    tokens_per_s: float


def serve_lm(args) -> LMServed:
    """Prefill a batch of random prompts, then greedy-decode ``args.gen``
    tokens (``generate``), as ``repro.launch.serve`` does.  The prompts
    (and whisper's frames) are the reference's for the same seed; the
    weights are the port's own random draw."""
    cfg = get_config(args.arch, smoke=args.smoke)
    device = resolve_device(args.device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    B, Sp = args.batch, args.prompt_len
    rng = np.random.default_rng(args.seed)
    prompts = torch.tensor(rng.integers(1, cfg.vocab, (B, Sp)),
                           device=device)
    frames = None
    if cfg.encdec:
        params = WH.init_whisper_params(cfg, gen)
        frames = torch.tensor(rng.standard_normal((B, 64, cfg.d_model)),
                              dtype=torch.float32, device=device)
    else:
        params = LM.init_lm_params(cfg, gen)
    out = generate(cfg, params, prompts, args.gen, frames)
    tput = B * (args.gen - 1) / max(out.decode_s, 1e-9)
    print(f"arch={cfg.name} prefill={out.prefill_s*1e3:.0f}ms "
          f"decode={out.decode_s*1e3:.0f}ms ({tput_fmt(tput)})")
    print("sample tokens:", out.tokens[0].cpu().numpy()[:16])
    return LMServed(cfg=cfg, params=params, prompts=prompts,
                    tokens=out.tokens, logits=out.steps[-1],
                    prefill_s=out.prefill_s, decode_s=out.decode_s,
                    tokens_per_s=tput)


def tput_fmt(x):
    return f"{x:.1f} tok/s"


if __name__ == "__main__":
    main()
