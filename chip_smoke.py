#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and exits non-zero:

  1. device   a CUDA card must be present; its name and power limit
  2. build    ``nvcc`` builds every kernel from this checkout's sources, one
              compiler per source, all started together
  3. kernels  each hand-written kernel against its plain PyTorch version on
              the card, at the shapes the VGG trunk gives it at 224x224,
              batch 4, with its time, the plain version's, the library
              call's and the least time the card could take (``bound_ms``)
  4. slice    ``repro_torch.launch.serve`` serves the VGG trunk on backend
              ``fft-cuda`` (plan_network -> prepare -> request batches ->
              weight-update sweep); launch counters show every forward ran
              both kernels once per layer; the output is held against the
              same trunk on backend ``direct`` (cuDNN, TF32 off)
  5. profile  kernel time by name for one served forward (torch.profiler)

and then the ``kernels`` summary line, the card's name and power limit as
``nvidia-smi`` gives them, and the final ``{"ok": true, ...}`` line.

Float32 references run in full float32: TF32 is off for matmuls and cuDNN.
"""
import json
import os
import statistics
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.configs.paper_convs import network_convs  # noqa: E402
from repro_torch.conv import plan_network  # noqa: E402
from repro_torch.core.fftconv import freq_count  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.cgemm import cgemm_cuda, cgemm_ref  # noqa: E402
from repro_torch.kernels.dft_tile import (  # noqa: E402
    tile_irfft_epilogue_cuda, tile_irfft_epilogue_ref)
from repro_torch.launch import serve  # noqa: E402

IMAGE, BATCH, GEN, SEED = 224, 4, 10, 0

# NVIDIA H100 SXM data sheet, dense rates
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12,     # float32 outside the tensor cores
              torch.bfloat16: 989e12}   # bf16 tensor cores
CGEMM_TOL = {torch.float32: 2e-5, torch.bfloat16: 5e-2}  # scaled atol
INVERSE_TOL = 1e-4                                        # scaled atol
SLICE_TOL = 1e-3                        # max|y - y_direct| / max|y_direct|


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, reps=10, groups=5):
    """Median over ``groups`` of the mean time of ``reps`` back-to-back
    calls, on CUDA events, after a warm-up."""
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


def bound(nbytes, flops, dtype):
    """Least time for the work: the larger of bytes over the memory rate
    and operations over the peak for the operand type."""
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=nbytes, flops=flops,
                peak_tflops=PEAK_FLOPS[dtype] / 1e12,
                hbm_tb_s=HBM_BYTES_S / 1e12)


def main_path_layers():
    """(name, ConvSpec) of every layer of the served trunk."""
    layers = network_convs(serve._vgg_scale(IMAGE), BATCH)
    net = plan_network(layers, backend="fft-cuda")
    return [(name, plan.spec) for name, plan in net.items()]


def check_cgemm(layers, gen):
    rows = []
    for dtype, three_m in ((torch.float32, True), (torch.float32, False),
                           (torch.bfloat16, True)):
        for name, spec in layers:
            P, M, C, N = freq_count(spec, "real"), spec.M, spec.C, spec.Cout
            Dr, Di = (torch.randn((P, M, C), generator=gen, device="cuda")
                      .to(dtype) for _ in range(2))
            Gr, Gi = (torch.randn((P, C, N), generator=gen, device="cuda")
                      .to(dtype) for _ in range(2))
            Zr, Zi = cgemm_cuda(Dr, Di, Gr, Gi, three_m=three_m)
            Rr, Ri = cgemm_ref(Dr, Di, Gr, Gi, three_m=three_m)
            torch.cuda.synchronize()
            err = max((Zr.float() - Rr.float()).abs().max().item(),
                      (Zi.float() - Ri.float()).abs().max().item())
            scale = Rr.float().abs().max().item() + 1e-9
            if not err / scale <= CGEMM_TOL[dtype]:
                raise AssertionError(
                    f"cgemm {name} {dtype} three_m={three_m}: scaled error "
                    f"{err / scale:.3e} > {CGEMM_TOL[dtype]}")
            ms = time_ms(lambda: cgemm_cuda(Dr, Di, Gr, Gi,
                                            three_m=three_m))
            plain_ms = time_ms(lambda: cgemm_ref(Dr, Di, Gr, Gi,
                                                 three_m=three_m))
            library_ms = None
            if dtype == torch.float32:
                Dc, Gc = torch.complex(Dr, Di), torch.complex(Gr, Gi)
                library_ms = time_ms(lambda: torch.matmul(Dc, Gc))
            size = torch.tensor([], dtype=dtype).element_size()
            nbytes = 2 * size * (P * M * C + P * C * N + P * M * N)
            flops = (6 if three_m else 8) * P * M * C * N
            row = dict(kernel="cgemm", layer=name, shape=[P, M, C, N],
                       dtype=str(dtype).removeprefix("torch."),
                       three_m=three_m, max_abs_err=err,
                       scaled_err=err / scale, ms=ms, plain_ms=plain_ms,
                       library_ms=library_ms, **bound(nbytes, flops, dtype))
            emit("kernel", **row)
            rows.append(row)
    return rows


def check_inverse(layers, gen):
    rows = []
    d = 16
    cases = [(name, spec, "relu", freq_count(spec, "real"))
             for name, spec in layers]
    name12, spec12 = layers[1]
    cases += [(name12, spec12, act, 130) for act in ("none", "gelu", "silu")]
    cases.append((name12, spec12, "relu", 136))        # P padded past 130
    for name, spec, act, P in cases:
        n = spec.B * spec.Cout * spec.X * spec.D
        Zr, Zi = (torch.randn((n, P), generator=gen, device="cuda")
                  for _ in range(2))
        if P > 130:                  # trailing points must never be read
            Zr[:, 130:] = float("nan")
            Zi[:, 130:] = float("nan")
        b = torch.randn((n,), generator=gen, device="cuda")
        y = tile_irfft_epilogue_cuda(Zr, Zi, b, activation=act, delta=d)
        y0 = tile_irfft_epilogue_ref(Zr[:, :130], Zi[:, :130], b,
                                     activation=act, delta=d)
        torch.cuda.synchronize()
        err = (y - y0).abs().max().item()
        scale = y0.abs().max().item() + 1e-9
        if not err / scale <= INVERSE_TOL:
            raise AssertionError(
                f"tile_irfft_epilogue {name} {act} P={P}: scaled error "
                f"{err / scale:.3e} > {INVERSE_TOL}")
        ms = time_ms(lambda: tile_irfft_epilogue_cuda(
            Zr, Zi, b, activation=act, delta=d))
        plain_ms = time_ms(lambda: tile_irfft_epilogue_ref(
            Zr, Zi, b, activation=act, delta=d))
        dh = d // 2 + 1
        nbytes = 4 * (2 * n * P + n + n * d * d)
        flops = n * (8 * d * dh * d + 4 * d * d * dh)
        row = dict(kernel="tile_irfft_epilogue", layer=name,
                   shape=[n, P, d], activation=act, max_abs_err=err,
                   scaled_err=err / scale, ms=ms, plain_ms=plain_ms,
                   library_ms=None, **bound(nbytes, flops, torch.float32))
        emit("kernel", **row)
        rows.append(row)
    return rows


def summarize(name, rows, source, replaces, launches, has_library):
    """One forward's worth: the nine main-path calls summed."""
    by_kind = {"bytes": 0.0, "operations": 0.0}
    for r in rows:
        by_kind[r["bound_by"]] += r["bound_ms"]
    return {
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": sum(r["ms"] for r in rows),
        "plain_ms": sum(r["plain_ms"] for r in rows),
        "bound_ms": sum(r["bound_ms"] for r in rows),
        "bound_by": max(by_kind, key=by_kind.get),
        "library_ms": (sum(r["library_ms"] for r in rows)
                       if has_library else None),
    }


def profile_forward(res):
    """Device time by kernel name over one served forward, and the share
    of the forward's wall time the device spends idle."""
    from torch.profiler import ProfilerActivity, profile
    prepared = res.net.prepare(res.kernels, weights_version=0)  # cache hit
    forward = serve._vgg_forward(res.biases)
    with torch.inference_mode():
        forward(prepared, res.x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            forward(prepared, res.x)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    rows = []
    for ev in prof.key_averages():
        if "CUDA" not in str(getattr(ev, "device_type", "")):
            continue                    # host ops: their kernels are listed
        t = getattr(ev, "self_device_time_total",
                    getattr(ev, "self_cuda_time_total", 0)) or 0
        if t > 0:
            rows.append((t, ev.key, ev.count))
    rows.sort(reverse=True)
    busy = sum(t for t, _, _ in rows)
    p50_us = serve._percentile(res.latencies_s, 50) * 1e6
    emit("profile", device_busy_us=busy,
         kernel_launches=sum(c for _, _, c in rows),
         profiled_wall_us=wall_us,
         idle_share_profiled=1 - busy / wall_us,
         idle_share_vs_p50=1 - busy / p50_us,
         kernels=[{"name": k[:90], "device_us": t, "calls": c}
                  for t, k, c in rows[:16]])


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = nvidia_smi()
    emit("device", nvidia_smi=card, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)

    t0 = time.perf_counter()
    _build.build()
    emit("build", seconds=time.perf_counter() - t0,
         ptxas={k: [l.strip() for l in _build.build_log(k).splitlines()
                    if "registers" in l or "spill" in l]
                for k in _build.KERNELS})

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    layers = main_path_layers()
    cg_rows = check_cgemm(layers, gen)
    inv_rows = check_inverse(layers, gen)

    # the slice: counters at 0 right before the served run, read right after
    cgemm_cuda.launches = 0
    tile_irfft_epilogue_cuda.launches = 0
    res = serve.main(["--convnet", "vgg", "--conv-backend", "fft-cuda",
                      "--image", str(IMAGE), "--batch", str(BATCH),
                      "--gen", str(GEN), "--timing", "per-request",
                      "--seed", str(SEED)])
    n_cgemm = cgemm_cuda.launches
    n_inverse = tile_irfft_epilogue_cuda.launches
    n_forward = GEN + 1                # request loop + post-update forward
    n_layers = len(layers)
    if n_cgemm != n_layers * n_forward or n_inverse != n_layers * n_forward:
        raise AssertionError(
            f"expected {n_layers} launches of each kernel per forward over "
            f"{n_forward} forwards, got cgemm={n_cgemm} "
            f"inverse={n_inverse}")
    y = res.y
    want = (BATCH, 512, IMAGE // 32, IMAGE // 32)
    if tuple(y.shape) != want or not bool(torch.isfinite(y).all()):
        raise AssertionError(f"served output {tuple(y.shape)} (want "
                             f"{want}) or not finite")
    direct = plan_network(network_convs(serve._vgg_scale(IMAGE), BATCH),
                          backend="direct")
    with torch.inference_mode():
        y_ref = serve._vgg_forward(res.biases)(direct.prepare(res.kernels),
                                               res.x)
    torch.cuda.synchronize()
    rel = ((y - y_ref).abs().max() / y_ref.abs().max()).item()
    if not rel <= SLICE_TOL:
        raise AssertionError(f"fft-cuda trunk vs cuDNN: {rel:.3e} > "
                             f"{SLICE_TOL}")
    emit("slice", backend="fft-cuda", image=IMAGE, batch=BATCH,
         forwards=n_forward, cgemm_launches=n_cgemm,
         inverse_launches=n_inverse,
         launches_per_forward=[n_cgemm // n_forward,
                               n_inverse // n_forward],
         rel_err_vs_cudnn=rel, tol=SLICE_TOL, prepare_ms=res.prepare_s * 1e3,
         p50_ms=serve._percentile(res.latencies_s, 50) * 1e3,
         p99_ms=serve._percentile(res.latencies_s, 99) * 1e3,
         latencies_ms=[t * 1e3 for t in res.latencies_s])

    profile_forward(res)

    main_cg = [r for r in cg_rows
               if r["dtype"] == "float32" and r["three_m"]]
    main_inv = inv_rows[:n_layers]
    print(json.dumps({"kernels": [
        summarize("cgemm", main_cg,
                  "src/repro_torch/kernels/cgemm/csrc/cgemm.cu",
                  "src/repro/kernels/cgemm/kernel.py:25", n_cgemm, True),
        summarize("tile_irfft_epilogue", main_inv,
                  "src/repro_torch/kernels/dft_tile/csrc/dft_tile.cu",
                  "src/repro/kernels/dft_tile/kernel.py:88", n_inverse,
                  False),
    ]}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
