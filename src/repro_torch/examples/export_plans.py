"""Plan artifacts: build once, deploy many (fleet cold-start).  The twin
of the JAX package's ``examples/export_plans.py``: the same two-layer
trunk and numpy draws (seed 0).

    # on the card (the CUDA kernels):
    PYTHONPATH=src python -m repro_torch.examples.export_plans
    # on the host (the kernels' plain PyTorch versions):
    PYTHONPATH=src python -m repro_torch.examples.export_plans --device cpu

One builder worker pays the plan lifecycle (plan every layer, transform
every kernel) and exports the result as a single ``.rpa`` artifact
(``NetworkPlan.export``).  Every other worker of the fleet then loads a
runnable network from the file (``load_network``): no planning and no
kernel transform.  The port ships no compiled executable (its kernels are
built from the checkout's sources at first use), so a loaded layer runs
the port's own pipeline over the stored slabs.  An incompatible worker
(another torch or CUDA version, another device, other kernel sources)
falls back to planning live from the stored configs and kernels, with a
warning, so a mixed fleet still comes up.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch.conv import Epilogue, NetworkConv, load_network, plan_network
from repro_torch.conv.export import read_manifest, verify
from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class ExportPlansResult:
    """What one run printed, and the numbers behind its asserts."""
    lines: tuple
    path: str
    source: str
    max_abs_diff: float
    verified: dict


def run(args) -> ExportPlansResult:
    device = resolve_device(args.device)
    lines = []

    def say(line):
        print(line)
        lines.append(line)

    rng = np.random.default_rng(0)

    def init(shape, s=0.05):
        return torch.from_numpy(
            (s * rng.standard_normal(shape)).astype(np.float32)).to(device)

    layers = [
        NetworkConv("c1", (4, 8, 32, 32), (16, 8, 3, 3), padding=1,
                    epilogue=Epilogue(bias=True, activation="relu")),
        NetworkConv("c2", (4, 16, 32, 32), (16, 16, 3, 3), padding=1),
    ]
    kernels = {"c1": init((16, 8, 3, 3)), "c2": init((16, 16, 3, 3))}
    bias = init((16,))
    x = init((4, 8, 32, 32), 1.0)

    path = os.path.join(tempfile.mkdtemp(), "trunk.rpa")

    # ---- builder worker: plan + prepare + export ------------------------
    t0 = time.perf_counter()
    net = plan_network(layers, backend="fft-cuda")
    prepared = net.prepare(kernels, weights_version=7)
    with torch.inference_mode():
        y_live = prepared["c2"](prepared["c1"](x, bias=bias))
    net.export(path, params=kernels, weights_version=7)
    say(f"built + exported in {time.perf_counter() - t0:.2f}s "
        f"-> {path} ({os.path.getsize(path) / 1e6:.2f} MB)")

    man = read_manifest(path)
    say(f"artifact: torch {man['torch_version']}, device "
        f"{man['device_name']}, weights_version {man['weights_version']}, "
        f"{len(man['nets']['net']['layers'])} layers")

    # ---- fleet worker: load, no planning -------------------------------
    t0 = time.perf_counter()
    loaded = load_network(path, device=device)   # this process stands in
    t_load = time.perf_counter() - t0            # for a fresh worker; see
    say(f"loaded in {t_load:.2f}s "               # the tests for the true
        f"(source={loaded.source}, native="       # fresh-process load
        f"{all(lc.native for lc in loaded.layers.values())})")

    with torch.inference_mode():
        y_aot = loaded["c2"](loaded["c1"](x, bias=bias))
    err = float((y_aot - y_live).abs().max())
    say(f"parity vs live-planned: max |diff| = {err:.2e}")
    assert err < 1e-5

    # ---- certification: stored fingerprints vs a live plan -------------
    v = verify(path)
    say(f"verify: ok={v['ok']} ({v['n_checked']} layer fingerprints "
        "match a live plan)")
    assert v["ok"]
    return ExportPlansResult(lines=tuple(lines), path=path,
                             source=loaded.source, max_abs_diff=err,
                             verified=v)


def main(argv=None) -> ExportPlansResult:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="where to plan and serve (default: the GPU; 'cpu' "
                         "runs the plain PyTorch path on the host)")
    return run(ap.parse_args(argv))


if __name__ == "__main__":
    main()
