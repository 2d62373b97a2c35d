"""Train a small CNN whose conv layers run through the paper's FFT-based
convolution with the bias+ReLU epilogue FUSED into the pipeline (stage 4),
via the plan/execute API and the plan-level VJP — then evaluate through a
*network plan*: every layer resolved in one pass, every kernel transform
prepared once per weights version.  The twin of the JAX package's
``examples/train_cnn_fftconv.py``: same net, init shapes, loss, AdamW
config, data stream and asserts.

    # on the card, the hand-written CUDA kernels on every FFT stage:
    PYTHONPATH=src python -m repro_torch.examples.train_cnn_fftconv \\
        --conv-backend fft-cuda
    # on the host, the kernels' plain PyTorch versions:
    PYTHONPATH=src python -m repro_torch.examples.train_cnn_fftconv \\
        --device cpu --steps 3 --batch 4

Weights come from ``--seed`` through numpy (JAX's ``PRNGKey`` stream has
no PyTorch twin); the data is ``repro_torch.data.image_batch``, bit-equal
to the JAX package's.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any

import numpy as np
import torch
import torch.nn.functional as TF

from repro_torch.conv import (
    Epilogue, NetworkConv, plan_network, prepared_cache_info,
)
from repro_torch.data import DataConfig, image_batch
from repro_torch.device import resolve_device
from repro_torch.models.layers import conv_block, maxpool2x2
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update


def init_params(seed=0, device=None):
    rng = np.random.default_rng(seed)

    def init(shape):
        return torch.from_numpy(
            (0.1 * rng.standard_normal(shape)).astype(np.float32)).to(device)

    def zeros(n):
        return torch.zeros((n,), dtype=torch.float32, device=device)
    return {
        "c1": init((16, 3, 3, 3)), "b1": zeros(16),
        "c2": init((32, 16, 3, 3)), "b2": zeros(32),
        "w": init((32 * 8 * 8, 10)), "b": zeros(10),
    }


def forward(p, x, backend="fft-torch"):
    # conv + bias + relu is ONE fused plan per layer: the epilogue runs
    # inside the pipeline (stage 4), and the plan-level VJP differentiates
    # x, k AND bias through the fusion.
    h = conv_block(x, p["c1"], p["b1"], activation="relu",
                   padding=1, backend=backend)                  # 32x32
    h = maxpool2x2(h)
    h = conv_block(h, p["c2"], p["b2"], activation="relu",
                   padding=1, backend=backend)                  # 16x16
    h = maxpool2x2(h)
    h = h.reshape(h.shape[0], -1)                               # 8x8x32
    return h @ p["w"] + p["b"]


def loss_fn(p, x, y, backend="fft-torch"):
    logits = forward(p, x, backend)
    onehot = TF.one_hot(y.long(), 10).to(logits.dtype)
    return -torch.mean(torch.sum(TF.log_softmax(logits, -1) * onehot, -1))


def train_step(params, opt, x, y, cfg: AdamWConfig, backend="fft-torch"):
    """One step: the loss's grads through the plan-level VJP, then AdamW.
    Returns ``(params, opt, loss)``."""
    names = sorted(params)
    p = {n: params[n].detach().requires_grad_() for n in names}
    loss = loss_fn(p, x, y, backend)
    grads = dict(zip(names, torch.autograd.grad(loss, [p[n] for n in
                                                       names])))
    params, opt, _ = adamw_update(grads, opt, params, cfg)
    return params, opt, loss.detach()


def eval_network(batch, backend="fft-torch"):
    """The serving-side view of the same net: resolve both conv layers in
    ONE planning pass (shared plan cache) with their fused epilogues."""
    ep = Epilogue(bias=True, activation="relu")
    return plan_network([
        NetworkConv("c1", (batch, 3, 32, 32), (16, 3, 3, 3), padding=1,
                    epilogue=ep),
        NetworkConv("c2", (batch, 16, 16, 16), (32, 16, 3, 3), padding=1,
                    epilogue=ep),
    ], backend=backend)


def forward_prepared(p, prepared, x):
    h = maxpool2x2(prepared["c1"](x, bias=p["b1"]))
    h = maxpool2x2(prepared["c2"](h, bias=p["b2"]))
    return h.reshape(h.shape[0], -1) @ p["w"] + p["b"]


@dataclasses.dataclass(frozen=True, eq=False)
class TrainResult:
    """What one run trained and measured."""
    losses: list                 # loss of every step, as floats
    params: dict                 # the trained parameters
    accuracy: float              # held-out accuracy through the prepared net
    prepared_cache: Any          # prepared_cache_info() after the eval
    seconds: float               # wall time of training + eval


def train(args) -> TrainResult:
    device = resolve_device(args.device)
    params = init_params(args.seed, device)
    opt_cfg = AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=args.steps,
                          weight_decay=0.0)
    opt = adamw_init(params)
    dc = DataConfig(vocab=0, seq_len=0, global_batch=args.batch,
                    seed=args.seed, kind="images")

    t0 = time.time()
    losses = []
    for i in range(args.steps):
        b = image_batch(dc, i, device=device)
        params, opt, loss = train_step(params, opt, b["images"], b["labels"],
                                       opt_cfg, args.conv_backend)
        losses.append(loss)
        if i % 10 == 0 or i == args.steps - 1:
            print(f"step {i:4d} loss {float(loss):.4f}")
    losses = [float(l) for l in losses]
    # biases learned THROUGH the fused epilogue (d_bias comes out of the
    # plan-level VJP, not a separate op's grad)
    assert float(params["b1"].abs().max()) > 0, \
        "bias never updated — fused-epilogue bias grad is broken"

    # Eval through the network plan: both layers resolved in one pass and
    # prepared once (keyed by the final step as weights_version); every
    # eval batch skips stage 2 and runs the fused epilogue on the slab.
    net = eval_network(args.batch, args.conv_backend)
    kernels = {"c1": params["c1"], "c2": params["c2"]}
    with torch.no_grad():
        prepared = net.prepare(kernels, weights_version=args.steps)
        b = image_batch(dc, 10_000, device=device)
        logits = forward_prepared(params, prepared, b["images"])
        acc = float(torch.mean(
            (torch.argmax(logits, -1) == b["labels"]).float()))
        # second sweep under the same version: pure prepared-cache hits
        net.prepare(kernels, weights_version=args.steps)
    info = prepared_cache_info()
    seconds = time.time() - t0
    print(f"held-out acc {acc:.2f} ({seconds:.1f}s) — trained via the "
          "plan-level VJP through fused epilogues, served via "
          f"plan_network (prepared cache: {info.hits} hits / "
          f"{info.misses} misses)")
    assert info.hits >= 2, "re-preparing same version should hit the cache"
    assert losses[-1] < 2.5, "training through FFT conv failed to learn"
    return TrainResult(losses=losses, params=params, accuracy=acc,
                       prepared_cache=info, seconds=seconds)


def main(argv=None) -> TrainResult:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=32)
    # fft-torch is the twin of the JAX example's fft-xla; fft-cuda puts the
    # hand-written CUDA kernels on every FFT stage
    ap.add_argument("--conv-backend", default="fft-torch",
                    choices=["direct", "fft-torch", "fft-cuda"])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' runs the "
                         "kernels' plain PyTorch versions)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the weights and of the data stream")
    return train(ap.parse_args(argv))


if __name__ == "__main__":
    main()
