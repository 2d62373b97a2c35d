"""Deterministic, stateless-seekable synthetic data (``repro.data`` twin).

Every batch is a pure function of (seed, step), drawn with numpy exactly
as ``repro.data.pipeline`` draws it, so both packages see bit-equal
batches; the port hands them out as tensors on a device.  The LM and
frame streams (``lm_batch``, ``frames_batch``) come with the LM substrate.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    kind: str = "lm"        # lm | images | frames


def _rng(cfg: DataConfig, step: int):
    return np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, 0xD47A]))


def image_batch(cfg: DataConfig, step: int, *, chw=(3, 32, 32), n_class=10,
                device=None):
    """Class-conditional Gaussian images: ``{"images": (B, *chw) float32,
    "labels": (B,) int32}`` on ``device`` (default: the GPU)."""
    r = _rng(cfg, step)
    B = cfg.global_batch
    y = r.integers(0, n_class, size=(B,))
    x = r.standard_normal((B,) + tuple(chw)).astype(np.float32)
    # class-dependent mean so the task is learnable
    x += y[:, None, None, None].astype(np.float32) * 0.3
    device = resolve_device(device)
    return {"images": torch.from_numpy(x).to(device),
            "labels": torch.from_numpy(y.astype(np.int32)).to(device)}
