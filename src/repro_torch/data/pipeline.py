"""Deterministic, stateless-seekable synthetic data (``repro.data`` twin).

Every batch is a pure function of (seed, step), drawn with numpy exactly
as ``repro.data.pipeline`` draws it, so both packages see bit-equal
batches; the port hands them out as tensors on a device (the GPU unless
the caller asks for another).
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


def _on(device, **arrays):
    device = resolve_device(device)
    return {k: torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for k, a in arrays.items()}


def lm_batch(cfg: DataConfig, step: int, *, device=None):
    """Zipf-ish synthetic token stream with a learnable structure: token
    t+1 depends on t (bigram-ish), so small models show a falling loss.
    ``{"tokens", "labels"}``: (B, S - 1) int32 each, the labels the tokens
    one position on."""
    r = _rng(cfg, step)
    B, S, V = cfg.global_batch, cfg.seq_len, cfg.vocab
    base = r.zipf(1.3, size=(B, S)).clip(1, V - 1)
    # inject copy structure: 25% of positions repeat the previous token
    prev = np.roll(base, 1, axis=1)
    m = r.random((B, S)) < 0.25
    toks = np.where(m, prev, base).astype(np.int32)
    return _on(device, tokens=toks[:, :-1], labels=toks[:, 1:])


def frames_batch(cfg: DataConfig, step: int, *, d_model: int, frames: int,
                 device=None):
    """Whisper stub frontend: precomputed frame embeddings (B, frames,
    d_model) float32 + text tokens and labels as ``lm_batch``'s."""
    r = _rng(cfg, step)
    B = cfg.global_batch
    f = r.standard_normal((B, frames, d_model)).astype(np.float32)
    toks = r.integers(1, cfg.vocab, size=(B, cfg.seq_len)).astype(np.int32)
    return _on(device, frames=f, tokens=toks[:, :-1], labels=toks[:, 1:])


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
    return _on(device, images=x, labels=y.astype(np.int32))
