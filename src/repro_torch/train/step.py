"""Prefill / decode step builders used by the serving launcher.

Each step is a plain function of (params, batch or tokens, pos, cache) on
the port's trees; the cache is written in place and returned.  The
training half of the JAX package's module (``make_train_step``,
``cross_entropy``, ``init_train_state``) is ROADMAP item 9b.
"""
from __future__ import annotations

from repro_torch.models.common import ModelConfig
from repro_torch.models import lm as LM
from repro_torch.models import whisper as WH


def make_prefill_step(cfg: ModelConfig, *, use_flash: bool = True):
    if cfg.encdec:
        def prefill(params, batch, cache):
            enc = WH.encode(params, cfg, batch["frames"])
            cache = WH.prefill_cross(params, cfg, enc, cache)
            return WH.decode_step(params, cfg, batch["tokens"], 0, cache)
        return prefill

    def prefill(params, batch, cache):
        img = batch.get("img_embeds")
        logits, cache, _ = LM.lm_prefill(params, cfg, batch["tokens"], cache,
                                         img_embeds=img, use_flash=use_flash)
        return logits, cache
    return prefill


def make_decode_step(cfg: ModelConfig):
    if cfg.encdec:
        def decode(params, tokens, pos, cache):
            return WH.decode_step(params, cfg, tokens, pos, cache)
        return decode

    def decode(params, tokens, pos, cache):
        return LM.lm_decode_step(params, cfg, tokens, pos, cache)
    return decode
