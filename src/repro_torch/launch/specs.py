"""Shape-only stand-ins for every model input (the reference's
``ShapeDtypeStruct``s): ``meta`` tensors, which hold a shape and a dtype
and allocate nothing, so a full-width model's parameters (mixtral: 187 GB
of float32) can be sized, specced and placed on paper."""
from __future__ import annotations

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils import _pytree

from repro_torch.models.common import ModelConfig, ShapeCell
from repro_torch.models import lm as LM
from repro_torch.models import whisper as WH
from repro_torch.optim import adamw_init

_META = torch.device("meta")


def _sd(shape, dtype):
    return torch.empty(shape, dtype=dtype, device=_META)


def input_specs(cfg: ModelConfig, cell: ShapeCell):
    """Batch stand-ins for one (arch x shape) cell.

    train: {tokens, labels} (+ img_embeds for vlm; frames for audio — the
    modality frontend is a stub, so the spec IS the precomputed embedding).
    prefill: {tokens} (+ stubs); decode: {tokens} of (B, 1).
    VLM image tokens count against the context budget (tokens = S - 576);
    hymba's 128 meta tokens are architectural overhead on top of S.
    """
    B, S = cell.global_batch, cell.seq_len
    i32, f32 = torch.int32, torch.float32
    if cfg.encdec:
        # seq_len scales the encoder (frame count); decoder is max_dec_len.
        if cell.kind == "train":
            return {"frames": _sd((B, S, cfg.d_model), f32),
                    "tokens": _sd((B, cfg.max_dec_len), i32),
                    "labels": _sd((B, cfg.max_dec_len), i32)}
        if cell.kind == "prefill":
            return {"frames": _sd((B, S, cfg.d_model), f32),
                    "tokens": _sd((B, 1), i32)}
        return {"tokens": _sd((B, 1), i32)}

    n_img = cfg.n_frontend_tokens if cfg.frontend == "vision_stub" else 0
    if cell.kind == "train":
        out = {"tokens": _sd((B, S - n_img), i32),
               "labels": _sd((B, S - n_img), i32)}
    elif cell.kind == "prefill":
        out = {"tokens": _sd((B, S - n_img), i32)}
    else:
        return {"tokens": _sd((B, 1), i32)}
    if n_img:
        out["img_embeds"] = _sd((B, n_img, cfg.d_model), f32)
    return out


def param_structs(cfg: ModelConfig, *, bf16: bool = False):
    """The parameter tree's shapes and dtypes: the init runs on fake
    tensors (no draw, no storage), and each leaf comes out as a ``meta``
    tensor; with ``bf16`` the float32 leaves are bfloat16."""
    init = WH.init_whisper_params if cfg.encdec else LM.init_lm_params
    with FakeTensorMode():
        fakes = init(cfg, torch.Generator().manual_seed(0))

    def meta(t):
        dtype = torch.bfloat16 if bf16 and t.dtype == torch.float32 \
            else t.dtype
        return _sd(t.shape, dtype)
    return _pytree.tree_map(meta, fakes)


def opt_structs(params_struct):
    return adamw_init(params_struct)


def cache_structs(cfg: ModelConfig, cell: ShapeCell):
    B, S = cell.global_batch, cell.seq_len
    if cfg.encdec:
        return WH.init_dec_cache(cfg, B, S, device=_META)
    if cell.kind == "prefill":
        S += cfg.n_meta_tokens          # hymba meta tokens are cached too
    return LM.init_cache(cfg, B, S, device=_META)
