"""Whisper-style encoder-decoder (audio backbone; the conv frontend is a
stub — callers feed precomputed frame embeddings).

Encoder: bidirectional attention over frames + sinusoidal positions.
Decoder: causal self-attention + cross-attention, learned positions.
Both stacks are weight-stacked, (n_layers, ...) leaves, and run in a
Python loop over the layers; while grad is on each layer is recomputed in
the backward, as the reference's ``jax.checkpoint`` of its scan body.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.common import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.lm import (_dtype, _positions, _tree_index,
                                   _unstack, remat_call)
from repro_torch.parallel.act_sharding import (constrain, grad_placed,
                                               project_heads, take_rows)


def sinusoid_posemb(length: int, d: int, device=None):
    pos = np.arange(length)[:, None]
    dim = np.arange(d // 2)[None, :]
    ang = pos / (10000 ** (2 * dim / d))
    return torch.tensor(np.concatenate([np.sin(ang), np.cos(ang)], axis=-1),
                        dtype=torch.float32, device=device)


# --------------------------------------------------------------------------
# params
# --------------------------------------------------------------------------

def _enc_layer(gen, cfg, lead):
    ks = L.split_keys(gen, 4)
    return {"ln1": L.make_norm_params(ks[0], cfg.d_model, cfg.norm, lead),
            "attn": L.make_attn_params(ks[1], cfg, lead),
            "ln2": L.make_norm_params(ks[2], cfg.d_model, cfg.norm, lead),
            "mlp": L.make_mlp_params(ks[3], cfg.d_model, cfg.d_ff, cfg.mlp,
                                     lead)}


def _dec_layer(gen, cfg, lead):
    ks = L.split_keys(gen, 6)
    return {"ln1": L.make_norm_params(ks[0], cfg.d_model, cfg.norm, lead),
            "attn": L.make_attn_params(ks[1], cfg, lead),
            "lnx": L.make_norm_params(ks[2], cfg.d_model, cfg.norm, lead),
            "xattn": L.make_attn_params(ks[3], cfg, lead),
            "ln2": L.make_norm_params(ks[4], cfg.d_model, cfg.norm, lead),
            "mlp": L.make_mlp_params(ks[5], cfg.d_model, cfg.d_ff, cfg.mlp,
                                     lead)}


def init_whisper_params(cfg: ModelConfig, gen: torch.Generator):
    """Random float32 parameters on ``gen``'s device."""
    ks = L.split_keys(gen, 6)
    return {
        "enc_layers": _enc_layer(ks[0], cfg, (cfg.n_enc_layers,)),
        "enc_norm": L.make_norm_params(ks[2], cfg.d_model, cfg.norm),
        "dec_layers": _dec_layer(ks[1], cfg, (cfg.n_layers,)),
        "dec_norm": L.make_norm_params(ks[3], cfg.d_model, cfg.norm),
        "embed": L.dense_init(ks[4], (cfg.vocab, cfg.d_model)),
        "dec_posemb": L.dense_init(ks[5], (cfg.max_dec_len, cfg.d_model)),
    }


# --------------------------------------------------------------------------
# attention helpers (no RoPE; absolute position embeddings)
# --------------------------------------------------------------------------

def _proj(x, w):
    return project_heads(x, w.to(x.dtype)).transpose(1, 2)


def _proj_qkv(p, xq, xkv):
    # whisper is MHA (n_kv == n_heads): no expansion needed
    return _proj(xq, p["wq"]), _proj(xkv, p["wk"]), _proj(xkv, p["wv"])


def _out(p, out, cfg):
    """(B, H, S, hd) attention output -> (B, S, d)."""
    out = L._mask_heads(out.transpose(1, 2), cfg)    # (B, S, H, hd)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"].to(out.dtype))


def _attend(p, q, k, v, cfg, *, causal, q_pos, kv_pos, use_flash=False):
    fn = L.attend_flash if use_flash else L.attend_full
    return _out(p, fn(q, k, v, q_positions=q_pos, kv_positions=kv_pos,
                      causal=causal), cfg)


# --------------------------------------------------------------------------
# encoder / decoder forward
# --------------------------------------------------------------------------

def encode(params, cfg: ModelConfig, frames):
    """frames: (B, T, d) precomputed frame embeddings (conv-frontend stub)."""
    cdt = _dtype(cfg)
    B, T, _ = frames.shape
    use_flash = T >= 2048          # bidirectional flash for long frame seqs
    x = frames.to(cdt) + sinusoid_posemb(T, cfg.d_model,
                                         frames.device).to(cdt)[None]
    pos = _positions(B, T, 0, frames.device)

    def body(x, p):
        h = L.apply_norm(x, p["ln1"], cfg.norm)
        q, k, v = _proj_qkv(p["attn"], h, h)
        x = x + _attend(p["attn"], q, k, v, cfg, causal=False,
                        q_pos=pos, kv_pos=pos, use_flash=use_flash)
        h = L.apply_norm(x, p["ln2"], cfg.norm)
        return constrain(x + L.mlp_forward(p["mlp"], h, cfg.mlp), "seq")

    for p in _unstack(params["enc_layers"], cfg.n_enc_layers):
        x = remat_call(True, body, x, p)
    return L.apply_norm(x, params["enc_norm"], cfg.norm)


def _dec_logits(params, cfg, x):
    x = L.apply_norm(x, params["dec_norm"], cfg.norm)
    return (x @ grad_placed(params["embed"]).T.to(x.dtype)).float()


def decode_train(params, cfg: ModelConfig, enc_out, tokens):
    """Teacher-forced decoder: (B, S_dec) -> (B, S_dec, vocab)."""
    cdt = _dtype(cfg)
    B, S = tokens.shape
    T = enc_out.shape[1]
    x = take_rows(params["embed"], tokens).to(cdt) \
        + params["dec_posemb"][:S].to(cdt)[None]
    dpos = _positions(B, S, 0, tokens.device)
    epos = _positions(B, T, 0, tokens.device)

    def body(x, p):
        h = L.apply_norm(x, p["ln1"], cfg.norm)
        q, k, v = _proj_qkv(p["attn"], h, h)
        x = x + _attend(p["attn"], q, k, v, cfg, causal=True,
                        q_pos=dpos, kv_pos=dpos)
        h = L.apply_norm(x, p["lnx"], cfg.norm)
        q, k, v = _proj_qkv(p["xattn"], h, enc_out)
        x = x + _attend(p["xattn"], q, k, v, cfg, causal=False,
                        q_pos=dpos, kv_pos=epos)
        h = L.apply_norm(x, p["ln2"], cfg.norm)
        return constrain(x + L.mlp_forward(p["mlp"], h, cfg.mlp), "seq")

    for p in _unstack(params["dec_layers"], cfg.n_layers):
        x = remat_call(True, body, x, p)
    return _dec_logits(params, cfg, x)


# ---- serving ---------------------------------------------------------------

def init_dec_cache(cfg: ModelConfig, batch: int, enc_len: int, *,
                   device=None):
    """Decoder self and cross k/v caches on ``device`` (default: the
    GPU, as ``repro_torch.device.resolve_device``)."""
    device = resolve_device(device)
    cdt = _dtype(cfg)
    Ld = cfg.n_layers
    kv = (Ld, batch, cfg.padded_kv, cfg.max_dec_len, cfg.head_dim)
    xkv = (Ld, batch, cfg.padded_kv, enc_len, cfg.head_dim)
    return {"k": torch.zeros(kv, dtype=cdt, device=device),
            "v": torch.zeros(kv, dtype=cdt, device=device),
            "xk": torch.zeros(xkv, dtype=cdt, device=device),
            "xv": torch.zeros(xkv, dtype=cdt, device=device)}


def prefill_cross(params, cfg: ModelConfig, enc_out, cache):
    """Write each layer's cross k/v of the encoder output into ``cache``
    (in place); returns it."""
    for i in range(cfg.n_layers):
        p = _tree_index(params["dec_layers"], i)["xattn"]
        cache["xk"][i].copy_(_proj(enc_out, p["wk"]))
        cache["xv"][i].copy_(_proj(enc_out, p["wv"]))
    return cache


def decode_step(params, cfg: ModelConfig, tokens, pos, cache):
    """One decoder step with self-cache write at ``pos`` (clamped, as the
    reference's dynamic slices) and cached cross k/v.  tokens: (B, 1).
    Returns (logits, cache); the cache is written in place."""
    cdt = _dtype(cfg)
    B = tokens.shape[0]
    pos = int(pos)
    x = take_rows(params["embed"], tokens).to(cdt) \
        + L.cache_slice(params["dec_posemb"], pos, 1, 0).to(cdt)[None]
    dev = tokens.device
    dpos = _positions(B, 1, pos, dev)
    T = cache["xk"].shape[3]
    epos = _positions(B, T, 0, dev)
    Lmax = cache["k"].shape[3]
    kv_pos = _positions(B, Lmax, 0, dev)
    kv_len = torch.full((B,), pos + 1, dtype=torch.int64, device=dev)
    for i in range(cfg.n_layers):
        p = _tree_index(params["dec_layers"], i)
        h = L.apply_norm(x, p["ln1"], cfg.norm)
        q, k, v = _proj_qkv(p["attn"], h, h)
        ck = L.cache_write(cache["k"][i], k, pos, axis=2)
        cv = L.cache_write(cache["v"][i], v, pos, axis=2)
        out = L.attend_full(q, ck, cv, q_positions=dpos, kv_positions=kv_pos,
                            kv_len=kv_len)
        x = x + _out(p["attn"], out, cfg)
        h = L.apply_norm(x, p["lnx"], cfg.norm)
        q = _proj(h, p["xattn"]["wq"])
        x = x + _attend(p["xattn"], q, cache["xk"][i], cache["xv"][i], cfg,
                        causal=False, q_pos=dpos, kv_pos=epos)
        h = L.apply_norm(x, p["ln2"], cfg.norm)
        x = x + L.mlp_forward(p["mlp"], h, cfg.mlp)
    return _dec_logits(params, cfg, x), cache
