"""Decoder-only LM covering dense / moe / ssm / hybrid / vlm families.

Layers are weight-stacked over *pattern units*: the repeating block of the
architecture's layer pattern (gemma3: 5 local + 1 global; gemma2:
local+global; mixtral/mamba2/hymba: a single layer).  ``params["layers"]``
holds one tree a unit position, each leaf with a leading (n_units,) axis,
the JAX package's tree leaf for leaf; a Python loop over the units takes
the place of its ``jax.lax.scan``.  Kinds and local/global choices inside a
unit are static, so the banded sliding-window schedule stays available.
DeepSeek's leading dense layer(s) sit outside the stacked MoE layers.

Hymba's forced-global layers (first/middle/last of a uniform 'H' pattern)
are not static across units; as in the reference they take a per-layer
window tensor (HUGE for global) instead.

The decode cache is written in place (each unit's slice of the stacked
cache is a view); the entry points still return it.
"""
from __future__ import annotations

import math

import torch

from repro_torch.device import resolve_device
from repro_torch.models.common import ModelConfig
from repro_torch.models import layers as L
from repro_torch.parallel.act_sharding import constrain

HUGE_WINDOW = 1 << 30


# --------------------------------------------------------------------------
# params
# --------------------------------------------------------------------------

def _make_block_params(gen, cfg: ModelConfig, kind: str, moe: bool,
                       lead=()):
    ks = L.split_keys(gen, 8)
    p = {"ln1": L.make_norm_params(ks[0], cfg.d_model, cfg.norm, lead)}
    if kind in ("G", "L", "H"):
        p["attn"] = (L.make_mla_params(ks[1], cfg, lead) if cfg.mla
                     else L.make_attn_params(ks[1], cfg, lead))
    if kind in ("M", "H"):
        p["mamba"] = L.make_mamba_params(ks[2], cfg, lead)
        if kind == "H":
            p["attn_norm"] = L._zeros(gen, (*lead, cfg.d_model))
            p["mamba_norm"] = L._zeros(gen, (*lead, cfg.d_model))
    if kind != "M" and cfg.d_ff:
        p["ln2"] = L.make_norm_params(ks[3], cfg.d_model, cfg.norm, lead)
        p["ffn"] = (L.make_moe_params(ks[4], cfg, lead) if moe
                    else L.make_mlp_params(ks[4], cfg.d_model, cfg.d_ff,
                                           cfg.mlp, lead))
    if cfg.post_norm:
        p["pn1"] = L.make_norm_params(ks[5], cfg.d_model, cfg.norm, lead)
        if "ffn" in p:
            p["pn2"] = L.make_norm_params(ks[6], cfg.d_model, cfg.norm,
                                          lead)
    return p


def _scan_geometry(cfg: ModelConfig):
    """(unit_kinds, n_units) for the stacked part of the stack."""
    unit = cfg.layer_pattern
    n_scan = cfg.n_layers - cfg.first_dense
    if n_scan % len(unit):
        raise ValueError(f"{cfg.name}: {n_scan} stacked layers do not "
                         f"divide into units of {unit}")
    return unit, n_scan // len(unit)


def init_lm_params(cfg: ModelConfig, gen: torch.Generator):
    """Random float32 parameters on ``gen``'s device.  Each stacked leaf is
    drawn at its (n_units, ...) shape at once, so the peak is the
    parameters themselves."""
    ks = L.split_keys(gen, 6)
    unit, n_units = _scan_geometry(cfg)
    moe = cfg.n_experts > 0
    kinds = cfg.layer_kinds()
    uks = L.split_keys(ks[0], len(unit))
    params = {
        "embed": L.dense_init(ks[1], (cfg.vocab, cfg.d_model)),
        "final_norm": L.make_norm_params(ks[2], cfg.d_model, cfg.norm),
        "layers": [_make_block_params(uks[j], cfg, unit[j], moe,
                                      (n_units,))
                   for j in range(len(unit))],
    }
    dks = L.split_keys(ks[3], cfg.first_dense)
    for i in range(cfg.first_dense):
        params[f"dense_{i}"] = _make_block_params(dks[i], cfg, kinds[i],
                                                  False)
    if not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init(ks[4], (cfg.d_model, cfg.vocab))
    if cfg.n_meta_tokens:
        params["meta_tokens"] = L.dense_init(
            ks[5], (cfg.n_meta_tokens, cfg.d_model))
    return params


# --------------------------------------------------------------------------
# per-layer data (a tensor window where the pattern can't make it static)
# --------------------------------------------------------------------------

def _unit_flags(cfg: ModelConfig, device=None):
    """Static per-unit-position locality when uniform across units, else
    per-layer window tensors (hymba's forced-global layers).  Returns
    (static_local, thetas[u][j], wins (n_units, len(unit)) int64 or
    None)."""
    unit, n_units = _scan_geometry(cfg)
    locs = cfg.local_flags()[cfg.first_dense:]
    theta_local = cfg.rope_theta_local or cfg.rope_theta
    thetas = [[theta_local if locs[u * len(unit) + j] else cfg.rope_theta
               for j in range(len(unit))] for u in range(n_units)]
    uniform = all(locs[u * len(unit) + j] == locs[j]
                  for u in range(n_units) for j in range(len(unit)))
    if uniform:
        return [locs[j] for j in range(len(unit))], thetas, None
    # decided per layer at run time; int64 positions minus HUGE_WINDOW
    # cannot overflow
    wins = torch.tensor([cfg.window if lc else HUGE_WINDOW for lc in locs],
                        dtype=torch.int64, device=device)
    return [None] * len(unit), thetas, wins.reshape(n_units, len(unit))


# --------------------------------------------------------------------------
# block forward
# --------------------------------------------------------------------------

def _block_forward(p, x, cfg: ModelConfig, kind: str, *, positions,
                   window, theta, cache=None, cache_index=None,
                   use_flash=False, ring=False):
    """window: 0 (global), static int (banded local), or 0-d tensor.
    ring: the attention cache is a window-sized ring buffer.  The cache is
    written in place; returns (x, the cache or None)."""
    h = L.apply_norm(x, p["ln1"], cfg.norm)
    if kind in ("G", "L"):
        if cfg.mla:
            att, _ = L.mla_forward(p["attn"], h, cfg, positions=positions,
                                   theta=theta, cache=cache,
                                   cache_index=cache_index,
                                   use_flash=use_flash)
        else:
            att, _ = L.attn_forward(p["attn"], h, cfg, positions=positions,
                                    window=window, theta=theta,
                                    cache=cache, cache_index=cache_index,
                                    use_flash=use_flash, ring=ring)
        if cfg.post_norm:
            att = L.apply_norm(att, p["pn1"], cfg.norm)
        x = x + att
    elif kind == "M":
        mo, ns = L.mamba_forward(p["mamba"], h, cfg, state=cache)
        _store(cache, ns)
        x = x + mo
    elif kind == "H":
        attn_cache = ssm_cache = None
        if cache is not None:
            attn_cache = {"k": cache["k"], "v": cache["v"]}
            ssm_cache = {k: cache[k] for k in
                         ("ssm", "conv_x", "conv_B", "conv_C")}
        att, _ = L.attn_forward(p["attn"], h, cfg, positions=positions,
                                window=window, theta=theta,
                                cache=attn_cache, cache_index=cache_index,
                                use_flash=use_flash)
        mo, ns = L.mamba_forward(p["mamba"], h, cfg, state=ssm_cache)
        _store(cache, ns)
        comb = 0.5 * (L.rms_norm(att, p["attn_norm"])
                      + L.rms_norm(mo, p["mamba_norm"]))
        x = x + comb
    if kind != "M" and cfg.d_ff:
        h2 = L.apply_norm(x, p["ln2"], cfg.norm)
        if "w_gate_router" in p.get("ffn", {}):
            if cfg.moe_ep:
                raise NotImplementedError(
                    "expert-parallel MoE (moe_ep) needs a mesh, which the "
                    "port's LM path does not have yet: ROADMAP item 9c")
            f = L.moe_forward(p["ffn"], h2, cfg)
        else:
            f = L.mlp_forward(p["ffn"], h2, cfg.mlp)
        if cfg.post_norm:
            f = L.apply_norm(f, p["pn2"], cfg.norm)
        x = x + f
    return x, cache


def _store(cache, new_state):
    """Copy a mixer's new state tensors into the cache's (views)."""
    if cache is not None and new_state is not None:
        for k, v in new_state.items():
            cache[k].copy_(v)


# --------------------------------------------------------------------------
# the stacked units (shared by train / prefill / decode)
# --------------------------------------------------------------------------

def _tree_index(tree, u):
    if isinstance(tree, dict):
        return {k: _tree_index(v, u) for k, v in tree.items()}
    return tree[u]


def _run_stack(params, cfg: ModelConfig, x, positions, *, cache=None,
               cache_index=None, use_flash=False):
    """Run the stacked units.  ``cache`` is the per-unit-position dict
    from init_cache ({"u{j}": (n_units, ...) stacks}); each unit works on
    its slice, a view, so writes land in the stacks.  Returns (x,
    the unit entries of the cache, or None)."""
    unit, n_units = _scan_geometry(cfg)
    static_local, thetas, wins = _unit_flags(cfg, x.device)
    for u in range(n_units):
        for j, kind in enumerate(unit):
            if static_local[j] is None:
                window = wins[u, j]                     # per layer (hymba)
            else:
                window = cfg.window if static_local[j] else 0
            ring = (cfg.ring_local_cache and static_local[j] is True
                    and cfg.window > 0)
            c_j = None if cache is None else _tree_index(cache[f"u{j}"], u)
            x, _ = _block_forward(
                _tree_index(params["layers"][j], u), x, cfg, kind,
                positions=positions, window=window, theta=thetas[u][j],
                cache=c_j, cache_index=cache_index, use_flash=use_flash,
                ring=ring)
            x = constrain(x, "seq")
    if cache is None:
        return x, None
    return x, {f"u{j}": cache[f"u{j}"] for j in range(len(unit))}


# --------------------------------------------------------------------------
# embeddings / logits
# --------------------------------------------------------------------------

def _dtype(cfg: ModelConfig):
    return getattr(torch, cfg.dtype)


def _embed(params, cfg: ModelConfig, tokens, img_embeds=None,
           prepend_meta=False):
    cdt = _dtype(cfg)
    x = params["embed"][tokens].to(cdt)
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(float(cfg.d_model)),
                             dtype=torch.float32).to(cdt)
    if img_embeds is not None:
        x = torch.cat([img_embeds.to(cdt), x], dim=1)
    if prepend_meta and cfg.n_meta_tokens:
        meta = params["meta_tokens"].to(cdt)[None].expand(
            x.shape[0], cfg.n_meta_tokens, cfg.d_model)
        x = torch.cat([meta, x], dim=1)
    return constrain(x, "seq")


def _logits(params, cfg: ModelConfig, x):
    x = L.apply_norm(x, params["final_norm"], cfg.norm)
    w = (params["embed"].T if cfg.tie_embeddings
         else params["lm_head"]).to(x.dtype)
    logits = constrain((x @ w).float(), "logits")
    if cfg.softcap_final:
        logits = torch.tanh(logits / cfg.softcap_final) * cfg.softcap_final
    return logits


def _dense_prefix(params, cfg, x, positions, cache, cache_index, use_flash):
    new_cache = {}
    kinds = cfg.layer_kinds()
    for i in range(cfg.first_dense):
        c = None if cache is None else cache[f"dense_{i}"]
        x, nc = _block_forward(params[f"dense_{i}"], x, cfg, kinds[i],
                               positions=positions, window=0,
                               theta=cfg.rope_theta, cache=c,
                               cache_index=cache_index, use_flash=use_flash)
        new_cache[f"dense_{i}"] = nc
    return x, new_cache


def _positions(B, S, start, device):
    return (start + torch.arange(S, device=device))[None].expand(B, S)


# --------------------------------------------------------------------------
# public entry points
# --------------------------------------------------------------------------

def lm_forward(params, cfg: ModelConfig, tokens, *, img_embeds=None,
               use_flash=False):
    """Scoring forward: (B, S) tokens -> (B, S_total, vocab) float32."""
    x = _embed(params, cfg, tokens, img_embeds, prepend_meta=True)
    B, S, _ = x.shape
    positions = _positions(B, S, 0, x.device)
    x, _ = _dense_prefix(params, cfg, x, positions, None, None, use_flash)
    x, _ = _run_stack(params, cfg, x, positions, use_flash=use_flash)
    return _logits(params, cfg, x)


# ---- KV cache --------------------------------------------------------------

def _kind_cache(cfg: ModelConfig, kind: str, lead, batch: int, max_len: int,
                device):
    cdt = _dtype(cfg)

    def zeros(*shape, dtype=cdt):
        return torch.zeros(lead + shape, dtype=dtype, device=device)

    c = {}
    if kind in ("G", "L", "H"):
        if cfg.mla:
            c["c_kv"] = zeros(batch, max_len, cfg.kv_lora)
            c["k_rope"] = zeros(batch, max_len, cfg.rope_dim)
        else:
            c["k"] = zeros(batch, cfg.padded_kv, max_len, cfg.head_dim)
            c["v"] = zeros(batch, cfg.padded_kv, max_len, cfg.head_dim)
    if kind in ("M", "H"):
        W = cfg.conv_width
        c["ssm"] = zeros(batch, cfg.ssm_heads, cfg.ssm_head_dim,
                         cfg.ssm_state, dtype=torch.float32)
        c["conv_x"] = zeros(batch, W - 1, cfg.d_inner)
        c["conv_B"] = zeros(batch, W - 1, cfg.ssm_state)
        c["conv_C"] = zeros(batch, W - 1, cfg.ssm_state)
    return c


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device=None):
    """Decode cache: one stacked (n_units, ...) entry per pattern-unit
    position (so per-position lengths can differ: with ``ring_local_cache``
    sliding-window layers allocate only a window-sized ring) plus one entry
    per leading dense layer, on ``device`` (default: the GPU, as
    ``repro_torch.device.resolve_device``)."""
    device = resolve_device(device)
    unit, n_units = _scan_geometry(cfg)
    static_local, _, _ = _unit_flags(cfg)
    kinds = cfg.layer_kinds()
    cache = {}
    for j, kind in enumerate(unit):
        ring = (cfg.ring_local_cache and static_local[j] is True
                and cfg.window > 0)
        len_j = min(max_len, cfg.window) if ring else max_len
        cache[f"u{j}"] = _kind_cache(cfg, kind, (n_units,), batch, len_j,
                                     device)
    for i in range(cfg.first_dense):
        cache[f"dense_{i}"] = _kind_cache(cfg, kinds[i], (), batch, max_len,
                                          device)
    return cache


def lm_prefill(params, cfg: ModelConfig, tokens, cache, *, img_embeds=None,
               use_flash=True):
    """Prefill: run the full sequence, fill cache at offset 0.
    Returns (last-token logits, cache, seq_len_written)."""
    x = _embed(params, cfg, tokens, img_embeds, prepend_meta=True)
    B, S, _ = x.shape
    positions = _positions(B, S, 0, x.device)
    x, new_cache = _dense_prefix(params, cfg, x, positions, cache, 0,
                                 use_flash)
    x, sc = _run_stack(params, cfg, x, positions, cache=cache,
                       cache_index=0, use_flash=use_flash)
    new_cache.update(sc)
    return _logits(params, cfg, x[:, -1:]), new_cache, S


def lm_decode_step(params, cfg: ModelConfig, tokens, pos, cache):
    """One decode step. tokens: (B, 1); pos: int write index.
    Returns (logits, cache)."""
    x = _embed(params, cfg, tokens)
    B, S, _ = x.shape
    positions = _positions(B, S, int(pos), x.device)
    x, new_cache = _dense_prefix(params, cfg, x, positions, cache, pos,
                                 False)
    x, sc = _run_stack(params, cfg, x, positions, cache=cache,
                       cache_index=pos)
    new_cache.update(sc)
    return _logits(params, cfg, x), new_cache
