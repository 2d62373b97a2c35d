"""Neural-net layers of the port: the conv half (conv through the
plan/execute engine, trainable through the plan-level VJP, and pooling)
and the LM half shared by the ten LM architectures.

The LM half is pure functions over param trees (nested dicts of tensors,
the JAX package's trees leaf for leaf). Conventions:
  * params are float32; compute dtype per ModelConfig (bf16 default),
    each weight cast at its use.
  * RoPE is the interleaved-pair form.
  * attention is either `attend_full` (materialised scores; decode and
    short-seq prefill) or `attend_flash` (online-softmax blocks; long
    prefill, with a banded schedule for static sliding windows).
  * caches are written in place through `cache_write`, which clamps its
    start as ``jax.lax.dynamic_update_slice_in_dim`` does; the functions
    still return the cache.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as TF
from torch.utils._python_dispatch import _disable_current_modes
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.fake import is_fake
from repro_torch.models.common import ModelConfig
from repro_torch.parallel.act_sharding import (P, axis_sizes, constrain,
                                               dp_axes, is_dtensor, local_of,
                                               merge_heads, on_blocks,
                                               on_head_blocks,
                                               on_local_blocks, placements,
                                               project_heads,
                                               repeat_heads, split_heads)

NEG_INF = -2.3819763e38   # most-negative bf16-representable


def conv2d_planned(x, k, *, padding=1, backend="auto", schedule="auto",
                   mesh=None, compute_dtype=None, weights_version=None):
    """NCHW convolution through ``repro_torch.conv`` for model layers.

    Training (``weights_version=None``): executes ``plan(x, k)`` — fully
    differentiable in ``x`` and ``k`` via the plan-level VJP, on every
    backend.

    Serving (``weights_version`` given, e.g. the train step the weights
    were loaded from): executes a *prepared* plan — the kernel transform is
    cached under (plan, version) and skipped on every call; passing a new
    version after a weight update invalidates and re-prepares.
    """
    from repro_torch.conv import plan_conv
    plan = plan_conv(tuple(x.shape), tuple(k.shape), padding=padding,
                     backend=backend, schedule=schedule, mesh=mesh,
                     compute_dtype=compute_dtype)
    if weights_version is None:
        return plan(x, k)
    return plan.prepare(k, weights_version=weights_version)(x)


def maxpool2x2(x):
    """2x2/stride-2 max pool over the spatial axes of NCHW ``x``.  A
    ``DTensor`` (a sharded plan's output: B and channels sharded, the
    spatial axes whole) is pooled on each rank's local block, with no
    collective."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return TF.max_pool2d(x, 2, 2)
    B, C, H, W = x.shape
    Ho, Wo = H // 2, W // 2
    t = x.to_local()
    # a rank past the end of an uneven split holds an empty block, which
    # max_pool2d refuses
    y = TF.max_pool2d(t, 2, 2) if t.numel() \
        else t.new_empty(t.shape[:2] + (Ho, Wo))
    return DTensor.from_local(y.contiguous(), x.device_mesh, x.placements,
                              run_check=False,
                              shape=torch.Size((B, C, Ho, Wo)),
                              stride=(C * Ho * Wo, Ho * Wo, Wo, 1))


def conv_block(x, k, bias=None, *, activation="none", residual=None,
               padding=1, backend="auto", schedule="auto", mesh=None,
               compute_dtype=None, weights_version=None):
    """Conv + bias + activation (+ residual) as ONE fused plan.

    The elementwise tail is an ``Epilogue`` frozen into the plan and
    executed inside the pipeline's stage 4 (on ``fft-cuda``, inside the
    inverse kernel's tail) instead of as separate ops on the output.
    Differentiable in ``x``, ``k`` AND ``bias``/``residual`` via the
    plan-level VJP; ``weights_version`` routes through a prepared plan
    exactly like ``conv2d_planned``.
    """
    from repro_torch.conv import Epilogue, plan_conv
    ep = Epilogue(bias=bias is not None, activation=activation,
                  residual=residual is not None)
    plan = plan_conv(tuple(x.shape), tuple(k.shape), padding=padding,
                     backend=backend, schedule=schedule, mesh=mesh,
                     compute_dtype=compute_dtype, epilogue=ep)
    if weights_version is None:
        return plan(x, k, bias=bias, residual=residual)
    return plan.prepare(k, weights_version=weights_version)(
        x, bias=bias, residual=residual)


# --------------------------------------------------------------------------
# init helpers
# --------------------------------------------------------------------------

def split_keys(gen: torch.Generator, n):
    """``n`` generators on ``gen``'s device, seeded from draws of ``gen``.
    The seeds are real under a fake mode too (``launch.specs`` builds the
    parameters' shapes on fake tensors)."""
    with _disable_current_modes():
        seeds = torch.randint(0, 2 ** 62, (n,), generator=gen,
                              device=gen.device).tolist()
    return [torch.Generator(device=gen.device).manual_seed(s) for s in seeds]


def dense_init(gen: torch.Generator, shape, scale=0.02):
    """``scale`` times a standard normal truncated at +-2, float32, on the
    generator's device."""
    w = torch.empty(tuple(shape), dtype=torch.float32, device=gen.device)
    if is_fake(w):              # shapes only (launch.specs): nothing to draw
        return w
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return w.mul_(scale)


def _zeros(gen, shape):
    return torch.zeros(tuple(shape), dtype=torch.float32, device=gen.device)


def _ones(gen, shape):
    return torch.ones(tuple(shape), dtype=torch.float32, device=gen.device)


# --------------------------------------------------------------------------
# clamped cache writes and reads
# --------------------------------------------------------------------------

def _clamp_start(start, size, n):
    """A negative start counts from the end, then the start is clamped,
    as in ``jax.lax``'s dynamic slices."""
    s = int(start)
    if s < 0:
        s += size
    return min(max(s, 0), size - n)


def cache_write(buf, update, start, axis):
    """Write ``update`` into ``buf`` along ``axis`` from ``start``, in
    place, and return ``buf``.  The start is clamped into
    ``[0, buf.shape[axis] - update.shape[axis]]``, as
    ``jax.lax.dynamic_update_slice_in_dim`` clamps it (the reference's
    serve path writes past the end of the cache for the vision stub)."""
    n = update.shape[axis]
    s = _clamp_start(start, buf.shape[axis], n)
    if is_dtensor(buf):
        _write_blocks(buf, update, s, axis)
    else:
        buf.narrow(axis, s, n).copy_(update)
    return buf


def _write_blocks(buf, update, s, axis):
    """``cache_write`` into a ``DTensor`` cache: each rank writes the rows
    of ``[s, s + n)`` that fall in its own block of ``buf`` (a view of a
    dim sharded over ranks would be a copy, and the write lost).  The
    update comes whole along ``axis`` and laid out as ``buf`` elsewhere."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    mesh, places = buf.device_mesh, tuple(buf.placements)
    axis %= buf.ndim
    whole = [Replicate() if isinstance(pl, Shard) and pl.dim == axis else pl
             for pl in places]
    if not is_dtensor(update):
        update = DTensor.from_local(update, mesh,
                                    [Replicate()] * mesh.ndim,
                                    run_check=False)
    up = update.redistribute(mesh, whole).to_local()
    shape, offset = compute_local_shape_and_global_offset(buf.shape, mesh,
                                                          places)
    lo, n = offset[axis], up.shape[axis]
    a, b = max(s, lo), min(s + n, lo + shape[axis])
    if a < b:
        buf.to_local().narrow(axis, a - lo, b - a).copy_(
            up.narrow(axis, a - s, b - a))


def cache_slice(buf, start, n, axis):
    """``buf[start:start + n]`` along ``axis``, the start clamped as
    ``jax.lax.dynamic_slice_in_dim`` clamps it."""
    return buf.narrow(axis, _clamp_start(start, buf.shape[axis], n), n)


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------

def rms_norm(x, gamma, eps=1e-6):
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps) * (1.0 + gamma.float())
    return out.to(x.dtype)


def layer_norm(x, gamma, beta, eps=1e-5):
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, correction=0)
    out = (x32 - mu) * torch.rsqrt(var + eps) * gamma + beta
    return out.to(x.dtype)


def make_norm_params(gen, d, kind, lead=()):
    if kind == "rms":
        return {"gamma": _zeros(gen, (*lead, d))}
    return {"gamma": _ones(gen, (*lead, d)), "beta": _zeros(gen, (*lead, d))}


def apply_norm(x, p, kind):
    if kind == "rms":
        return rms_norm(x, p["gamma"])
    return layer_norm(x, p["gamma"], p["beta"])


# --------------------------------------------------------------------------
# RoPE (interleaved pairs)
# --------------------------------------------------------------------------

def rope(x, positions, theta):
    """x: (..., S, n_heads, head_dim); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    base = torch.tensor(theta, dtype=torch.float32, device=x.device)
    freqs = base ** (-torch.arange(0, hd, 2, dtype=torch.float32,
                                   device=x.device) / hd)
    ang = positions.float()[..., None] * freqs         # (..., S, hd/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    xr = x.float().reshape(x.shape[:-1] + (hd // 2, 2))
    x0, x1 = xr[..., 0], xr[..., 1]
    out = torch.stack([x0 * cos - x1 * sin, x0 * sin + x1 * cos], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


# --------------------------------------------------------------------------
# attention
# --------------------------------------------------------------------------

def _softcap(s, cap):
    return torch.tanh(s / cap) * cap if cap else s


def _static_zero_window(window) -> bool:
    return isinstance(window, int) and window == 0


@on_head_blocks
def attend_full(q, k, v, *, q_positions, kv_positions, window=0,
                softcap=0.0, causal=True, kv_len=None, lse=False):
    """Materialised-score attention, head-expanded layout.

    q, k, v: (B, H, S, hd) — GQA kv heads are pre-expanded to H by the
    caller.  window: 0 / static int / 0-d tensor (a per-layer window;
    HUGE_WINDOW disables it in effect).  kv_len: optional (B,) valid cache
    length for decode.  ``lse``: return (the float32 output, the scores'
    log-sum-exp (B, H, Sq)), for a merge with other keys' results.
    """
    hd = q.shape[-1]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) \
        / math.sqrt(hd)
    s = _softcap(s, softcap)
    qp = q_positions[:, None, :, None]
    kp = kv_positions[:, None, None, :]
    mask = torch.ones(s.shape, dtype=torch.bool, device=s.device)
    if causal:
        mask &= kp <= qp
    if not _static_zero_window(window):
        mask &= kp > qp - window
    if kv_len is not None:
        mask &= kp < kv_len[:, None, None, None]
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    if lse:
        return out, torch.logsumexp(s, dim=-1)
    return out.to(v.dtype)


def _pick_block(S, pref):
    """Largest block <= pref dividing S (hymba: S = 4096 + 128 meta)."""
    b = min(pref, S)
    while S % b:
        b -= 1
    return b


@on_head_blocks
def attend_flash(q, k, v, *, q_positions, kv_positions, window=0,
                 softcap=0.0, causal=True, q_block=512, kv_block=512):
    """Online-softmax blocked attention.

    q, k, v: (B, H, S, hd), kv pre-expanded to H.  Static sliding-window
    layers get a banded schedule: only the kv blocks intersecting the window
    are visited (O(S*W) instead of O(S^2)).  A tensor window applies the
    mask but visits all blocks.  All q blocks advance together, one kv
    block a step, in the reference's order of steps.  While grad is on,
    each step runs under ``torch.utils.checkpoint``, the twin of the
    reference's ``jax.checkpoint`` of its step: the backward keeps only
    ``(m, l, acc)`` between steps and recomputes a step's scores."""
    B, H, Sq, hd = q.shape
    Skv, vd = k.shape[2], v.shape[-1]
    q_block, kv_block = _pick_block(Sq, q_block), _pick_block(Skv, kv_block)
    nq, nk = Sq // q_block, Skv // kv_block
    scale = 1.0 / math.sqrt(hd)
    qb = q.reshape(B, H, nq, q_block, hd).float()
    kb = k.reshape(B, H, nk, kv_block, hd).float()
    vb = v.reshape(B, H, nk, kv_block, vd).float()
    qp = q_positions.reshape(B, nq, q_block)
    kp = kv_positions.reshape(B, nk, kv_block)

    banded = isinstance(window, int) and window > 0
    masked = not _static_zero_window(window)
    if banded:
        # kv block j for q block i runs over offsets i - wb .. i,
        # wb = ceil((window + q_block) / kv_block)
        wb = -(-(window + q_block) // kv_block)
        n_steps = min(nk, wb + 1)
    else:
        n_steps = nk

    dev = q.device
    qi = torch.arange(nq, device=dev)
    qp_b = qp[:, None, :, :, None]                     # (B, 1, nq, Q, 1)

    def step(m, l, acc, qb, kb, vb, window, js):
        if banded:
            j_raw = qi - (n_steps - 1) + js
            visit = (j_raw >= 0)[None, None, :, None, None]
            j = torch.clamp(j_raw, min=0)   # clamped re-visits are masked
        else:
            j, visit = torch.full((nq,), js, device=dev), None
        k_j, v_j = kb[:, :, j], vb[:, :, j]            # (B, H, nq, K, d)
        kp_j = kp[:, j][:, None, :, None, :]           # (B, 1, nq, 1, K)
        s = torch.einsum("bhnqd,bhnkd->bhnqk", qb, k_j) * scale
        s = _softcap(s, softcap)
        msk = torch.ones(s.shape, dtype=torch.bool, device=dev)
        if causal:
            msk &= kp_j <= qp_b
        if masked:
            msk &= kp_j > qp_b - window
        if visit is not None:
            msk &= visit
        s = torch.where(msk, s, NEG_INF)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        p = torch.where(msk, torch.exp(s - m_new[..., None]), 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + torch.sum(p, dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhnqk,bhnkd->bhnqd",
                                                   p, v_j)
        return m_new, l, acc

    m = torch.full((B, H, nq, q_block), NEG_INF, dtype=torch.float32,
                   device=dev)
    l = torch.zeros((B, H, nq, q_block), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, H, nq, q_block, vd), dtype=torch.float32,
                      device=dev)
    remat = torch.is_grad_enabled() and any(
        t.requires_grad for t in (qb, kb, vb))
    for js in range(n_steps):
        if remat:
            m, l, acc = checkpoint(step, m, l, acc, qb, kb, vb, window, js,
                                   use_reentrant=False,
                                   preserve_rng_state=False)
        else:
            m, l, acc = step(m, l, acc, qb, kb, vb, window, js)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    # (B, H, nq, q_block, vd) -> (B, H, Sq, vd)
    return out.reshape(B, H, Sq, vd).to(v.dtype)


# --------------------------------------------------------------------------
# GQA attention layer (with qk-norm, softcap, local/global, cache)
# --------------------------------------------------------------------------

def head_mask(cfg: ModelConfig, device=None):
    """(padded_heads,) 1.0 for real head slots, 0.0 for padding slots.
    Real heads of real kv-group g occupy slots [g*G_pad, g*G_pad+G_real);
    padded kv groups (g >= n_kv) are entirely dead."""
    Hp, Hkvp = cfg.padded_heads, cfg.padded_kv
    g_pad, g_real = Hp // Hkvp, cfg.n_heads // cfg.n_kv
    m = [1.0 if (h // g_pad) < cfg.n_kv and (h % g_pad) < g_real else 0.0
         for h in range(Hp)]
    return torch.tensor(m, dtype=torch.float32, device=device)


def _mask_heads(out, cfg: ModelConfig):
    """Zero the padding head slots of (B, S, H, hd) ``out``: exact
    n_heads semantics."""
    if cfg.padded_heads != cfg.n_heads or cfg.padded_kv != cfg.n_kv:
        out = out * head_mask(cfg, out.device).to(out.dtype)[
            None, None, :, None]
    return out


def make_attn_params(gen, cfg: ModelConfig, lead=()):
    d, H, Hkv, hd = cfg.d_model, cfg.padded_heads, cfg.padded_kv, cfg.head_dim
    ks = split_keys(gen, 4)
    p = {"wq": dense_init(ks[0], (*lead, d, H, hd)),
         "wk": dense_init(ks[1], (*lead, d, Hkv, hd)),
         "wv": dense_init(ks[2], (*lead, d, Hkv, hd)),
         "wo": dense_init(ks[3], (*lead, H, hd, d))}
    if cfg.qk_norm:
        p["q_norm"] = _zeros(gen, (*lead, hd))
        p["k_norm"] = _zeros(gen, (*lead, hd))
    return p


def attn_forward(p, x, cfg: ModelConfig, *, positions, window,
                 theta, cache=None, cache_index=None, use_flash=False,
                 ring=False):
    """Self-attention. x: (B, S, d).

    window: 0 (global) / static int (banded local) / 0-d tensor.
    cache: None (train/prefill-no-cache) or dict(k, v, (B,Hkv,Smax,hd)),
    written in place.
    cache_index: write offset for decode; None -> prefill writes 0..S.
    ring: cache is a window-sized ring buffer (slot = position % W); only
    valid with a static local window.
    Returns (out, new_cache).
    """
    B, S, d = x.shape
    H, Hkv = cfg.padded_heads, cfg.padded_kv
    G = H // Hkv
    cdt = x.dtype
    q = constrain(project_heads(x, p["wq"].to(cdt)), "heads")
    k = constrain(project_heads(x, p["wk"].to(cdt)), "heads")
    v = constrain(project_heads(x, p["wv"].to(cdt)), "heads")
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    q = rope(q, positions, theta)
    k = rope(k, positions, theta)
    q = q.transpose(1, 2)                            # (B, H, S, hd)
    k = k.transpose(1, 2)                            # (B, Hkv, S, hd)
    v = v.transpose(1, 2)

    def expand(t):                                   # kv -> H heads
        return repeat_heads(t, G) if G > 1 else t

    softcap = cfg.softcap_attn
    fn = attend_flash if use_flash else attend_full
    new_cache = None
    if cache is not None and ring:
        W = cache["k"].shape[2]
        idx = 0 if cache_index is None else int(cache_index)
        if S > 1:
            if S >= W:
                # prefill: keep the last W tokens, rolled so slot == pos % W
                shift = (idx + S) % W
                cache["k"].copy_(torch.roll(k[:, :, -W:], shift, dims=2))
                cache["v"].copy_(torch.roll(v[:, :, -W:], shift, dims=2))
            else:        # short prefill: contiguous write (no wrap at idx=0)
                cache_write(cache["k"], k, idx % W, axis=2)
                cache_write(cache["v"], v, idx % W, axis=2)
            out = fn(q, expand(k), expand(v), q_positions=positions,
                     kv_positions=positions, window=window, softcap=softcap)
        else:
            slot = idx % W
            ck = cache_write(cache["k"], k, slot, axis=2)
            cv = cache_write(cache["v"], v, slot, axis=2)
            slots = torch.arange(W, device=x.device)
            delta = torch.remainder(idx - slots, W)      # age of each slot
            kv_pos = torch.where(delta <= idx, idx - delta, idx + 1)
            out = attend_full(q, expand(ck), expand(cv),
                              q_positions=positions,
                              kv_positions=kv_pos[None].expand(B, W),
                              window=window, softcap=softcap)
        new_cache = cache
    elif cache is not None:
        idx = 0 if cache_index is None else int(cache_index)
        ck = cache_write(cache["k"], k, idx, axis=2)
        cv = cache_write(cache["v"], v, idx, axis=2)
        new_cache = cache
        if S > 1:
            # prefill: the cache was written starting at idx (== 0 for a
            # fresh cache), so attention over it equals attention over the
            # freshly-projected local k/v.
            out = fn(q, expand(k), expand(v), q_positions=positions,
                     kv_positions=positions, window=window, softcap=softcap)
        else:
            L = ck.shape[2]
            kv_positions = torch.arange(L, device=x.device)[None].expand(B, L)
            # the unclamped index, as the reference's kv_len
            kv_len = torch.full((B,), idx + S, dtype=torch.int64,
                                device=x.device)
            out = attend_full(q, expand(ck), expand(cv),
                              q_positions=positions,
                              kv_positions=kv_positions, window=window,
                              softcap=softcap, kv_len=kv_len)
    else:
        out = fn(q, expand(k), expand(v), q_positions=positions,
                 kv_positions=positions, window=window, softcap=softcap)
    out = _mask_heads(out.transpose(1, 2), cfg)      # (B, S, H, hd)
    out = torch.einsum("bshk,hkd->bsd", out, p["wo"].to(cdt))
    return out, new_cache


# --------------------------------------------------------------------------
# MLA (DeepSeek multi-head latent attention)
# --------------------------------------------------------------------------

def make_mla_params(gen, cfg: ModelConfig, lead=()):
    d, H = cfg.d_model, cfg.n_heads
    dn, dr, dv, dl = cfg.head_dim, cfg.rope_dim, cfg.v_head_dim, cfg.kv_lora
    ks = split_keys(gen, 6)
    return {
        "w_dkv": dense_init(ks[0], (*lead, d, dl)),       # down-proj to latent
        "w_kr": dense_init(ks[1], (*lead, d, dr)),        # shared rope key
        "w_uk": dense_init(ks[2], (*lead, dl, H, dn)),    # latent -> key(nope)
        "w_uv": dense_init(ks[3], (*lead, dl, H, dv)),    # latent -> value
        "w_q": dense_init(ks[4], (*lead, d, H, dn + dr)),  # query
        "wo": dense_init(ks[5], (*lead, H, dv, d)),
    }


def mla_forward(p, x, cfg: ModelConfig, *, positions, theta,
                cache=None, cache_index=None, use_flash=False):
    """MLA. Cache holds the compressed latent (c_kv, k_rope) only.

    * decode (S==1): the *absorbed* form — q projected into latent space, so
      per-step compute/cache scale with kv_lora, not H*head_dim.
    * train / prefill: the *folded* form — k = [k_nope | k_rope broadcast]
      so the score is one dot product and the standard (flash) attention
      applies.  Prefill still writes only the compressed cache.
    """
    B, S, d = x.shape
    H, dn, dr = cfg.n_heads, cfg.head_dim, cfg.rope_dim
    cdt = x.dtype
    q = project_heads(x, p["w_q"].to(cdt))
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = rope(q_rope, positions, theta)
    c_kv = torch.einsum("bsd,dl->bsl", x, p["w_dkv"].to(cdt))
    k_rope = rope(torch.einsum("bsd,dr->bsr", x,
                               p["w_kr"].to(cdt))[:, :, None, :],
                  positions, theta)[:, :, 0, :]

    new_cache = None
    idx = 0 if cache_index is None else int(cache_index)
    if cache is not None:
        c_all = cache_write(cache["c_kv"], c_kv, idx, axis=1)
        r_all = cache_write(cache["k_rope"], k_rope, idx, axis=1)
        new_cache = cache

    if cache is not None and S == 1:
        Skv = c_all.shape[1]
        kv_len = idx + S
        # absorbed: q_nope -> latent space
        q_lat = torch.einsum("bshk,lhk->bshl", q_nope, p["w_uk"].to(cdt))
        s = (torch.einsum("bshl,btl->bhst", q_lat.float(), c_all.float())
             + torch.einsum("bshr,btr->bhst", q_rope.float(),
                            r_all.float()))
        s = s / math.sqrt(dn + dr)
        kp = torch.arange(Skv, device=x.device)[None, None, None, :]
        qp = positions[:, None, :, None]
        s = torch.where((kp <= qp) & (kp < kv_len), s, NEG_INF)
        pr = torch.softmax(s, dim=-1)
        o_lat = torch.einsum("bhst,btl->bshl", pr, c_all.float()).to(cdt)
        out = torch.einsum("bshl,lhv->bshv", o_lat, p["w_uv"].to(cdt))
    else:
        # folded: concat nope+rope into one head_dim, standard attention.
        k_nope = torch.einsum("bsl,lhk->bshk", c_kv, p["w_uk"].to(cdt))
        vv = torch.einsum("bsl,lhv->bshv", c_kv, p["w_uv"].to(cdt))
        k_fold = torch.cat(
            [k_nope, k_rope[:, :, None, :].expand(B, S, H, dr)], dim=-1)
        q_fold = torch.cat([q_nope, q_rope], dim=-1)
        # MLA scales by sqrt(dn+dr); attend_* scale by sqrt(head_dim)=same.
        fn = attend_flash if use_flash else attend_full
        out = fn(q_fold.transpose(1, 2), k_fold.transpose(1, 2),
                 vv.transpose(1, 2), q_positions=positions,
                 kv_positions=positions, window=0)
        out = out.transpose(1, 2)                        # (B, S, H, dv)
    return torch.einsum("bshv,hvd->bsd", out, p["wo"].to(cdt)), new_cache


# --------------------------------------------------------------------------
# MLPs
# --------------------------------------------------------------------------

def _gelu(x):
    return TF.gelu(x, approximate="tanh")


def make_mlp_params(gen, d, dff, kind, lead=()):
    ks = split_keys(gen, 3)
    if kind in ("swiglu", "geglu"):
        return {"w_gate": dense_init(ks[0], (*lead, d, dff)),
                "w_up": dense_init(ks[1], (*lead, d, dff)),
                "w_down": dense_init(ks[2], (*lead, dff, d))}
    return {"w_up": dense_init(ks[0], (*lead, d, dff)),
            "w_down": dense_init(ks[1], (*lead, dff, d))}


def mlp_forward(p, x, kind):
    cdt = x.dtype
    if kind in ("swiglu", "geglu"):
        act = TF.silu if kind == "swiglu" else _gelu
        h = act(x @ p["w_gate"].to(cdt)) * (x @ p["w_up"].to(cdt))
    else:
        h = _gelu(x @ p["w_up"].to(cdt))
    return h @ p["w_down"].to(cdt)


# --------------------------------------------------------------------------
# MoE (sorted capacity dispatch + per-expert block einsum)
# --------------------------------------------------------------------------

def make_moe_params(gen, cfg: ModelConfig, lead=()):
    d, E, dff = cfg.d_model, cfg.n_experts, cfg.expert_dff
    ks = split_keys(gen, 5)
    p = {"w_gate_router": dense_init(ks[0], (*lead, d, E)),
         "w1": dense_init(ks[1], (*lead, E, d, dff)),     # gate proj
         "w2": dense_init(ks[2], (*lead, E, d, dff)),     # up proj
         "w3": dense_init(ks[3], (*lead, E, dff, d))}     # down proj
    if cfg.n_shared:
        p["shared"] = make_mlp_params(ks[4], d, cfg.n_shared * dff, cfg.mlp,
                                      lead)
    return p


def _moe_group(xt, p, cfg: ModelConfig, cap: int):
    """Dispatch + expert compute for one group of tokens. xt: (Tg, d)."""
    Tg, d = xt.shape
    E, K = cfg.n_experts, cfg.top_k
    cdt, dev = xt.dtype, xt.device
    logits = (xt @ p["w_gate_router"].to(cdt)).float()
    probs = torch.softmax(logits, dim=-1)
    # lax.top_k breaks ties toward the lower index and torch.topk does not
    # promise an order; float32 router probabilities from random weights
    # do not tie, so both pick the same experts in the same order.
    topw, topi = torch.topk(probs, K, dim=-1)         # (Tg, K)
    if cfg.renorm_topk:
        topw = topw / torch.sum(topw, dim=-1, keepdim=True)

    flat_e = topi.reshape(-1)                         # (Tg*K,)
    flat_t = torch.arange(Tg, device=dev).repeat_interleave(K)
    flat_w = topw.reshape(-1)
    order = torch.argsort(flat_e, stable=True)        # as jnp.argsort
    se, st, sw = flat_e[order], flat_t[order], flat_w[order]
    # bincount's integers, at a static shape (``torch.bincount`` has no
    # meta kernel, and the dry-run traces this on meta tensors)
    counts = torch.zeros(E, dtype=se.dtype, device=dev).scatter_add_(
        0, se, torch.ones_like(se))
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(Tg * K, device=dev) - starts[se]
    keep = pos < cap
    slot = torch.where(keep, se * cap + pos, E * cap)  # overflow -> scratch

    # kept slots are distinct; every overflow row lands in the scratch row,
    # which is discarded, so the order of its duplicate writes is moot
    buf = torch.zeros((E * cap + 1, d), dtype=cdt, device=dev)
    buf.index_put_((slot,), xt[st] * keep[:, None].to(cdt))
    eb = buf[:E * cap].reshape(E, cap, d)
    if cfg.mlp in ("swiglu", "geglu"):
        act = TF.silu if cfg.mlp == "swiglu" else _gelu
        h = act(torch.einsum("ecd,edf->ecf", eb, p["w1"].to(cdt))) * \
            torch.einsum("ecd,edf->ecf", eb, p["w2"].to(cdt))
    else:
        h = _gelu(torch.einsum("ecd,edf->ecf", eb, p["w1"].to(cdt)))
    eo = torch.einsum("ecf,efd->ecd", h, p["w3"].to(cdt))
    gathered = eo.reshape(E * cap, d)[torch.clamp(slot, max=E * cap - 1)]
    contrib = gathered * (sw * keep).to(cdt)[:, None]
    return torch.zeros((Tg, d), dtype=cdt, device=dev).index_add_(
        0, st, contrib)


def _moe_groups(T, cfg: ModelConfig):
    """(dispatch groups, tokens a group, an expert's capacity a group) of
    ``T`` tokens."""
    G = cfg.moe_groups if T % cfg.moe_groups == 0 else 1
    Tg = T // G
    cap = int(min(Tg, max(8, round(Tg * cfg.top_k / cfg.n_experts
                                   * cfg.capacity_factor))))
    return G, Tg, cap


def moe_forward(p, x, cfg: ModelConfig):
    """Token-choice top-k MoE with capacity; sorted dispatch.

    Tokens are split into ``cfg.moe_groups`` dispatch groups, each
    dispatched on its own, as the reference's vmap over groups.  On a
    ``DTensor`` each rank dispatches its own groups (``_moe_forward_mesh``),
    as GSPMD keeps the reference's vmapped sort and scatter shard-local."""
    if is_dtensor(x):
        return _moe_forward_mesh(p, x, cfg)
    B, S, d = x.shape
    G, Tg, cap = _moe_groups(B * S, cfg)
    xg = x.reshape(G, Tg, d)
    out = torch.stack([_moe_group(xg[g], p, cfg, cap) for g in range(G)])
    out = out.reshape(B, S, d)
    if cfg.n_shared:
        out = out + mlp_forward(p["shared"], x, cfg.mlp)
    return out


def _moe_forward_mesh(p, x, cfg: ModelConfig):
    """TP-MoE on a ``DTensor``: each rank runs its own dispatch groups
    (the batch split over the DP axes when the groups fall whole in a
    rank's rows, else every group on every rank) through ``_moe_group``
    on its block of the experts' d_ff (``w1``/``w2`` on their last dim,
    ``w3`` on -2, as ``param_specs`` places them), so the ``w3`` product
    is a partial sum over ``model``, reduced once (the "wFFT" of MoE).
    The expert count, ``argsort`` and the index scatters have no DTensor
    strategy: they run on the local blocks, as the reference's do under
    its vmap."""
    from torch.distributed.tensor import DTensor, Partial
    mesh = x.device_mesh
    sizes = axis_sizes(mesh)
    n_model = sizes["model"]
    B, S, d = x.shape
    G, Tg, cap = _moe_groups(B * S, cfg)
    dp = dp_axes(mesh)
    dp_size = 1
    for a in dp:
        dp_size *= sizes[a]
    b_ax = dp if B % dp_size == 0 and G % dp_size == 0 else None
    f_ax = "model" if cfg.expert_dff % n_model == 0 else None
    pl = {"w_gate_router": P(), "w1": P(None, None, f_ax),
          "w2": P(None, None, f_ax), "w3": P(None, f_ax, None)}
    # ranks along the DP axes hold other tokens, and along "model" other
    # d_ff columns: a replicated block's gradient is a partial sum there
    partial = (dp if b_ax else ()) + (("model",) if f_ax else ())
    p_loc = {k: local_of(p[k], mesh, s, partial) for k, s in pl.items()}
    x_spec = P(b_ax, None, None)
    x_loc = local_of(x, mesh, x_spec, partial)
    g_loc = G // dp_size if b_ax else G
    xg = x_loc.reshape(g_loc, Tg, d)
    out = torch.stack([_moe_group(xg[g], p_loc, cfg, cap)
                       for g in range(g_loc)]).reshape(x_loc.shape)
    places = list(placements(x_spec, mesh, 3))
    if f_ax and n_model > 1:
        places[mesh.mesh_dim_names.index("model")] = Partial()
    out = DTensor.from_local(out, mesh, places, run_check=False,
                             shape=x.shape, stride=x.stride())
    out = out.redistribute(mesh, placements(x_spec, mesh, 3))
    if cfg.n_shared:
        out = out + mlp_forward(p["shared"], x, cfg.mlp)
    return out


# --------------------------------------------------------------------------
# Mamba2 (SSD, chunked) + single-step decode
# --------------------------------------------------------------------------

def make_mamba_params(gen, cfg: ModelConfig, lead=()):
    d, di, N, H = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    ks = split_keys(gen, 9)
    return {
        "w_z": dense_init(ks[0], (*lead, d, di)),
        "w_x": dense_init(ks[1], (*lead, d, di)),
        "w_B": dense_init(ks[2], (*lead, d, N)),
        "w_C": dense_init(ks[3], (*lead, d, N)),
        "w_dt": dense_init(ks[4], (*lead, d, H)),
        "dt_bias": _zeros(gen, (*lead, H)),
        "A_log": _zeros(gen, (*lead, H)),
        "D": _ones(gen, (*lead, H)),
        "conv_x": dense_init(ks[5], (*lead, cfg.conv_width, di), 0.2),
        "conv_B": dense_init(ks[6], (*lead, cfg.conv_width, N), 0.2),
        "conv_C": dense_init(ks[7], (*lead, cfg.conv_width, N), 0.2),
        "out_norm": _zeros(gen, (*lead, di)),
        "w_out": dense_init(ks[8], (*lead, di, d)),
    }


def _causal_conv1d(x, w, state=None):
    """Depthwise causal conv. x: (B, S, C); w: (W, C).
    state: (B, W-1, C) carry for decode. Returns (y, new_state)."""
    W = w.shape[0]
    if state is None:
        # zeros before the input (not ``TF.pad``: on a DTensor, torch
        # 2.11's pad gives a layout of one mesh dim on a 2-d mesh)
        state = torch.zeros((x.shape[0], W - 1, x.shape[2]), dtype=x.dtype,
                            device=x.device)
    xp = torch.cat([state.to(x.dtype), x], dim=1)
    y = sum(xp[:, i:i + x.shape[1], :] * w[i].to(x.dtype)
            for i in range(W))
    new_state = xp[:, -(W - 1):, :] if W > 1 else None
    return y, new_state


def ssd_chunked(xh, dt, A, Bm, Cm, *, chunk):
    """Mamba2 SSD, chunked linear-time scan.

    xh: (B, S, H, P) head inputs; dt: (B, S, H) softplus'd step sizes;
    A: (H,) negative decay rates; Bm/Cm: (B, S, N) (single group).
    Returns y: (B, S, H, P) and final state (B, H, P, N).
    """
    Bsz, S, H, Pd = xh.shape
    N = Bm.shape[-1]
    nc = S // chunk
    xc = xh.reshape(Bsz, nc, chunk, H, Pd).float()
    dtc = dt.reshape(Bsz, nc, chunk, H).float()
    Bc = Bm.reshape(Bsz, nc, chunk, N).float()
    Cc = Cm.reshape(Bsz, nc, chunk, N).float()

    dA = dtc * A[None, None, None, :]                 # (B, nc, Q, H) <= 0
    # inclusive cumsum, on each rank's block on a mesh: its backward flips,
    # and torch 2.11's DTensor has no strategy for flip
    dAcs = on_blocks(lambda t: torch.cumsum(t, dim=2), dA, (2,))
    # intra-chunk: L[i,j] = exp(dAcs_i - dAcs_j) for i >= j.  The mask
    # goes on before the exponential: above the diagonal the difference is
    # a positive sum that overflows exp at a long chunk, and where(mask,
    # exp, 0)'s backward would multiply that inf by a zero cotangent (NaN).
    # exp(-inf) = 0 keeps the forward's values bit for bit.
    Ldec = dAcs[:, :, :, None, :] - dAcs[:, :, None, :, :]   # (B,nc,Q,Q,H)
    tril = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=xh.device))
    Ldec = torch.exp(Ldec.masked_fill(~tril[None, None, :, :, None],
                                      -math.inf))
    scores = torch.einsum("bcin,bcjn->bcij", Cc, Bc)  # (B,nc,Q,Q)
    w = scores[..., None] * Ldec * dtc[:, :, None, :, :]     # (B,nc,Q,Q,H)
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", w, xc)

    # chunk summary state: S_c = sum_j exp(dAcs_Q - dAcs_j) dt_j B_j x_j
    decay_to_end = torch.exp(dAcs[:, :, -1:, :] - dAcs)      # (B,nc,Q,H)
    Sc = torch.einsum("bcjh,bcjn,bcjhp->bchpn",
                      decay_to_end * dtc, Bc, xc)             # (B,nc,H,P,N)
    # inter-chunk recurrence over c; keep the state BEFORE each chunk
    chunk_decay = torch.exp(dAcs[:, :, -1, :])                # (B,nc,H)
    h = torch.zeros((Bsz, H, Pd, N), dtype=torch.float32, device=xh.device)
    h_prev = []
    for c in range(nc):
        h_prev.append(h)
        h = h * chunk_decay[:, c, :, None, None] + Sc[:, c]
    h_prev = torch.stack(h_prev, dim=1)                       # (B,nc,H,P,N)
    y_inter = torch.einsum("bcin,bchpn,bcih->bcihp",
                           Cc, h_prev, torch.exp(dAcs))
    y = (y_intra + y_inter).reshape(Bsz, S, H, Pd)
    return y.to(xh.dtype), h


_X_ROLES = {"b": 0, "h": 2, "p": 3}          # (B, S, H, P)
_STATE_ROLES = {"b": 0, "h": 1, "p": 2}      # (B, H, P, N)


def _ssm_steps(xh, dt, A, Bm, Cm, h):
    """The stepwise recurrence (decode) over the S new tokens (usually 1)
    from state ``h``: h' = h * exp(dt A) + dt B (x) x ; y = C . h'.
    Returns (y (B, S, H, P) float32, the last state)."""
    ys = []
    for t in range(xh.shape[1]):
        x_t, dt_t = xh[:, t].float(), dt[:, t]        # (B,H,P), (B,H)
        B_t, C_t = Bm[:, t].float(), Cm[:, t].float()  # (B,N)
        dec = torch.exp(dt_t * A[None, :])            # (B,H)
        upd = torch.einsum("bh,bn,bhp->bhpn", dt_t, B_t, x_t)
        h = h * dec[..., None, None] + upd
        ys.append(torch.einsum("bn,bhpn->bhp", C_t, h))
    return torch.stack(ys, dim=1), h


def mamba_forward(p, x, cfg: ModelConfig, *, state=None):
    """Mamba2 mixer. x: (B, S, d).
    state: None (train) or dict(ssm (B,H,P,N) f32, conv_x/conv_B/conv_C).
    Decode path (S small) updates state stepwise.  Returns the new state
    as new tensors; the caller stores them."""
    B, S, d = x.shape
    di, H, Pd = cfg.d_inner, cfg.ssm_heads, cfg.ssm_head_dim
    cdt = x.dtype
    z = x @ p["w_z"].to(cdt)
    xi = x @ p["w_x"].to(cdt)
    Bm = x @ p["w_B"].to(cdt)
    Cm = x @ p["w_C"].to(cdt)
    dt_raw = (x @ p["w_dt"].to(cdt)).float() + p["dt_bias"]
    dt = TF.softplus(dt_raw)                          # (B, S, H)
    A = -torch.exp(p["A_log"])                        # (H,)

    cs = {} if state is None else state
    xi, cx = _causal_conv1d(xi, p["conv_x"], cs.get("conv_x"))
    Bm, cB = _causal_conv1d(Bm, p["conv_B"], cs.get("conv_B"))
    Cm, cC = _causal_conv1d(Cm, p["conv_C"], cs.get("conv_C"))
    xi, Bm, Cm = TF.silu(xi), TF.silu(Bm), TF.silu(Cm)
    xh = split_heads(xi, H)                           # (B, S, H, Pd)

    # every (batch, head, channel) runs apart: on a mesh, on each rank's
    # block of them (``on_local_blocks``)
    roles = (_X_ROLES, {"b": 0, "h": 2}, {"h": 0}, {"b": 0}, {"b": 0})
    if state is None or S >= 8:
        # train, or prefill: chunked SSD from zero state, the final state
        # carried out
        y, hT = on_local_blocks(
            functools.partial(ssd_chunked, chunk=_pick_block(
                S, cfg.ssm_chunk)), (xh, dt, A, Bm, Cm), roles,
            (_X_ROLES, _STATE_ROLES))
    else:
        y, hT = on_local_blocks(_ssm_steps, (xh, dt, A, Bm, Cm, cs["ssm"]),
                                roles + (_STATE_ROLES,),
                                (_X_ROLES, _STATE_ROLES))
        y = y.to(cdt)
    new_state = None if state is None else {
        "ssm": hT, "conv_x": cx, "conv_B": cB, "conv_C": cC}

    y = y + xh * p["D"].to(cdt)[None, None, :, None]
    y = merge_heads(y)                                # (B, S, di)
    y = rms_norm(y * TF.silu(z), p["out_norm"])
    return y @ p["w_out"].to(cdt), new_state


def init_mamba_state(cfg: ModelConfig, batch, dtype=torch.float32,
                     device=None):
    """A mamba2 block's decode state on ``device`` (default: the GPU, as
    ``repro_torch.device.resolve_device``)."""
    device = resolve_device(device)
    W = cfg.conv_width
    return {
        "ssm": torch.zeros((batch, cfg.ssm_heads, cfg.ssm_head_dim,
                            cfg.ssm_state), dtype=torch.float32,
                           device=device),
        "conv_x": torch.zeros((batch, W - 1, cfg.d_inner), dtype=dtype,
                              device=device),
        "conv_B": torch.zeros((batch, W - 1, cfg.ssm_state), dtype=dtype,
                              device=device),
        "conv_C": torch.zeros((batch, W - 1, cfg.ssm_state), dtype=dtype,
                              device=device),
    }
