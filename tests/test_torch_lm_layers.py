"""The port's LM attention against the JAX package's, on the same numpy
inputs and the reference's weights carried across
(``repro_torch.convert.lm_params_from_jax``), in float32, within 1e-4 of
the reference's largest |value|: RoPE, both attentions (full and the
blocked online softmax, over window x softcap x causal, the window static
or a 0-d tensor), the GQA layer with and without a cache and with the
ring cache, and MLA with and without its latent cache.  The MLPs, MoE,
mamba2, whisper and the cache helpers are in ``test_torch_lm_mixers.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.models import layers as TL

import torch_lm_common as C

KEY = jax.random.PRNGKey(7)
GEN = torch.Generator().manual_seed(0)


def _np(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _pos(B, S, start=0):
    return np.broadcast_to(start + np.arange(S)[None], (B, S))


def _both(jfn, tfn, jcfg, tcfg):
    """Reference params of ``jfn`` and the port's carried copy."""
    jp = jfn(KEY, jcfg)
    return jp, C.carry(jp, like=tfn(GEN, tcfg))


# --------------------------------------------------------------------------
# RoPE and attention
# --------------------------------------------------------------------------

@pytest.mark.parametrize("theta", [1e4, 1e6, 999999.0])
@pytest.mark.parametrize("start", [0, 1000])
def test_rope_matches(theta, start):
    x = _np((2, 5, 3, 16))
    pos = _pos(2, 5, start)
    C.assert_close(TL.rope(torch.tensor(x), torch.tensor(pos), theta),
                   JL.rope(jnp.asarray(x), jnp.asarray(pos), theta))


ATTN_CASES = [(0, 0.0, True), (6, 0.0, True), (0, 30.0, True),
              (0, 0.0, False), (4, 20.0, True), ("tensor6", 0.0, True),
              ("huge", 0.0, True)]


def _window(w, lib):
    """A static window, or a 0-d one (the reference's traced window)."""
    if isinstance(w, int):
        return w
    v = 6 if w == "tensor6" else 1 << 30
    return jnp.int32(v) if lib == "jax" else torch.tensor(v)


@pytest.mark.parametrize("window,softcap,causal", ATTN_CASES)
@pytest.mark.parametrize("kind", ["full", "flash"])
def test_attend_matches(kind, window, softcap, causal):
    B, H, S, hd = 2, 3, 32, 8
    q, k, v = (_np((B, H, S, hd), s) for s in (1, 2, 3))
    pos = _pos(B, S)
    kw = dict(softcap=softcap, causal=causal)
    if kind == "flash":
        kw.update(q_block=8, kv_block=8)
    jfn = JL.attend_full if kind == "full" else JL.attend_flash
    tfn = TL.attend_full if kind == "full" else TL.attend_flash
    want = jfn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
               q_positions=jnp.asarray(pos), kv_positions=jnp.asarray(pos),
               window=_window(window, "jax"), **kw)
    got = tfn(torch.tensor(q), torch.tensor(k), torch.tensor(v),
              q_positions=torch.tensor(pos), kv_positions=torch.tensor(pos),
              window=_window(window, "torch"), **kw)
    C.assert_close(got, want)


def test_attend_full_kv_len_matches():
    B, H, L, hd = 2, 3, 16, 8
    q, k, v = _np((B, H, 1, hd), 1), _np((B, H, L, hd), 2), \
        _np((B, H, L, hd), 3)
    qp, kp = _pos(B, 1, 9), _pos(B, L)
    kv_len = np.full((B,), 10)
    want = JL.attend_full(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          q_positions=jnp.asarray(qp),
                          kv_positions=jnp.asarray(kp),
                          kv_len=jnp.asarray(kv_len, jnp.int32))
    got = TL.attend_full(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                         q_positions=torch.tensor(qp),
                         kv_positions=torch.tensor(kp),
                         kv_len=torch.tensor(kv_len))
    C.assert_close(got, want)


# --------------------------------------------------------------------------
# the GQA layer: no cache, cache (prefill + decode), ring
# --------------------------------------------------------------------------

def _attn_run(lib, p, cfg, x, *, window, theta, mode, flash, S0=None):
    """Prefill ``x[:, :S0]`` then decode the rest one token at a time
    (``mode`` "cache"/"ring"), or one call without a cache."""
    L = JL if lib == "jax" else TL
    arr = (lambda a: jnp.asarray(a)) if lib == "jax" else torch.tensor
    B, S, _ = x.shape
    if mode == "none":
        out, _ = L.attn_forward(p, arr(x), cfg, positions=arr(_pos(B, S)),
                                window=window, theta=theta, use_flash=flash)
        return [out], None
    W = cfg.window if mode == "ring" else S
    shape = (B, cfg.padded_kv, W, cfg.head_dim)
    cache = ({"k": jnp.zeros(shape), "v": jnp.zeros(shape)} if lib == "jax"
             else {"k": torch.zeros(shape), "v": torch.zeros(shape)})
    ring = mode == "ring"
    outs = []
    out, cache = L.attn_forward(p, arr(x[:, :S0]), cfg,
                                positions=arr(_pos(B, S0)), window=window,
                                theta=theta, cache=cache, cache_index=0,
                                use_flash=flash, ring=ring)
    outs.append(out)
    for t in range(S0, S):
        idx = jnp.int32(t) if lib == "jax" else t
        out, cache = L.attn_forward(p, arr(x[:, t:t + 1]), cfg,
                                    positions=arr(_pos(B, 1, t)),
                                    window=window, theta=theta, cache=cache,
                                    cache_index=idx, ring=ring)
        outs.append(out)
    return outs, cache


@pytest.mark.parametrize("arch,window,mode,S0", [
    ("qwen3-14b", 0, "none", None),          # qk-norm, padded heads
    ("gemma2-27b", 8, "none", None),         # softcap, banded window
    ("qwen3-14b", 0, "cache", 6),
    ("gemma2-27b", 8, "cache", 6),
    ("gemma2-27b", 8, "ring", 12),           # prefill longer than the ring
    ("gemma2-27b", 8, "ring", 4),            # short prefill, then wraps
])
@pytest.mark.parametrize("flash", [False, True])
def test_attn_forward_matches(arch, window, mode, S0, flash):
    jcfg, tcfg = C.configs(arch, ring_local_cache=mode == "ring")
    jp, tp = _both(JL.make_attn_params, TL.make_attn_params, jcfg, tcfg)
    x = _np((2, 14, jcfg.d_model))
    want, jcache = _attn_run("jax", jp, jcfg, x, window=window, theta=1e4,
                             mode=mode, flash=flash, S0=S0)
    got, tcache = _attn_run("torch", tp, tcfg, x, window=window, theta=1e4,
                            mode=mode, flash=flash, S0=S0)
    for i, (g, w) in enumerate(zip(got, want)):
        C.assert_close(g, w, what=f"step {i}")
    if jcache is not None:
        C.assert_trees_close(tcache, jcache)


@pytest.mark.parametrize("cached", [False, True])
def test_mla_forward_matches(cached):
    jcfg, tcfg = C.configs("deepseek-v2-lite-16b")
    jp, tp = _both(JL.make_mla_params, TL.make_mla_params, jcfg, tcfg)
    B, S, S0 = 2, 10, 7
    x = _np((B, S, jcfg.d_model))
    if not cached:
        want, _ = JL.mla_forward(jp, jnp.asarray(x), jcfg,
                                 positions=jnp.asarray(_pos(B, S)),
                                 theta=1e4)
        got, _ = TL.mla_forward(tp, torch.tensor(x), tcfg,
                                positions=torch.tensor(_pos(B, S)),
                                theta=1e4)
        C.assert_close(got, want)
        return
    shapes = {"c_kv": (B, S, jcfg.kv_lora), "k_rope": (B, S, jcfg.rope_dim)}
    jc = {k: jnp.zeros(s) for k, s in shapes.items()}
    tc = {k: torch.zeros(s) for k, s in shapes.items()}
    for t0, t1 in [(0, S0)] + [(t, t + 1) for t in range(S0, S)]:
        want, jc = JL.mla_forward(jp, jnp.asarray(x[:, t0:t1]), jcfg,
                                  positions=jnp.asarray(_pos(B, t1 - t0, t0)),
                                  theta=1e4, cache=jc,
                                  cache_index=jnp.int32(t0))
        got, tc = TL.mla_forward(tp, torch.tensor(x[:, t0:t1]), tcfg,
                                 positions=torch.tensor(_pos(B, t1 - t0, t0)),
                                 theta=1e4, cache=tc, cache_index=t0)
        C.assert_close(got, want, what=f"tokens {t0}:{t1}")
    C.assert_trees_close(tc, jc)
