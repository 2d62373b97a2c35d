"""The port's LM mixers against the JAX package's, on the same numpy
inputs and the reference's weights carried across
(``repro_torch.convert.lm_params_from_jax``), in float32, within 1e-4 of
the reference's largest |value|: the MLPs, the MoE (one and two dispatch
groups, with and without overflow), the SSD scan and the mamba2 mixer
(prefill and decode), the whisper encoder, teacher-forced decoder and
decode step; the clamped cache write and read against ``jax.lax``'s
dynamic slices; and the converter's checks.  The attention is in
``test_torch_lm_layers.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro.models import whisper as JWH
from repro_torch import convert
from repro_torch.models import layers as TL
from repro_torch.models import whisper as TWH

import torch_lm_common as C

KEY = jax.random.PRNGKey(7)
GEN = torch.Generator().manual_seed(0)


def _np(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _both(jfn, tfn, jcfg, tcfg):
    """Reference params of ``jfn`` and the port's carried copy."""
    jp = jfn(KEY, jcfg)
    return jp, C.carry(jp, like=tfn(GEN, tcfg))


# --------------------------------------------------------------------------
# MLP and MoE
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["swiglu", "geglu", "gelu"])
def test_mlp_forward_matches(kind):
    jp = JL.make_mlp_params(KEY, 16, 24, kind)
    tp = C.carry(jp, like=TL.make_mlp_params(GEN, 16, 24, kind))
    x = _np((2, 5, 16))
    C.assert_close(TL.mlp_forward(tp, torch.tensor(x), kind),
                   JL.mlp_forward(jp, jnp.asarray(x), kind))


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "deepseek-v2-lite-16b"])
@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("capacity_factor", [1.25, 0.3])    # 0.3 overflows
def test_moe_forward_matches(arch, groups, capacity_factor):
    jcfg, tcfg = C.configs(arch, moe_groups=groups,
                           capacity_factor=capacity_factor)
    jp, tp = _both(JL.make_moe_params, TL.make_moe_params, jcfg, tcfg)
    x = _np((2, 24, jcfg.d_model))
    C.assert_close(TL.moe_forward(tp, torch.tensor(x), tcfg),
                   JL.moe_forward(jp, jnp.asarray(x), jcfg))


# --------------------------------------------------------------------------
# Mamba2
# --------------------------------------------------------------------------

@pytest.mark.parametrize("S,chunk", [(16, 4), (24, 8), (8, 8)])
def test_ssd_chunked_matches(S, chunk):
    rng = np.random.default_rng(0)
    Bsz, H, P, N = 2, 3, 4, 5
    xh = rng.standard_normal((Bsz, S, H, P)).astype(np.float32)
    dt = rng.uniform(0.01, 0.5, (Bsz, S, H)).astype(np.float32)
    A = -rng.uniform(0.1, 1.0, (H,)).astype(np.float32)
    Bm = rng.standard_normal((Bsz, S, N)).astype(np.float32)
    Cm = rng.standard_normal((Bsz, S, N)).astype(np.float32)
    y, h = TL.ssd_chunked(*map(torch.tensor, (xh, dt, A, Bm, Cm)),
                          chunk=chunk)
    y0, h0 = JL.ssd_chunked(*map(jnp.asarray, (xh, dt, A, Bm, Cm)),
                            chunk=chunk)
    C.assert_close(y, y0, what="y")
    C.assert_close(h, h0, what="state")


@pytest.mark.parametrize("mode", ["train", "prefill_decode"])
def test_mamba_forward_matches(mode):
    jcfg, tcfg = C.configs("mamba2-2.7b")
    jp, tp = _both(JL.make_mamba_params, TL.make_mamba_params, jcfg, tcfg)
    B, S, S0 = 2, 12, 8
    x = _np((B, S, jcfg.d_model))
    if mode == "train":
        want, _ = JL.mamba_forward(jp, jnp.asarray(x), jcfg)
        got, _ = TL.mamba_forward(tp, torch.tensor(x), tcfg)
        C.assert_close(got, want)
        return
    js = JL.init_mamba_state(jcfg, B)
    ts = TL.init_mamba_state(tcfg, B, device="cpu")
    for t0, t1 in [(0, S0)] + [(t, t + 1) for t in range(S0, S)]:
        want, js = JL.mamba_forward(jp, jnp.asarray(x[:, t0:t1]), jcfg,
                                    state=js)
        got, ts = TL.mamba_forward(tp, torch.tensor(x[:, t0:t1]), tcfg,
                                   state=ts)
        C.assert_close(got, want, what=f"tokens {t0}:{t1}")
        C.assert_trees_close(ts, js, what=f"state after {t1} ")


# --------------------------------------------------------------------------
# whisper
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def whisper():
    jcfg, tcfg = C.configs("whisper-small")
    jp = JWH.init_whisper_params(jcfg, KEY)
    rng = np.random.default_rng(2)
    frames = rng.standard_normal((2, 24, jcfg.d_model)).astype(np.float32)
    toks = rng.integers(0, jcfg.vocab, (2, 6))
    return jcfg, tcfg, jp, C.carry(jp, tcfg), frames, toks


def test_whisper_encode_and_decode_train_match(whisper):
    jcfg, tcfg, jp, tp, frames, toks = whisper
    jenc = JWH.encode(jp, jcfg, jnp.asarray(frames))
    tenc = TWH.encode(tp, tcfg, torch.tensor(frames))
    C.assert_close(tenc, jenc, what="encode")
    C.assert_close(TWH.decode_train(tp, tcfg, tenc, torch.tensor(toks)),
                   JWH.decode_train(jp, jcfg, jenc, jnp.asarray(toks)),
                   what="decode_train")


def test_whisper_decode_step_matches(whisper):
    jcfg, tcfg, jp, tp, frames, toks = whisper
    jenc = JWH.encode(jp, jcfg, jnp.asarray(frames))
    tenc = TWH.encode(tp, tcfg, torch.tensor(frames))
    jc = JWH.prefill_cross(jp, jcfg, jenc, JWH.init_dec_cache(jcfg, 2, 24))
    tc = TWH.prefill_cross(tp, tcfg, tenc,
                           TWH.init_dec_cache(tcfg, 2, 24, device="cpu"))
    # the last position is past max_dec_len (32): both clamp
    for i in (0, 1, 2, 40):
        want, jc = JWH.decode_step(jp, jcfg, jnp.asarray(toks[:, :1]),
                                   jnp.int32(i), jc)
        got, tc = TWH.decode_step(tp, tcfg, torch.tensor(toks[:, :1]), i,
                                  tc)
        C.assert_close(got, want, what=f"pos {i}")
    C.assert_trees_close(tc, jc)


# --------------------------------------------------------------------------
# the clamped cache write and read
# --------------------------------------------------------------------------

@pytest.mark.parametrize("start", [0, 3, 7, 8, 12, 600, -2])
@pytest.mark.parametrize("n", [1, 3])
def test_cache_write_clamps_as_dynamic_update_slice(start, n):
    buf, upd = _np((2, 3, 10, 4), 1), _np((2, 3, n, 4), 2)
    want = jax.lax.dynamic_update_slice_in_dim(
        jnp.asarray(buf), jnp.asarray(upd), start, axis=2)
    t = torch.tensor(buf)
    got = TL.cache_write(t, torch.tensor(upd), start, axis=2)
    assert got is t                                   # in place
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    read = jax.lax.dynamic_slice_in_dim(jnp.asarray(buf), start, n, axis=2)
    np.testing.assert_array_equal(
        TL.cache_slice(torch.tensor(buf), start, n, 2).numpy(),
        np.asarray(read))


# --------------------------------------------------------------------------
# the converter's checks
# --------------------------------------------------------------------------

def test_lm_params_from_jax_checks_the_tree():
    jcfg, tcfg = C.configs("qwen3-14b")
    from repro.models import lm as JLM
    from repro_torch.models import lm as TLM
    host = jax.tree.map(np.asarray, JLM.init_lm_params(jcfg, KEY))
    like = TLM.init_lm_params(tcfg, GEN)
    got = convert.lm_params_from_jax(host, like=like, device="cpu")
    assert C.flat_torch(got).keys() == C.flat_jax(host).keys()
    bad = dict(host, embed=host["embed"][:, :-1])
    with pytest.raises(ValueError, match="embed"):
        convert.lm_params_from_jax(bad, like=like, device="cpu")
    with pytest.raises(ValueError, match="keys differ"):
        convert.lm_params_from_jax(dict(host, extra=host["embed"]),
                                   like=like, device="cpu")
    with pytest.raises(ValueError, match="list"):
        convert.lm_params_from_jax(dict(host, layers=host["layers"] * 2),
                                   like=like, device="cpu")
    with pytest.raises(TypeError, match="float32"):
        convert.lm_params_from_jax(
            dict(host, embed=host["embed"].astype(np.float64)), like=like,
            device="cpu")
    # without ``like`` any tree of float32 leaves converts
    tree = convert.lm_params_from_jax({"a": [np.ones(3, np.float32)]},
                                      device="cpu")
    assert tree["a"][0].dtype == torch.float32
