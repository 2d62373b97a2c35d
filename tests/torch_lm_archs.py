"""The LM slice as a whole against the JAX package, one architecture at a
time: ``lm_forward``, ``lm_prefill`` and a greedy decode of three
``lm_decode_step``s (whisper: ``encode``, the prefill step and three
``decode_step``s), on the reference's weights carried across, in
float32.  The ``test_torch_lm_archs_*`` files run these checks over
their halves of the ten architectures (one file runs on one worker)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.models import lm as JLM
from repro.models import whisper as JWH
from repro.train import make_decode_step, make_prefill_step
from repro_torch.models import lm as TLM
from repro_torch.models import whisper as TWH
from repro_torch.train import step as tstep

import torch_lm_common as C

B, PROMPT, STEPS, FRAMES = 2, 8, 3, 24


@functools.lru_cache(maxsize=None)
def run(arch):
    """Both packages' outputs for ``arch``: a dict of (port, reference)
    pairs, computed once per process.  The JAX side runs one ``jax.jit``
    each of forward, prefill and decode (the decode's position traced)."""
    jcfg, tcfg = C.configs(arch)
    rng = np.random.default_rng(1)
    init = JWH.init_whisper_params if jcfg.encdec else JLM.init_lm_params
    jp = init(jcfg, jax.random.PRNGKey(0))
    tp = C.carry(jp, tcfg)
    toks = rng.integers(0, jcfg.vocab, (B, PROMPT))
    out = {}
    jdecode = jax.jit(make_decode_step(jcfg))
    tdecode = tstep.make_decode_step(tcfg)
    if jcfg.encdec:
        frames = rng.standard_normal((B, FRAMES, jcfg.d_model)).astype(
            np.float32)
        jenc = jax.jit(lambda p, f: JWH.encode(p, jcfg, f))(
            jp, jnp.asarray(frames))
        out["encode"] = (TWH.encode(tp, tcfg, torch.tensor(frames)), jenc)
        batch = {"frames": frames, "tokens": toks[:, :1]}
        jcache = JWH.init_dec_cache(jcfg, B, FRAMES)
        tcache = TWH.init_dec_cache(tcfg, B, FRAMES, device="cpu")
        pos = 1
    else:
        img = None
        if jcfg.frontend == "vision_stub":
            img = rng.standard_normal(
                (B, jcfg.n_frontend_tokens, jcfg.d_model)).astype(np.float32)
        jfwd = jax.jit(lambda p, t, i: JLM.lm_forward(p, jcfg, t,
                                                      img_embeds=i,
                                                      remat=False))
        out["forward"] = (
            TLM.lm_forward(tp, tcfg, torch.tensor(toks),
                           img_embeds=None if img is None
                           else torch.tensor(img)),
            jfwd(jp, jnp.asarray(toks, jnp.int32),
                 None if img is None else jnp.asarray(img)))
        batch = {"tokens": toks}
        meta = jcfg.n_meta_tokens
        pos = PROMPT + meta
        max_len = PROMPT + meta + STEPS + 4
        if img is not None:
            # the serve path's vision stub: the image tokens count in the
            # decode position though no image is passed, so at this cache
            # size every decode write clamps to the end
            pos += jcfg.n_frontend_tokens
            max_len = PROMPT + STEPS
        jcache = JLM.init_cache(jcfg, B, max_len)
        tcache = TLM.init_cache(tcfg, B, max_len, device="cpu")
    jlg, jcache = jax.jit(make_prefill_step(jcfg))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()}, jcache)
    tlg, tcache = tstep.make_prefill_step(tcfg)(
        tp, {k: torch.tensor(v) for k, v in batch.items()}, tcache)
    out["prefill"] = (tlg, jlg)
    tokens = [(torch.argmax(tlg[:, -1:], -1), jnp.argmax(jlg[:, -1:], -1))]
    for i in range(STEPS):
        tt, jt = tokens[-1]
        tlg, tcache = tdecode(tp, tt, pos + i, tcache)
        jlg, jcache = jdecode(jp, jt.astype(jnp.int32), jnp.int32(pos + i),
                              jcache)
        out[f"decode_{i}"] = (tlg, jlg)
        tokens.append((torch.argmax(tlg[:, -1:], -1),
                       jnp.argmax(jlg[:, -1:], -1)))
    out["cache"] = (tcache, jcache)
    out["tokens"] = (torch.cat([t for t, _ in tokens], 1),
                     np.concatenate([np.asarray(j) for _, j in tokens], 1))
    return out


def check_forward(arch):
    got, want = run(arch)["forward" if "forward" in run(arch) else "encode"]
    C.assert_close(got, want, what=f"{arch} forward")


def check_prefill(arch):
    got, want = run(arch)["prefill"]
    C.assert_close(got, want, what=f"{arch} prefill")


def check_decode(arch):
    for i in range(STEPS):
        got, want = run(arch)[f"decode_{i}"]
        C.assert_close(got, want, what=f"{arch} decode {i}")


def check_cache(arch):
    got, want = run(arch)["cache"]
    C.assert_trees_close(got, want, what=f"{arch} cache ")


def check_greedy_tokens(arch):
    got, want = run(arch)["tokens"]
    assert got.shape == (B, STEPS + 1)
    np.testing.assert_array_equal(got.numpy(), want)
