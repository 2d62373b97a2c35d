"""Twins of the JAX package's LM model and layer tests
(``tests/test_models.py`` and ``tests/test_layers_units.py``) on the port
alone, in the dtype and at the tolerance each reference test uses: the
forward's shapes and finiteness for all ten architectures, prefill plus
decode against the teacher-forced forward, head padding exactly equal to
the unpadded model, whisper's decode against teacher forcing; SSD against
the naive recurrence, mamba2 decode against its chunked path, the MoE
against a dense float64 reference and its dispatch groups, flash against
full attention, and RoPE's rotation and relativity.  (The training-step
test waits for the training slice, ROADMAP item 9b.)"""
import dataclasses

import numpy as np
import pytest
import torch

from conftest import HAVE_HYPOTHESIS, requires_hypothesis

if HAVE_HYPOTHESIS:
    from hypothesis import given, settings, strategies as st

from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.models import layers as L
from repro_torch.models import lm as LM
from repro_torch.models import whisper as WH

B, S = 2, 16


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    if cfg.encdec:
        return {
            "frames": torch.tensor(rng.standard_normal((B, 24, cfg.d_model)),
                                   dtype=torch.float32),
            "tokens": torch.tensor(rng.integers(0, cfg.vocab, (B, 8))),
        }
    out = {"tokens": torch.tensor(rng.integers(0, cfg.vocab, (B, S)))}
    if cfg.frontend == "vision_stub":
        out["img_embeds"] = torch.tensor(
            rng.standard_normal((B, cfg.n_frontend_tokens, cfg.d_model)),
            dtype=torch.float32)
    return out


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_forward_shapes_no_nan(arch):
    cfg = get_config(arch, smoke=True)
    batch = _batch(cfg)
    if cfg.encdec:
        p = WH.init_whisper_params(cfg, _gen())
        enc = WH.encode(p, cfg, batch["frames"])
        logits = WH.decode_train(p, cfg, enc, batch["tokens"])
        assert logits.shape == (B, 8, cfg.vocab)
    else:
        p = LM.init_lm_params(cfg, _gen())
        logits = LM.lm_forward(p, cfg, batch["tokens"],
                               img_embeds=batch.get("img_embeds"))
        extra = cfg.n_meta_tokens + (cfg.n_frontend_tokens
                                     if "img_embeds" in batch else 0)
        assert logits.shape == (B, S + extra, cfg.vocab)
    assert logits.dtype == torch.float32
    assert not bool(torch.isnan(logits).any())


@pytest.mark.parametrize("arch", ["qwen3-14b", "gemma2-27b", "hymba-1.5b",
                                  "mamba2-2.7b", "deepseek-v2-lite-16b"])
def test_prefill_decode_matches_forward(arch):
    """prefill(x[:p]) then decode steps must reproduce teacher-forced
    forward logits (cache correctness)."""
    cfg = get_config(arch, smoke=True)
    p = LM.init_lm_params(cfg, _gen())
    toks = torch.tensor(np.random.default_rng(1).integers(
        0, cfg.vocab, (B, 12)))
    full = LM.lm_forward(p, cfg, toks)                  # (B, S+meta, V)
    meta = cfg.n_meta_tokens
    cache = LM.init_cache(cfg, B, 12 + meta + 4, device="cpu")
    lg, cache, _ = LM.lm_prefill(p, cfg, toks[:, :8], cache, use_flash=False)
    np.testing.assert_allclose(lg[:, -1].numpy(), full[:, meta + 7].numpy(),
                               rtol=2e-2, atol=2e-2)
    pos = 8 + meta
    for i in range(2):
        lg, cache = LM.lm_decode_step(p, cfg, toks[:, 8 + i:9 + i], pos + i,
                                      cache)
        np.testing.assert_allclose(lg[:, 0].numpy(),
                                   full[:, meta + 8 + i].numpy(),
                                   rtol=2e-2, atol=2e-2)


def test_head_padding_exact():
    """Padded-head model must equal the unpadded model with embedded
    real weights (dead slots masked)."""
    cfg_pad = get_config("qwen3-14b", smoke=True)       # pad_heads=6
    cfg_ref = dataclasses.replace(cfg_pad, pad_heads=0)
    pp = LM.init_lm_params(cfg_pad, _gen(3))
    mask = L.head_mask(cfg_pad).bool()

    def fix(d):
        if isinstance(d, dict):
            out = {}
            for k, v in d.items():
                if k == "wq":
                    out[k] = v[..., mask, :]
                elif k == "wo":
                    out[k] = v[:, mask] if v.ndim == 4 else v[mask]
                else:
                    out[k] = fix(v)
            return out
        if isinstance(d, list):
            return [fix(x) for x in d]
        return d

    pr = fix(pp)
    toks = torch.randint(0, cfg_pad.vocab, (2, 16), generator=_gen(4))
    y_pad = LM.lm_forward(pp, cfg_pad, toks)
    y_ref = LM.lm_forward(pr, cfg_ref, toks)
    np.testing.assert_allclose(y_pad.numpy(), y_ref.numpy(), atol=1e-3)


def test_whisper_decode_matches_teacher_forcing():
    cfg = get_config("whisper-small", smoke=True)
    p = WH.init_whisper_params(cfg, _gen())
    rng = np.random.default_rng(2)
    frames = torch.tensor(rng.standard_normal((B, 24, cfg.d_model)),
                          dtype=torch.float32)
    toks = torch.tensor(rng.integers(0, cfg.vocab, (B, 6)))
    enc = WH.encode(p, cfg, frames)
    full = WH.decode_train(p, cfg, enc, toks)
    cache = WH.prefill_cross(p, cfg, enc,
                             WH.init_dec_cache(cfg, B, 24, device="cpu"))
    for i in range(4):
        lg, cache = WH.decode_step(p, cfg, toks[:, i:i + 1], i, cache)
        np.testing.assert_allclose(lg[:, 0].numpy(), full[:, i].numpy(),
                                   rtol=2e-2, atol=2e-2)


# --------------------------------------------------------------------------
# Mamba2 SSD: chunked algorithm vs naive recurrence
# --------------------------------------------------------------------------

def _naive_ssm(xh, dt, A, Bm, Cm):
    """h_t = h_{t-1} * exp(dt_t A) + dt_t B_t x_t ; y_t = C_t . h_t."""
    Bsz, S, H, P = xh.shape
    N = Bm.shape[-1]
    h = np.zeros((Bsz, H, P, N))
    ys = np.zeros((Bsz, S, H, P))
    for t in range(S):
        dec = np.exp(dt[:, t, :, None, None] * A[None, :, None, None])
        upd = np.einsum("bh,bn,bhp->bhpn", dt[:, t], Bm[:, t], xh[:, t])
        h = h * dec + upd
        ys[:, t] = np.einsum("bn,bhpn->bhp", Cm[:, t], h)
    return ys, h


@pytest.mark.parametrize("S,chunk", [(16, 4), (24, 8), (8, 8)])
def test_ssd_chunked_matches_naive(S, chunk):
    rng = np.random.default_rng(0)
    Bsz, H, P, N = 2, 3, 4, 5
    xh = rng.standard_normal((Bsz, S, H, P)).astype(np.float32)
    dt = rng.uniform(0.01, 0.5, (Bsz, S, H)).astype(np.float32)
    A = -rng.uniform(0.1, 1.0, (H,)).astype(np.float32)
    Bm = rng.standard_normal((Bsz, S, N)).astype(np.float32)
    Cm = rng.standard_normal((Bsz, S, N)).astype(np.float32)
    y, hT = L.ssd_chunked(*map(torch.tensor, (xh, dt, A, Bm, Cm)),
                          chunk=chunk)
    y0, h0 = _naive_ssm(xh, dt, A, Bm, Cm)
    np.testing.assert_allclose(y.numpy(), y0, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(hT.numpy(), h0, rtol=1e-3, atol=1e-3)


def test_mamba_decode_matches_train():
    """Stepwise decode through mamba_forward must match the chunked path."""
    cfg = get_config("mamba2-2.7b", smoke=True)
    p = L.make_mamba_params(_gen(1), cfg)
    x = torch.randn((2, 8, cfg.d_model), generator=_gen(1))
    y_train, _ = L.mamba_forward(p, x, cfg, state=None)
    state = L.init_mamba_state(cfg, 2, device="cpu")
    ys = []
    for t in range(8):
        y_t, state = L.mamba_forward(p, x[:, t:t + 1], cfg, state=state)
        ys.append(y_t)
    y_dec = torch.cat(ys, dim=1)
    np.testing.assert_allclose(y_dec.numpy(), y_train.numpy(),
                               rtol=3e-3, atol=3e-3)


# --------------------------------------------------------------------------
# MoE: sorted-capacity dispatch vs explicit dense reference
# --------------------------------------------------------------------------

def _moe_dense_ref(p, x, cfg):
    B, S, d = x.shape
    xt = x.reshape(B * S, d).double().numpy()
    w = {k: p[k].double().numpy() for k in ("w_gate_router", "w1", "w2",
                                            "w3")}
    logits = xt @ w["w_gate_router"]
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    k = cfg.top_k
    out = np.zeros_like(xt)
    for t in range(xt.shape[0]):
        top = np.argsort(-probs[t])[:k]
        wt = probs[t][top]
        if cfg.renorm_topk:
            wt = wt / wt.sum()
        for e, wi in zip(top, wt):
            h = xt[t] @ w["w1"][e]
            h = h / (1 + np.exp(-h)) * (xt[t] @ w["w2"][e])
            out[t] += wi * (h @ w["w3"][e])
    return out.reshape(B, S, d)


def test_moe_matches_dense_reference():
    cfg = dataclasses.replace(get_config("mixtral-8x7b", smoke=True),
                              capacity_factor=8.0, n_shared=0)
    p = L.make_moe_params(_gen(2), cfg)
    x = torch.randn((2, 6, cfg.d_model), generator=_gen(2))
    y = L.moe_forward(p, x, cfg)
    y0 = _moe_dense_ref(p, x, cfg)
    np.testing.assert_allclose(y.numpy(), y0, rtol=2e-3, atol=2e-3)


def test_moe_group_invariance():
    """Dispatch groups must not change the result (capacity permitting)."""
    cfg = dataclasses.replace(get_config("mixtral-8x7b", smoke=True),
                              capacity_factor=8.0)
    p = L.make_moe_params(_gen(5), cfg)
    x = torch.randn((2, 8, cfg.d_model), generator=_gen(5))
    y1 = L.moe_forward(p, x, cfg)
    y2 = L.moe_forward(p, x, dataclasses.replace(cfg, moe_groups=4))
    np.testing.assert_allclose(y1.numpy(), y2.numpy(), rtol=1e-4, atol=1e-4)


# --------------------------------------------------------------------------
# attention
# --------------------------------------------------------------------------

@pytest.mark.parametrize("window,softcap,causal", [
    (0, 0.0, True), (6, 0.0, True), (0, 30.0, True), (0, 0.0, False),
    (4, 20.0, True),
])
def test_flash_equals_full(window, softcap, causal):
    rng = np.random.default_rng(3)
    B, H, S, hd = 2, 3, 32, 8
    q, k, v = (torch.tensor(rng.standard_normal((B, H, S, hd)),
                            dtype=torch.float32) for _ in range(3))
    pos = torch.arange(S)[None].expand(B, S)
    full = L.attend_full(q, k, v, q_positions=pos, kv_positions=pos,
                         window=window, softcap=softcap, causal=causal)
    flash = L.attend_flash(q, k, v, q_positions=pos, kv_positions=pos,
                           window=window, softcap=softcap, causal=causal,
                           q_block=8, kv_block=8)
    np.testing.assert_allclose(flash.numpy(), full.numpy(),
                               rtol=2e-4, atol=2e-4)


if HAVE_HYPOTHESIS:
    @requires_hypothesis
    @settings(max_examples=15, deadline=None)
    @given(pos0=st.integers(0, 1000), theta=st.sampled_from([1e4, 1e6]))
    def test_rope_preserves_norm_and_relativity(pos0, theta):
        """RoPE is a rotation (norm-preserving) and relative: the score of
        (q at p+delta, k at p) is independent of p."""
        rng = np.random.default_rng(6)
        x = torch.tensor(rng.standard_normal((1, 2, 1, 8)),
                         dtype=torch.float32)
        y = L.rope(x, torch.tensor([[pos0, pos0 + 3]]), theta)
        np.testing.assert_allclose(torch.linalg.norm(y, dim=-1).numpy(),
                                   torch.linalg.norm(x, dim=-1).numpy(),
                                   rtol=1e-4)
        q = torch.tensor(rng.standard_normal((8,)), dtype=torch.float32)
        k = torch.tensor(rng.standard_normal((8,)), dtype=torch.float32)

        def score(p):
            qr = L.rope(q[None, None, None], torch.tensor([[p + 3]]), theta)
            kr = L.rope(k[None, None, None], torch.tensor([[p]]), theta)
            return float(torch.sum(qr * kr))

        assert abs(score(pos0) - score(0)) < 1e-2
else:
    @requires_hypothesis
    def test_rope_preserves_norm_and_relativity():
        pass


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the host "
                    "without a GPU")
def test_caches_default_to_the_gpu():
    """The decode caches go where the port's entry points go: with no
    device given, the GPU, and on a host without one they raise rather
    than land beside weights on another device."""
    cfg = get_config("hymba-1.5b", smoke=True)
    for make in (lambda: LM.init_cache(cfg, 1, 8),
                 lambda: L.init_mamba_state(cfg, 1),
                 lambda: WH.init_dec_cache(get_config("whisper-small",
                                                      smoke=True), 1, 8)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    assert LM.init_cache(cfg, 1, 8, device="cpu")["u0"]["k"].device.type \
        == "cpu"
