"""Two repairs of the LM training path, held against the JAX package on
the same numpy inputs:

- the SSD gradient: ``ssd_chunked`` masks before the exponential, so its
  forward is unchanged bit for bit and its gradient is finite at every
  chunk size, where the reference's is NaN at a long chunk (a fault of
  the reference that the port does not twin, ROADMAP.md);
- AdamW over an LM-shaped nested tree against ``repro.optim``.
"""
import functools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.optim as joptim  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch import optim as toptim  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402

import torch_lm_common as C  # noqa: E402
from torch_lm_train import one_torch_thread  # noqa: E402,F401


# --------------------------------------------------------------------------
# the SSD gradient
# --------------------------------------------------------------------------

def _ssd_before_repair(xh, dt, A, Bm, Cm, *, chunk):
    """``ssd_chunked`` as the port had it before the repair (and as the
    reference has it): ``where(tril, exp(Ldec), 0)``."""
    Bsz, S, H, Pd = xh.shape
    N = Bm.shape[-1]
    nc = S // chunk
    xc = xh.reshape(Bsz, nc, chunk, H, Pd).float()
    dtc = dt.reshape(Bsz, nc, chunk, H).float()
    Bc = Bm.reshape(Bsz, nc, chunk, N).float()
    Cc = Cm.reshape(Bsz, nc, chunk, N).float()
    dA = dtc * A[None, None, None, :]
    dAcs = torch.cumsum(dA, dim=2)
    Ldec = dAcs[:, :, :, None, :] - dAcs[:, :, None, :, :]
    tril = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=xh.device))
    Ldec = torch.where(tril[None, None, :, :, None], torch.exp(Ldec), 0.0)
    scores = torch.einsum("bcin,bcjn->bcij", Cc, Bc)
    w = scores[..., None] * Ldec * dtc[:, :, None, :, :]
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", w, xc)
    decay_to_end = torch.exp(dAcs[:, :, -1:, :] - dAcs)
    Sc = torch.einsum("bcjh,bcjn,bcjhp->bchpn", decay_to_end * dtc, Bc, xc)
    chunk_decay = torch.exp(dAcs[:, :, -1, :])
    h = torch.zeros((Bsz, H, Pd, N), dtype=torch.float32, device=xh.device)
    h_prev = []
    for c in range(nc):
        h_prev.append(h)
        h = h * chunk_decay[:, c, :, None, None] + Sc[:, c]
    h_prev = torch.stack(h_prev, dim=1)
    y_inter = torch.einsum("bcin,bchpn,bcih->bcihp", Cc, h_prev,
                           torch.exp(dAcs))
    y = (y_intra + y_inter).reshape(Bsz, S, H, Pd)
    return y.to(xh.dtype), h


# (S, dt): hymba at --seq 2048 (S = 2048 + 128 meta tokens; its
# ssm_chunk 256 picks chunk 136, the largest divisor of 2176 up to 256)
# with dt = softplus(N(0, 0.8)), and S = 256 at dt = softplus(0) = 0.69,
# the value at initialisation (A_log = dt_bias = 0, so A = -1)
SSD_CASES = {2176: "softplus", 256: "init"}


def _ssd_inputs(S, seed=0):
    rng = np.random.default_rng(seed)
    B, H, P, N = 1, 2, 4, 4
    xh = rng.standard_normal((B, S, H, P)).astype(np.float32)
    if SSD_CASES[S] == "softplus":
        dt = np.log1p(np.exp(rng.normal(0, 0.8, (B, S, H)))).astype(
            np.float32)
    else:
        dt = np.full((B, S, H), math.log(2.0), np.float32)
    A = -np.ones((H,), np.float32)
    Bm = rng.standard_normal((B, S, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, N)).astype(np.float32)
    w = rng.standard_normal((B, S, H, P)).astype(np.float32)
    return (xh, dt, A, Bm, Cm), w


@functools.lru_cache(maxsize=None)
def _ssd_grads_torch(S, chunk):
    args, w = _ssd_inputs(S)
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    y, _ = TL.ssd_chunked(*ts, chunk=chunk)
    return torch.autograd.grad(torch.sum(y * torch.from_numpy(w)), ts)


@functools.lru_cache(maxsize=None)
def _ssd_grads_jax(S, chunk):
    args, w = _ssd_inputs(S)
    return jax.jit(jax.grad(lambda *a: jnp.sum(
        JL.ssd_chunked(*a, chunk=chunk)[0] * w), argnums=(0, 1, 2, 3, 4)))(
        *[jnp.asarray(a) for a in args])


@pytest.mark.parametrize("S", sorted(SSD_CASES))
def test_ssd_forward_unchanged_bit_for_bit(S):
    args, _ = _ssd_inputs(S)
    ts = [torch.from_numpy(a) for a in args]
    for chunk in (64, 128) + ((256,) if S % 256 == 0 else ()):
        y, h = TL.ssd_chunked(*ts, chunk=chunk)
        y0, h0 = _ssd_before_repair(*ts, chunk=chunk)
        assert torch.equal(y, y0) and torch.equal(h, h0), chunk


@pytest.mark.parametrize("S", sorted(SSD_CASES))
def test_ssd_gradients_match_jax_at_chunk_64(S):
    for a, b in zip(_ssd_grads_torch(S, 64), _ssd_grads_jax(S, 64)):
        C.assert_close(a, b, C.TOL)


@pytest.mark.parametrize("S, chunk, reference_nan",
                         [(2176, 128, True), (2176, 136, True),
                          (256, 128, False), (256, 256, True)])
def test_ssd_gradients_finite_at_long_chunks(S, chunk, reference_nan):
    """The port's gradient at a long chunk is finite and within ``TOL``
    of the reference's at chunk 64 (the math does not depend on the
    chunk).  The reference's own gradient there is NaN where its
    ``where(tril, exp(Ldec), 0)`` overflows above the diagonal: a known
    difference (ROADMAP.md), asserted here so that a repair of the
    reference shows."""
    ours = _ssd_grads_torch(S, chunk)
    ref64 = _ssd_grads_jax(S, 64)
    for a, b in zip(ours, ref64):
        assert torch.isfinite(a).all()
        C.assert_close(a, b, C.TOL)
    ref = _ssd_grads_jax(S, chunk)
    assert any(bool(jnp.isnan(g).any()) for g in ref) == reference_nan


# --------------------------------------------------------------------------
# AdamW over a nested tree
# --------------------------------------------------------------------------

def _lm_shaped(rng, scale=1.0):
    """An LM-shaped tree: nested dicts in unsorted key order, a list of
    stacked units, a tuple, and a ``None`` (an empty subtree)."""
    def a(*shape):
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    return {"layers": [{"ln1": {"gamma": a(3, 8)},
                        "attn": {"wq": a(3, 8, 2, 4), "wo": a(3, 2, 4, 8)}},
                       {"mamba": {"A_log": a(3, 2), "w_x": a(3, 8, 16)}}],
            "embed": a(32, 8), "final_norm": {"gamma": a(8)},
            "pair": (a(5), a(2, 2)), "lm_head": None}


def test_tree_leaves_follow_jax_order():
    rng = np.random.default_rng(0)
    tree = _lm_shaped(rng)
    ours = toptim.tree_leaves(toptim.tree_map(torch.from_numpy, tree))
    theirs = jax.tree.leaves(tree)
    assert len(ours) == len(theirs)
    for o, t in zip(ours, theirs):
        assert np.array_equal(o.numpy(), t)
    back = toptim.tree_unflatten(tree, ours)
    assert list(back) == list(tree) and back["lm_head"] is None
    assert isinstance(back["pair"], tuple)


def test_adamw_nested_tree_matches_jax():
    """Five steps on an LM-shaped tree, the clip biting at every step but
    the second, against ``repro.optim.adamw_update``: lr and grad_norm at
    1e-6 relative, every leaf of the parameters and moments at 1e-6."""
    rng = np.random.default_rng(1)
    params = _lm_shaped(rng, 0.5)
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=4, weight_decay=0.1,
              clip_norm=1.0)
    tcfg, jcfg = toptim.AdamWConfig(**kw), joptim.AdamWConfig(**kw)
    tp = toptim.tree_map(torch.from_numpy, params)
    jp = jax.tree.map(jnp.asarray, params)
    ts, js = toptim.adamw_init(tp), joptim.adamw_init(jp)
    jupdate = jax.jit(joptim.adamw_update, static_argnums=3)
    assert ts["mu"]["lm_head"] is None
    for step in range(5):
        g = _lm_shaped(rng, 0.001 if step == 1 else 3.0)
        tp, ts, tinfo = toptim.adamw_update(
            toptim.tree_map(torch.from_numpy, g), ts, tp, tcfg)
        jp, js, jinfo = jupdate(jax.tree.map(jnp.asarray, g), js, jp, jcfg)
        assert (float(jinfo["grad_norm"]) > kw["clip_norm"]) == (step != 1)
        for key in ("lr", "grad_norm"):
            np.testing.assert_allclose(float(tinfo[key]),
                                       float(jinfo[key]), rtol=1e-6)
        for ours, theirs in ((tp, jp), (ts["mu"], js["mu"]),
                             (ts["nu"], js["nu"])):
            o, t = toptim.tree_leaves(ours), jax.tree.leaves(theirs)
            assert len(o) == len(t)
            for a, b in zip(o, t):
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           rtol=1e-6, atol=1e-6)
        assert int(ts["step"]) == int(js["step"]) == step + 1
    assert list(tp) == list(params) and tp["lm_head"] is None


def test_adamw_refuses_a_tree_of_another_shape():
    tp = toptim.tree_map(torch.from_numpy,
                         _lm_shaped(np.random.default_rng(2)))
    g = dict(tp, embed=None)
    with pytest.raises(ValueError, match="grads"):
        toptim.adamw_update(g, toptim.adamw_init(tp), tp,
                            toptim.AdamWConfig())
