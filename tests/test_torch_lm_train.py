"""The pieces of the LM training path against the JAX package, on the
same numpy inputs, in float32:

- the train step's options: ``microbatches=2``, ``grad_bf16=True`` and
  ``use_flash=True`` against the reference's, a batch that does not split
  into the microbatches, and ``remat`` on against off in the port;
- twins of ``tests/test_layers_units.py::test_flash_gradients`` and of the
  substrate tests of ``tests/test_substrate.py`` (``cross_entropy``, the
  LM data stream, crash-restart);
- the SSD repair and AdamW over nested trees are in
  ``test_torch_lm_train_ssd.py``.
"""
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import HAVE_HYPOTHESIS, requires_hypothesis  # noqa: E402

if HAVE_HYPOTHESIS:
    from hypothesis import given, settings, strategies as st

import repro.data as jdata  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.train import cross_entropy as jcross_entropy  # noqa: E402
import repro_torch.checkpoint as tckpt  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch import data as tdata  # noqa: E402
from repro_torch import optim as toptim, train as ttrain  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import lm as TLM  # noqa: E402

import torch_lm_common as C  # noqa: E402
import torch_lm_train as T  # noqa: E402
from torch_lm_train import one_torch_thread  # noqa: E402,F401


# --------------------------------------------------------------------------
# the step's options
# --------------------------------------------------------------------------

def test_microbatched_step_matches_jax():
    T.check_step(T.run("qwen3-14b", microbatches=2))


def test_microbatches_must_split_the_batch():
    """A batch whose rows do not split evenly into the microbatches
    raises, as the reference's reshape does, and trains on no part of
    it; the launcher's flags reach the same error."""
    _, tcfg, _, tp = T.weights("qwen3-14b")
    b = T.torch_batch(T.batch(tcfg))
    with pytest.raises(ValueError, match="microbatches"):
        ttrain.loss_and_grads(tp, tcfg, b, microbatches=3)
    with pytest.raises(ValueError, match="microbatches"):
        ttrain.make_train_step(tcfg, toptim.AdamWConfig(), microbatches=3)(
            tp, toptim.adamw_init(tp), b)
    with pytest.raises(ValueError, match="microbatches"):
        tlaunch.main(["--arch", "qwen3-14b", "--smoke", "--steps", "1",
                      "--batch", "2", "--seq", "8", "--microbatches", "3",
                      "--device", "cpu"])


def test_flash_step_matches_jax():
    T.check_step(T.run("qwen3-14b", use_flash=True))


def test_grad_bf16_step_matches_jax():
    """Grads rounded to bf16 before the update, as the reference's.  Loss,
    lr and grad_norm as ``check_step``.  Where the two packages' float32
    grads straddle a bf16 rounding boundary they round one bf16 step
    apart (8 significant bits: up to 2^-7 of the value), so each moment
    element is held within ``TOL`` of its leaf's largest |value| plus
    2^-7 (2^-6 for ``nu``, a square) of its own |value|; the parameters by
    ``assert_updated_params_close``."""
    r = T.run("qwen3-14b", grad_bf16=True)
    for key, rtol in (("loss", 1e-5), ("grad_norm", 1e-6), ("lr", 1e-6)):
        np.testing.assert_allclose(float(r[key][0]), float(r[key][1]),
                                   rtol=rtol, err_msg=key)
    for key, ulp in (("mu", 2.0 ** -7), ("nu", 2.0 ** -6)):
        got, want = C.flat_torch(r[key][0]), C.flat_jax(r[key][1])
        assert sorted(got) == sorted(want)
        for k, w in want.items():
            err = np.abs(got[k].numpy().astype(np.float64) - w)
            limit = C.TOL * np.abs(w).max() + ulp * np.abs(w)
            assert (err <= limit).all(), (key, k)
    T.assert_updated_params_close(r)
    # the rounding did happen: the port's grads times the clip scale
    # are bf16 values, so mu / (1 - b1) / scale is one
    tg = toptim.tree_leaves(ttrain.loss_and_grads(
        r["start"][0], T.weights("qwen3-14b")[1],
        T.torch_batch(T.batch(T.weights("qwen3-14b")[0])))[1])
    assert any(not torch.equal(g, g.to(torch.bfloat16).float()) for g in tg)


def _grads_no_remat(params, cfg, batch):
    """(loss, grads) of the train step's LM loss on
    ``lm_forward(remat=False)``, which keeps every activation."""
    leaves = [p.detach().requires_grad_(True)
              for p in toptim.tree_leaves(params)]
    logits = TLM.lm_forward(toptim.tree_unflatten(params, leaves), cfg,
                            batch["tokens"], remat=False)
    labels = batch["labels"]
    loss = ttrain.cross_entropy(logits[:, logits.shape[1] - labels.shape[1]:],
                                labels)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    return loss.detach(), toptim.tree_unflatten(params, list(grads))


@pytest.mark.parametrize("arch", ["qwen3-14b", "hymba-1.5b",
                                  "deepseek-v2-lite-16b"])
def test_remat_on_equals_off(arch):
    """The train step's loss runs ``lm_forward(remat=True)``, which
    recomputes each unit in the backward: its loss and every grad leaf
    equal those of ``lm_forward(remat=False)``, which keeps every
    activation, within 1e-6 of the leaf's largest |value|."""
    _, tcfg, _, tp = T.weights(arch)
    b = T.torch_batch(T.batch(tcfg))
    l1, g1 = ttrain.loss_and_grads(tp, tcfg, b)
    l0, g0 = _grads_no_remat(tp, tcfg, b)
    assert abs(float(l1) - float(l0)) <= 1e-6 * abs(float(l0))
    for a, c in zip(toptim.tree_leaves(g1), toptim.tree_leaves(g0)):
        assert float((a - c).abs().max()) <= 1e-6 * max(
            float(c.abs().max()), 1e-30)


# --------------------------------------------------------------------------
# flash attention's backward
# --------------------------------------------------------------------------

def _flash_inputs(S=16):
    rng = np.random.default_rng(4)
    B, H, hd = 1, 2, 4
    return [rng.standard_normal((B, H, S, hd)).astype(np.float32)
            for _ in range(3)], np.broadcast_to(np.arange(S)[None], (B, S))


@pytest.mark.parametrize("window", [4, 0, "tensor"])
def test_flash_gradients(window):
    """The twin of ``tests/test_layers_units.py::test_flash_gradients``:
    the port's flash gradients within 1e-3 (rtol and atol) of
    ``attend_full``'s, as the reference holds its own, and within 1e-5 of
    the largest |grad| of the JAX package's flash gradients; also for a
    global layer and a per-layer (tensor) window, hymba's kind."""
    (q, k, v), pos = _flash_inputs()
    w_t = torch.tensor(4) if window == "tensor" else window
    w_j = jnp.asarray(4) if window == "tensor" else window

    def tloss(fn, **kw):
        def f(q, k, v):
            p = torch.from_numpy(np.array(pos))
            return torch.sum(torch.sin(fn(q, k, v, q_positions=p,
                                          kv_positions=p, window=w_t, **kw)))
        return f

    def jloss(fn, **kw):
        return lambda q, k, v: jnp.sum(jnp.sin(fn(
            q, k, v, q_positions=jnp.asarray(pos),
            kv_positions=jnp.asarray(pos),
            window=w_j, **kw)))

    def tgrad(f):
        ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
        return torch.autograd.grad(f(*ts), ts)

    g_flash = tgrad(tloss(TL.attend_flash, q_block=4, kv_block=4))
    g_full = tgrad(tloss(TL.attend_full))
    j_flash = jax.grad(jloss(JL.attend_flash, q_block=4, kv_block=4),
                       argnums=(0, 1, 2))(q, k, v)
    for a, b, c in zip(g_flash, g_full, j_flash):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-3,
                                   atol=1e-3)
        C.assert_close(a, c, 1e-5)


def test_flash_backward_keeps_no_scores():
    """The flash backward recomputes each kv step: what autograd keeps
    between the forward and the backward holds no (q block, kv block)
    score tile, only the steps' inputs (q, k, v and m, l, acc)."""
    (q, k, v), pos = _flash_inputs(S=64)
    ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    p = torch.from_numpy(np.array(pos))
    shapes = []

    def pack(t):
        shapes.append(tuple(t.shape))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = TL.attend_flash(*ts, q_positions=p, kv_positions=p,
                              q_block=16, kv_block=16)
    assert shapes
    assert not any(s[-2:] == (16, 16) for s in shapes), shapes
    torch.autograd.grad(out.sum(), ts)


# --------------------------------------------------------------------------
# cross entropy
# --------------------------------------------------------------------------

def _ce_inputs(seed=0, shape=(2, 3, 7)):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal(shape).astype(np.float32) * 3
    labels = rng.integers(0, shape[-1], shape[:-1]).astype(np.int32)
    return logits, labels


def test_cross_entropy_reference():
    logits = np.random.default_rng(0).standard_normal((2, 3, 7)).astype(
        np.float32)
    labels = np.asarray([[1, 2, 3], [0, 6, 5]], np.int32)
    ce = ttrain.cross_entropy(torch.from_numpy(logits),
                              torch.from_numpy(labels), z_loss=0.0)
    lp = torch.log_softmax(torch.from_numpy(logits), dim=-1)
    ref = -np.mean([float(lp[b, s, labels[b, s]]) for b in range(2)
                    for s in range(3)])
    assert float(ce) == pytest.approx(float(ref), rel=1e-5)


@pytest.mark.parametrize("z_loss", [0.0, 1e-4, 0.1])
@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_matches_jax(z_loss, masked):
    """Value and gradient against ``repro.train.cross_entropy``, with and
    without a mask (one row fully masked) and z-loss."""
    logits, labels = _ce_inputs(1, (3, 5, 11))
    mask = None
    if masked:
        mask = (np.random.default_rng(2).random((3, 5)) < 0.6)
        mask[1] = False
    tl = torch.tensor(logits, requires_grad=True)
    ce = ttrain.cross_entropy(tl, torch.from_numpy(labels), z_loss=z_loss,
                              mask=None if mask is None
                              else torch.from_numpy(mask))
    (g,) = torch.autograd.grad(ce, [tl])
    jce, jg = jax.value_and_grad(lambda x: jcross_entropy(
        x, jnp.asarray(labels), z_loss=z_loss,
        mask=None if mask is None else jnp.asarray(mask)))(
            jnp.asarray(logits))
    assert float(ce.detach()) == pytest.approx(float(jce), rel=1e-6)
    C.assert_close(g, jg, 1e-6)


def test_cross_entropy_all_masked_is_zero():
    logits, labels = _ce_inputs()
    ce = ttrain.cross_entropy(torch.from_numpy(logits),
                              torch.from_numpy(labels),
                              mask=torch.zeros(labels.shape, dtype=torch.bool))
    assert float(ce) == 0.0


# --------------------------------------------------------------------------
# data
# --------------------------------------------------------------------------

def test_data_deterministic_and_seekable():
    dc = tdata.DataConfig(vocab=100, seq_len=17, global_batch=4, seed=7)
    b1, b2 = (tdata.lm_batch(dc, 5, device="cpu") for _ in range(2))
    assert torch.equal(b1["tokens"], b2["tokens"])
    b3 = tdata.lm_batch(dc, 6, device="cpu")
    assert not torch.equal(b1["tokens"], b3["tokens"])


@pytest.mark.parametrize("step", [0, 5, 1234])
def test_lm_and_frames_batches_bit_equal_to_jax(step):
    kw = dict(vocab=100, seq_len=17, global_batch=3, seed=7)
    ours = tdata.lm_batch(tdata.DataConfig(**kw), step, device="cpu")
    theirs = jdata.lm_batch(jdata.DataConfig(**kw), step)
    ours_f = tdata.frames_batch(tdata.DataConfig(**kw), step, d_model=8,
                                frames=5, device="cpu")
    theirs_f = jdata.frames_batch(jdata.DataConfig(**kw), step, d_model=8,
                                  frames=5)
    for o, t in ((ours, theirs), (ours_f, theirs_f)):
        assert sorted(o) == sorted(t)
        for key in t:
            assert o[key].dtype == {np.dtype(np.int32): torch.int32,
                                    np.dtype(np.float32): torch.float32}[
                np.asarray(t[key]).dtype]
            assert np.array_equal(o[key].numpy(), np.asarray(t[key])), key
    assert torch.equal(ours["tokens"][:, 1:], ours["labels"][:, :-1])


if HAVE_HYPOTHESIS:
    @requires_hypothesis
    @settings(max_examples=10, deadline=None)
    @given(step=st.integers(0, 10000), seed=st.integers(0, 100))
    def test_data_tokens_in_range(step, seed):
        dc = tdata.DataConfig(vocab=64, seq_len=9, global_batch=2, seed=seed)
        t = tdata.lm_batch(dc, step, device="cpu")["tokens"]
        assert int(t.min()) >= 0 and int(t.max()) < 64
        assert np.array_equal(t.numpy(), np.asarray(jdata.lm_batch(
            jdata.DataConfig(vocab=64, seq_len=9, global_batch=2,
                             seed=seed), step)["tokens"]))
else:
    @requires_hypothesis
    def test_data_tokens_in_range():
        pass


# --------------------------------------------------------------------------
# checkpoint / fault tolerance
# --------------------------------------------------------------------------

def _tiny_train(steps, params, opt, step_fn, dc, start=0):
    for i in range(start, steps):
        params, opt, m = step_fn(params, opt,
                                 tdata.lm_batch(dc, i, device="cpu"))
    return params, opt, float(m["loss"])


def test_crash_restart_is_bit_exact():
    cfg = get_config("qwen3-14b", smoke=True)
    opt_cfg = toptim.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20)
    params, opt = ttrain.init_train_state(cfg, 0, device="cpu")
    dc = tdata.DataConfig(vocab=cfg.vocab, seq_len=17, global_batch=4,
                          seed=1)
    step_fn = ttrain.make_train_step(cfg, opt_cfg)
    params, opt, _ = _tiny_train(6, params, opt, step_fn, dc)
    with tempfile.TemporaryDirectory() as d:
        tckpt.save(d, 6, {"p": params, "o": opt})
        # continue uninterrupted
        pa, oa, loss_a = _tiny_train(10, params, opt, step_fn, dc, start=6)
        # "crash" + restore + continue
        state, meta = tckpt.restore(d, 6, {"p": params, "o": opt},
                                    device="cpu")
        pb, ob, loss_b = _tiny_train(10, state["p"], state["o"], step_fn,
                                     dc, start=6)
    assert loss_a == loss_b
    for a, b in zip(toptim.tree_leaves((pa, oa)),
                    toptim.tree_leaves((pb, ob))):
        assert torch.equal(a, b)
