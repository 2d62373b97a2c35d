"""One training step of the LM slice against the JAX package, one
architecture at a time: ``repro_torch.train.loss_and_grads`` against
``jax.value_and_grad`` of the reference's loss, and
``repro_torch.train.make_train_step`` against the jitted
``repro.train.make_train_step``, on the reference's weights carried
across, in float32, on the batch of ``tests/test_models.py``'s
``_batch`` (B = 2, S = 16; phi-3's image embeddings, whisper's frames).
The ``test_torch_lm_train_archs_*`` files run these checks over their
halves of the ten architectures (one file runs on one worker)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import lm as JLM
from repro.models import whisper as JWH
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as jadamw_init
from repro.train import make_train_step as jmake_train_step
from repro.train.step import _lm_loss, _whisper_loss
from repro_torch import optim as toptim
from repro_torch import train as ttrain

import torch_lm_common as C

B, S = 2, 16
OPT = dict(lr=1e-3, total_steps=10)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The small forms' ops are far too small to share among threads, and
    the test workers share the host's cores: one intra-op thread while a
    module of these tests runs, the count restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def batch(cfg, seed=0):
    """``tests/test_models.py``'s ``_batch`` as numpy arrays."""
    rng = np.random.default_rng(seed)
    if cfg.encdec:
        return {"frames": rng.standard_normal((B, 24, cfg.d_model))
                .astype(np.float32),
                "tokens": rng.integers(0, cfg.vocab, (B, 8)).astype(np.int32),
                "labels": rng.integers(0, cfg.vocab, (B, 8)).astype(np.int32)}
    out = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.frontend == "vision_stub":
        out["img_embeds"] = rng.standard_normal(
            (B, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)
    return out


def torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


@functools.lru_cache(maxsize=None)
def weights(arch, **changes):
    """(JAX config, port config, the reference's params, the same carried
    to the port)."""
    jcfg, tcfg = C.configs(arch, **changes)
    init = JWH.init_whisper_params if jcfg.encdec else JLM.init_lm_params
    jp = init(jcfg, jax.random.PRNGKey(0))
    return jcfg, tcfg, jp, C.carry(jp, tcfg)


@functools.lru_cache(maxsize=None)
def run(arch, microbatches=1, grad_bf16=False, use_flash=False):
    """Both packages' loss, grads, and one train step's outputs for
    ``arch``: a dict of (port, reference) pairs, computed once a
    process.  The JAX side is one ``jax.jit``."""
    jcfg, tcfg, jp, tp = weights(arch)
    b = batch(jcfg)
    jloss_fn = _whisper_loss if jcfg.encdec else _lm_loss
    jstep = jmake_train_step(jcfg, JAdamWConfig(**OPT),
                             microbatches=microbatches, use_flash=use_flash,
                             grad_bf16=grad_bf16)

    @jax.jit
    def jrun(p, o, bt):
        return (jax.value_and_grad(jloss_fn)(p, jcfg, bt, use_flash),
                jstep(p, o, bt))

    (jl, jg), (jp1, jo1, jm) = jrun(
        jp, jadamw_init(jp), {k: jnp.asarray(v) for k, v in b.items()})
    tb = torch_batch(b)
    tl, tg = ttrain.loss_and_grads(tp, tcfg, tb, use_flash=use_flash)
    tstep = ttrain.make_train_step(tcfg, toptim.AdamWConfig(**OPT),
                                   microbatches=microbatches,
                                   use_flash=use_flash, grad_bf16=grad_bf16)
    tp1, to1, tm = tstep(tp, toptim.adamw_init(tp), tb)
    return {"loss": (tl, jl), "grads": (tg, jg), "params": (tp1, jp1),
            "mu": (to1["mu"], jo1["mu"]), "nu": (to1["nu"], jo1["nu"]),
            "step_loss": (tm["loss"], jm["loss"]),
            "grad_norm": (tm["grad_norm"], jm["grad_norm"]),
            "lr": (tm["lr"], jm["lr"]), "step": (to1["step"], jo1["step"]),
            "start": (tp, jp)}


def assert_updated_params_close(r, tol=C.TOL):
    """The updated parameters.  Step 1 of AdamW moves each element by
    about ``lr * sign(g)``, whatever |g|: where the reference's gradient
    is within the gradient gate (``tol`` of its leaf's largest |g|) of
    zero, the two packages may round it to opposite signs, and the element
    may then differ by up to ``2 lr`` (plus ``tol`` of the leaf's largest
    |p|).  Everywhere else it must agree within ``tol`` of the leaf's
    largest |p|."""
    tp1, jp1 = r["params"]
    tg, jg = r["grads"]
    got, want = C.flat_torch(tp1), C.flat_jax(jp1)
    g_ref = C.flat_jax(jg)
    assert sorted(got) == sorted(want)
    lr = OPT["lr"]
    for k, w in want.items():
        g = np.abs(g_ref[k])
        noise = g <= tol * max(float(g.max()), 1e-30)
        scale = max(float(np.abs(w).max()), 1e-30)
        err = np.abs(got[k].numpy().astype(np.float64) - w)
        limit = np.where(noise, 2 * lr + tol * scale, tol * scale)
        assert (err <= limit).all(), (k, float((err - limit).max()))


def check_step(r):
    """Loss 1e-5 relative, grad_norm and lr 1e-6 relative, every grad
    leaf and the moments within ``TOL`` of the leaf's largest |value|,
    the updated parameters by ``assert_updated_params_close``, and no
    ``requires_grad`` on what the step returns."""
    for key, rtol in (("loss", 1e-5), ("step_loss", 1e-5),
                      ("grad_norm", 1e-6), ("lr", 1e-6)):
        got, want = r[key]
        np.testing.assert_allclose(float(got), float(want), rtol=rtol,
                                   err_msg=key)
    assert int(r["step"][0]) == int(r["step"][1]) == 1
    for key in ("grads", "mu", "nu"):
        C.assert_trees_close(*r[key], what=f"{key} ")
    assert_updated_params_close(r)
    for key in ("params", "mu", "nu"):
        for t in toptim.tree_leaves(r[key][0]):
            assert not t.requires_grad and t.grad_fn is None, key
            assert torch.isfinite(t).all(), key
