"""The port's training loop held against the JAX package's.

- ``repro_torch.data.image_batch`` is bit-equal to ``repro.data``'s.
- ``repro_torch.optim.adamw_update`` follows ``repro.optim``'s on a random
  parameter dict for five steps (warm-up, cosine decay, clipping, weight
  decay), at 1e-6; its global norm stays finite where float32 squares
  would overflow (the JAX twin's would not).
- The trainer twin (``repro_torch.examples.train_cnn_fftconv``) on
  ``fft-cuda`` (the kernels' plain versions on the CPU) takes three steps
  from the JAX example's own initial parameters, carried across by
  ``convert.tree_from_jax``, beside the JAX example's loss step rebuilt
  from its ``init_params``/``forward`` and ``repro.optim.adamw_update``:
  losses agree at 1e-4, parameters at 1e-5 relative to each one's scale;
  the eval through the prepared network gives the same logits (1e-4) and
  the same prepared-cache counts.
"""
import importlib.util
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

import jax
import jax.numpy as jnp

import repro.conv as jconv
import repro.data as jdata
import repro.optim as joptim
import repro_torch.conv as tconv
from repro_torch import convert, data as tdata, optim as toptim
from repro_torch.examples import train_cnn_fftconv as twin

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _jax_example():
    spec = importlib.util.spec_from_file_location(
        "jax_train_cnn_fftconv", ROOT / "examples" / "train_cnn_fftconv.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_image_batch_bit_equal_to_jax():
    cfg = dict(vocab=0, seq_len=0, global_batch=5, seed=3, kind="images")
    for step in range(3):
        ours = tdata.image_batch(tdata.DataConfig(**cfg), step, device="cpu")
        theirs = jdata.image_batch(jdata.DataConfig(**cfg), step)
        assert ours["labels"].dtype == torch.int32
        for key in ("images", "labels"):
            assert np.array_equal(ours[key].numpy(),
                                  np.asarray(theirs[key])), (step, key)


def test_global_norm_past_float32_squares():
    """A global norm whose square overflows float32 (about 1.8e19 and up)
    is still the float64 norm, and the clipped step moves the parameters
    by the learning rate, as an unclipped unit gradient would; a float32
    sum of squares would read inf and clip the step to nothing."""
    g = {"a": torch.full((4, 5), 4e18), "b": torch.full((3,), -6e18)}
    want = np.sqrt(20 * 4e18 ** 2 + 3 * 6e18 ** 2)
    assert float(toptim.global_norm(g)) == pytest.approx(want, rel=1e-6)
    params = {n: torch.zeros_like(t) for n, t in g.items()}
    cfg = toptim.AdamWConfig(lr=1e-2, warmup_steps=0, weight_decay=0.0,
                             clip_norm=1.0)
    new, _, info = toptim.adamw_update(g, toptim.adamw_init(params), params,
                                       cfg)
    assert np.isfinite(float(info["grad_norm"]))
    for n, t in g.items():    # Adam's first step: lr times the sign
        np.testing.assert_allclose(new[n].numpy(),
                                   -1e-2 * np.sign(t.numpy()), rtol=1e-5)


def test_adamw_matches_jax():
    rng = np.random.default_rng(0)
    shapes = {"c": (4, 3, 3, 3), "b": (4,), "w": (12, 5)}
    params = {n: rng.standard_normal(s).astype(np.float32)
              for n, s in shapes.items()}
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=4, weight_decay=0.1,
              clip_norm=1.0)
    tcfg, jcfg = toptim.AdamWConfig(**kw), joptim.AdamWConfig(**kw)
    tp = {n: torch.from_numpy(a) for n, a in params.items()}
    jp = {n: jnp.asarray(a) for n, a in params.items()}
    ts, js = toptim.adamw_init(tp), joptim.adamw_init(jp)
    for step in range(5):
        # step 1's grads are small enough that the clip does not bite
        g = {n: (rng.standard_normal(s) * (0.01 if step == 1 else 3.0))
             .astype(np.float32) for n, s in shapes.items()}
        tp, ts, tinfo = toptim.adamw_update(
            {n: torch.from_numpy(a) for n, a in g.items()}, ts, tp, tcfg)
        jp, js, jinfo = joptim.adamw_update(
            {n: jnp.asarray(a) for n, a in g.items()}, js, jp, jcfg)
        for key in ("lr", "grad_norm"):
            np.testing.assert_allclose(float(tinfo[key]),
                                       float(jinfo[key]), rtol=1e-6)
        for n in shapes:
            for ours, theirs in ((tp[n], jp[n]), (ts["mu"][n], js["mu"][n]),
                                 (ts["nu"][n], js["nu"][n])):
                np.testing.assert_allclose(ours.numpy(), np.asarray(theirs),
                                           rtol=1e-6, atol=1e-6)
        assert int(ts["step"]) == int(js["step"]) == step + 1


def _jax_step(jex, cfg):
    """The JAX example's loss step (local to its ``main``), rebuilt."""
    @jax.jit
    def step(params, opt, x, y):
        def loss_fn(p):
            logits = jex.forward(p, x)
            onehot = jax.nn.one_hot(y, 10)
            return -jnp.mean(jnp.sum(
                jax.nn.log_softmax(logits) * onehot, -1))
        loss, grads = jax.value_and_grad(loss_fn)(params)
        params, opt, _ = joptim.adamw_update(grads, opt, params, cfg)
        return params, opt, loss
    return step


def test_trainer_steps_and_eval_match_jax():
    jex = _jax_example()
    steps, batch = 3, 4
    kw = dict(lr=3e-3, warmup_steps=5, total_steps=steps, weight_decay=0.0)
    jparams = jex.init_params(jax.random.PRNGKey(0))
    params = convert.tree_from_jax(
        {n: np.asarray(a) for n, a in jparams.items()},
        like=twin.init_params(0, "cpu"), device="cpu")
    jopt, opt = joptim.adamw_init(jparams), toptim.adamw_init(params)
    jstep, cfg = _jax_step(jex, joptim.AdamWConfig(**kw)), \
        toptim.AdamWConfig(**kw)
    dc = dict(vocab=0, seq_len=0, global_batch=batch, seed=0,
              kind="images")
    for i in range(steps):
        b = tdata.image_batch(tdata.DataConfig(**dc), i, device="cpu")
        jb = jdata.image_batch(jdata.DataConfig(**dc), i)
        params, opt, loss = twin.train_step(params, opt, b["images"],
                                            b["labels"], cfg, "fft-cuda")
        jparams, jopt, jloss = jstep(jparams, jopt, jb["images"],
                                     jb["labels"])
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)
        for n in params:
            ours, theirs = params[n].numpy(), np.asarray(jparams[n])
            scale = np.abs(theirs).max()
            np.testing.assert_allclose(ours / scale, theirs / scale,
                                       atol=1e-5, err_msg=f"{n} step {i}")

    # the eval: one planning pass, two prepare sweeps of one version
    tconv.clear_prepared_cache()
    jconv.clear_prepared_cache()
    net = twin.eval_network(batch, "fft-cuda")
    jnet = jex.eval_network(batch)
    assert net.layer_names == jnet.layer_names
    eb = tdata.image_batch(tdata.DataConfig(**dc), 10_000, device="cpu")
    jeb = jdata.image_batch(jdata.DataConfig(**dc), 10_000)
    with torch.no_grad():
        prepared = net.prepare({n: params[n] for n in ("c1", "c2")},
                               weights_version=steps)
        logits = twin.forward_prepared(params, prepared, eb["images"])
        net.prepare({n: params[n] for n in ("c1", "c2")},
                    weights_version=steps)
    jprepared = jnet.prepare({n: jparams[n] for n in ("c1", "c2")},
                             weights_version=steps)
    jlogits = jex.forward_prepared(jparams, jprepared, jeb["images"])
    jnet.prepare({n: jparams[n] for n in ("c1", "c2")},
                 weights_version=steps)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=1e-4, atol=1e-4)
    assert tuple(tconv.prepared_cache_info()) == \
        tuple(jconv.prepared_cache_info()) == (2, 2, 0, 2)
    tconv.clear_prepared_cache()
    jconv.clear_prepared_cache()


def test_trainer_entry_point_on_cpu(capsys):
    """``python -m repro_torch.examples.train_cnn_fftconv`` at its default
    60 steps, batch 4, on the host: the example's three asserts pass."""
    tconv.clear_prepared_cache()
    res = twin.main(["--device", "cpu", "--batch", "4", "--conv-backend",
                     "fft-cuda"])
    out = capsys.readouterr().out
    assert "step   59" in out and "held-out acc" in out
    assert len(res.losses) == 60 and res.losses[-1] < 2.5
    assert res.prepared_cache.hits == 2
    tconv.clear_prepared_cache()


def test_tree_from_jax_checks_names_shapes_and_dtypes():
    like = twin.init_params(0, "cpu")
    tree = {n: t.numpy() for n, t in like.items()}
    out = convert.tree_from_jax(tree, like=like, device="cpu")
    assert all(np.array_equal(out[n].numpy(), tree[n]) for n in tree)
    with pytest.raises(TypeError, match="float32"):
        convert.tree_from_jax({**tree, "b": tree["b"].astype(np.float64)},
                              device="cpu")
    with pytest.raises(ValueError, match="expected"):
        convert.tree_from_jax({**tree, "w": tree["w"][:-1]}, like=like,
                              device="cpu")
    with pytest.raises(ValueError, match="names differ"):
        convert.tree_from_jax({"c1": tree["c1"]}, like=like, device="cpu")
    with pytest.raises(ValueError, match="OIHW"):
        convert.tree_from_jax({"x": np.zeros((2, 2, 2), np.float32)},
                              device="cpu")
