"""Training through repro_torch's FFT plans, held against repro.

The plan-level VJP (``repro_torch.conv.autodiff``) on ``fft-torch`` and
``fft-cuda`` (the kernels' plain versions on the CPU) against ``jax.grad``
through ``fft-xla`` / ``fft-pallas`` (Pallas in interpret mode) and against
the ``direct`` oracle, on the same numpy inputs: dx and dk of one-shot
plans, d_bias and d_residual under each activation, prepared plans, grad
of grad, which stage ops the backward runs, and a frozen FFT layer feeding
a trainable one.  Grads are held to rtol = atol = 3e-4 (float32, the
tolerance of the JAX package's own grad tests against the oracle).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

import jax
import jax.numpy as jnp

import repro.conv as jconv
import repro_torch.conv as tconv
from repro.core import conv2d_direct as j_direct
from repro_torch.core.fftconv import conv2d_direct

TWINS = [("fft-torch", "fft-xla"), ("fft-cuda", "fft-pallas")]
ACTIVATIONS = ["none", "relu", "gelu", "silu"]
TOL = dict(rtol=3e-4, atol=3e-4)


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _grads(f, arrays):
    """Grads of sum(sin(f(*tensors))) w.r.t. every tensor."""
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    torch.sin(f(*ts)).sum().backward()
    return [t.grad.numpy() for t in ts]


def _jgrads(f, arrays):
    g = jax.jit(jax.grad(lambda *a: jnp.sum(jnp.sin(f(*a))),
                         argnums=tuple(range(len(arrays)))))
    return [np.asarray(a) for a in g(*map(jnp.asarray, arrays))]


def _close(ours, theirs, names):
    for a, b, name in zip(ours, theirs, names):
        np.testing.assert_allclose(a, b, err_msg=name, **TOL)


def _close_scaled(ours, theirs, names):
    """``_close`` relative to max|theirs|, for grads that sum many
    products (their entries span orders of magnitude)."""
    _close([a / np.abs(b).max() for a, b in zip(ours, theirs)],
           [b / np.abs(b).max() for b in theirs], names)


@pytest.mark.parametrize("backend,jax_backend", TWINS)
def test_local_grads_match_jax_and_oracle(backend, jax_backend):
    x, k = _rand((2, 3, 12, 12), 1), _rand((4, 3, 3, 3), 2)
    plan = tconv.plan_conv(x.shape, k.shape, padding=1, backend=backend)
    jplan = jconv.plan_conv(x.shape, k.shape, padding=1, backend=jax_backend)
    assert plan.differentiable and jplan.differentiable
    g = _grads(plan, (x, k))
    _close(g, _jgrads(jplan, (x, k)), ("dx", "dk"))
    _close(g, _grads(lambda a, b: conv2d_direct(a, b, padding=1), (x, k)),
           ("dx", "dk"))


@pytest.mark.parametrize("backend,jax_backend", TWINS)
@pytest.mark.parametrize("activation", ACTIVATIONS)
def test_epilogue_grads_match_jax_and_oracle(backend, jax_backend,
                                             activation):
    """d(x, k, bias, residual) through a fused bias + residual +
    activation plan."""
    x, k = _rand((1, 2, 12, 12), 3), _rand((3, 2, 3, 3), 4)
    b, r = _rand((3,), 5), _rand((1, 3, 12, 12), 6)
    kw = dict(bias=True, activation=activation, residual=True)
    plan = tconv.plan_conv(x.shape, k.shape, padding=1, backend=backend,
                           epilogue=tconv.Epilogue(**kw))
    jplan = jconv.plan_conv(x.shape, k.shape, padding=1,
                            backend=jax_backend,
                            epilogue=jconv.Epilogue(**kw))
    names = ("dx", "dk", "dbias", "dresidual")
    g = _grads(lambda a, c, d, e: plan(a, c, bias=d, residual=e),
               (x, k, b, r))
    _close(g, _jgrads(lambda a, c, d, e: jplan(a, c, bias=d, residual=e),
                      (x, k, b, r)), names)

    def oracle(a, c, d, e):
        y = conv2d_direct(a, c, padding=1) + d[None, :, None, None] + e
        return tconv.epilogue.ACTIVATIONS[activation](y)
    _close(g, _grads(oracle, (x, k, b, r)), names)


@pytest.mark.parametrize("backend,jax_backend", TWINS)
def test_prepared_grads_match_jax(backend, jax_backend):
    """A PreparedConv is differentiable in x, bias and residual (its kernel
    is frozen)."""
    x, k = _rand((2, 2, 12, 12), 7), _rand((3, 2, 3, 3), 8)
    b, r = _rand((3,), 9), _rand((2, 3, 12, 12), 10)
    kw = dict(bias=True, activation="gelu", residual=True)
    prepared = tconv.plan_conv(
        x.shape, k.shape, padding=1, backend=backend,
        epilogue=tconv.Epilogue(**kw)).prepare(torch.from_numpy(k))
    jprepared = jconv.plan_conv(
        x.shape, k.shape, padding=1, backend=jax_backend,
        epilogue=jconv.Epilogue(**kw)).prepare(jnp.asarray(k))
    g = _grads(lambda a, d, e: prepared(a, bias=d, residual=e), (x, b, r))
    _close(g, _jgrads(lambda a, d, e: jprepared(a, bias=d, residual=e),
                      (x, b, r)), ("dx", "dbias", "dresidual"))


@pytest.mark.parametrize("activation", ["none", "gelu"])
def test_grad_of_grad_runs(activation):
    """The dx rule is a plan call, so a double backward differentiates it;
    values are finite and shaped like x, and with no activation they
    match JAX's grad of grad."""
    x, k = _rand((1, 2, 10, 10), 11), _rand((2, 2, 3, 3), 12)
    ep = dict(activation=activation)
    plan = tconv.plan_conv(x.shape, k.shape, padding=1, backend="fft-cuda",
                           epilogue=tconv.Epilogue(**ep))
    xt, kt = torch.from_numpy(x).requires_grad_(), torch.from_numpy(k)
    (g,) = torch.autograd.grad((plan(xt, kt) ** 2).sum(), xt,
                               create_graph=True)
    (gg,) = torch.autograd.grad((g ** 2).sum(), xt)
    assert gg.shape == xt.shape and bool(torch.isfinite(gg).all())
    if activation == "none":
        jplan = jconv.plan_conv(x.shape, k.shape, padding=1,
                                backend="fft-xla")
        kj = jnp.asarray(k)
        ggj = jax.grad(lambda a: jnp.sum(jax.grad(
            lambda c: jnp.sum(jplan(c, kj) ** 2))(a) ** 2))(jnp.asarray(x))
        np.testing.assert_allclose(gg.numpy(), np.asarray(ggj), **TOL)


def test_backward_runs_only_the_grads_asked_for():
    """No transposed-plan CGEMM when x needs no grad: one forward plan,
    dk by direct correlation; with x needing grad, the dx plan's four
    stage ops run too."""
    x, k = _rand((1, 2, 12, 12), 13), _rand((3, 2, 3, 3), 14)
    plan = tconv.plan_conv(x.shape, k.shape, padding=1, backend="fft-cuda")
    kt = torch.from_numpy(k).requires_grad_()
    with tconv.stage_trace() as counts:
        plan(torch.from_numpy(x), kt).sum().backward()
    assert counts["cgemm"] == 1 and counts["output_inverse"] == 1
    assert kt.grad is not None
    xt = torch.from_numpy(x).requires_grad_()
    with tconv.stage_trace() as counts:
        plan(xt, kt).sum().backward()
    for op in ("input_transform", "kernel_transform", "cgemm",
               "output_inverse"):
        assert counts[op] == 2, op
    assert counts[("cgemm_shape", (plan.spec.M, 2, 3))] == 1   # dx plan


@pytest.mark.parametrize("backend", ["fft-torch", "fft-cuda"])
def test_no_grad_runs_the_forward_unchanged(backend):
    """Under torch.no_grad() a plan runs its pipeline straight: the same
    stage counts and the same output as under torch.inference_mode(), and
    nothing for autograd."""
    x, k, b = _rand((1, 3, 14, 14), 15), _rand((4, 3, 3, 3), 16), \
        _rand((4,), 17)
    plan = tconv.plan_conv(x.shape, k.shape, padding=1, backend=backend,
                           epilogue=tconv.Epilogue(bias=True,
                                                   activation="relu"))
    ops = [torch.from_numpy(a).requires_grad_() for a in (x, k, b)]
    with torch.inference_mode(), tconv.stage_trace() as c0:
        y0 = plan(*ops[:2], bias=ops[2])
    with torch.no_grad(), tconv.stage_trace() as c1:
        y1 = plan(*ops[:2], bias=ops[2])
    assert dict(c0) == dict(c1)
    assert c1["cgemm"] == 1 and c1["output_inverse"] == 1
    assert y1.grad_fn is None and not y1.is_inference()
    assert torch.equal(y0, y1)


@pytest.mark.parametrize("head,jax_head", [("direct", "direct"),
                                           ("fft-cuda", "fft-pallas")])
@pytest.mark.parametrize("prepared", [False, True])
def test_frozen_fft_layer_feeds_a_trainable_layer(prepared, head, jax_head):
    """A frozen fft-cuda layer (its kernel needs no grad) feeding a
    trainable layer: backward runs, and the trainable layer's grads match
    the same net in JAX.  The frozen layer's output must not be an
    inference tensor, or the next layer could not save it for backward."""
    x, k1 = _rand((2, 3, 12, 12), 18), _rand((4, 3, 3, 3), 19)
    k2, b2 = _rand((5, 4, 3, 3), 20), _rand((5,), 21)
    ep = dict(bias=True, activation="relu")
    frozen = tconv.plan_conv(x.shape, k1.shape, padding=1,
                             backend="fft-cuda")
    trainable = tconv.plan_conv((2, 4, 12, 12), k2.shape, padding=1,
                                backend=head, epilogue=tconv.Epilogue(**ep))
    k1t = torch.from_numpy(k1)
    layer1 = frozen.prepare(k1t) if prepared else \
        (lambda a: frozen(a, k1t))
    g = _grads(lambda a, c: trainable(layer1(torch.from_numpy(x)), a,
                                      bias=c), (k2, b2))
    jfrozen = jconv.plan_conv(x.shape, k1.shape, padding=1,
                              backend="fft-pallas")
    jtrainable = jconv.plan_conv((2, 4, 12, 12), k2.shape, padding=1,
                                 backend=jax_head,
                                 epilogue=jconv.Epilogue(**ep))
    # relative to each grad's scale: dk sums 288 products of the frozen
    # layer's output, whose own float32 FFT error it carries
    h = jfrozen(jnp.asarray(x), jnp.asarray(k1))
    _close_scaled(g, _jgrads(lambda a, c: jtrainable(h, a, bias=c),
                             (k2, b2)), ("dk", "dbias"))
    h0 = j_direct(jnp.asarray(x), jnp.asarray(k1), padding=1)
    _close_scaled(g, _jgrads(lambda a, c: jax.nn.relu(
        j_direct(h0, a, padding=1) + c[None, :, None, None]), (k2, b2)),
        ("dk", "dbias"))


def test_inference_mode_features_train_an_fft_layer():
    """Features computed under torch.inference_mode() (inference tensors)
    feed a trainable fft-cuda layer: the VJP saves a clone of them for dk,
    since autograd refuses to save an inference tensor; dk and d_bias
    match the same layer on direct (fed a normal tensor: cuDNN's own
    autograd would refuse the inference one)."""
    x, k, b = _rand((2, 3, 12, 12), 22), _rand((4, 3, 3, 3), 23), \
        _rand((4,), 24)
    ep = tconv.Epilogue(bias=True, activation="silu")
    with torch.inference_mode():
        feats = torch.from_numpy(x) * 1.0
    assert feats.is_inference()
    grads = []
    for backend, inp in (("fft-cuda", feats),
                         ("direct", torch.from_numpy(x))):
        plan = tconv.plan_conv(x.shape, k.shape, padding=1, backend=backend,
                               epilogue=ep)
        kt, bt = (torch.from_numpy(a).requires_grad_() for a in (k, b))
        torch.sin(plan(inp, kt, bias=bt)).sum().backward()
        grads.append([kt.grad.numpy(), bt.grad.numpy()])
    _close(*grads, ("dk", "dbias"))
