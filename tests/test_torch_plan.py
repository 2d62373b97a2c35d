"""repro_torch.conv's planner against repro.conv's: one-shot and prepared
execution of ``fft-torch`` / ``fft-cuda`` (kernels' plain versions on the
CPU) against ``fft-xla`` / ``fft-pallas`` and the direct oracle, the
auto backend pick, the plan and prepared caches after the same call
sequence, the stage-op counts, the CGEMM tile pin (``bm``/``bn``/``bk``),
the knobs that are not ported yet, and the conversion of parameters and
prepared slabs.  Outputs are held to 1e-4 against JAX (same algorithm,
float32) and 3e-4 against the oracle (as the JAX package's own plan
tests)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

import jax.numpy as jnp

import repro.conv as jconv
import repro_torch.conv as tconv
from repro_torch import convert
from repro_torch.core.fftconv import conv2d_direct
from repro_torch.kernels.cgemm.ops import SHAPES

TWINS = [("fft-torch", "fft-xla"), ("fft-cuda", "fft-pallas")]


def _rand(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _t(a):
    return torch.from_numpy(a)


@pytest.mark.parametrize("backend,jax_backend", TWINS)
@pytest.mark.parametrize("prepared", [False, True])
@pytest.mark.parametrize("epilogue", [False, True])
def test_plan_matches_jax_and_oracle(backend, jax_backend, prepared,
                                     epilogue):
    x, k, b = _rand((2, 3, 18, 18), 1), _rand((4, 3, 3, 3), 2), \
        _rand((4,), 3)
    ep_kw = dict(bias=True, activation="relu") if epilogue else {}
    plan = tconv.plan_conv(x.shape, k.shape, padding=1, backend=backend,
                           epilogue=tconv.Epilogue(**ep_kw))
    jplan = jconv.plan_conv(x.shape, k.shape, padding=1,
                            backend=jax_backend,
                            epilogue=jconv.Epilogue(**ep_kw))
    bias = {"bias": _t(b)} if epilogue else {}
    jbias = {"bias": jnp.asarray(b)} if epilogue else {}
    if prepared:
        y = plan.prepare(_t(k))(_t(x), **bias)
        yj = jplan.prepare(jnp.asarray(k))(jnp.asarray(x), **jbias)
    else:
        y = plan(_t(x), _t(k), **bias)
        yj = jplan(jnp.asarray(x), jnp.asarray(k), **jbias)
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), rtol=1e-4,
                               atol=1e-4)
    y0 = conv2d_direct(_t(x), _t(k), padding=1)
    if epilogue:
        y0 = torch.relu(y0 + _t(b)[None, :, None, None])
    np.testing.assert_allclose(y.numpy(), y0.numpy(), rtol=3e-4, atol=3e-4)


@pytest.mark.parametrize("backend,jax_backend,tol", [
    ("fft-torch", "fft-xla", 1e-4),
    # the kernels round Z to bf16, and Pallas forms the 3M sums Dr+Di,
    # Gr+Gi in bf16 where the CUDA kernel keeps them in float32
    ("fft-cuda", "fft-pallas", 5e-2)])
@pytest.mark.parametrize("three_m", [True, False])
def test_bf16_compute_dtype_matches_jax(backend, jax_backend, tol, three_m):
    """compute_dtype=bf16 reaches the hot stage (the cgemm_dtype fact) and
    agrees with the JAX twin's bf16 plan, relative to the output's
    scale."""
    x, k = _rand((1, 4, 16, 16), 4), _rand((6, 4, 3, 3), 5)
    plan = tconv.plan_conv(x.shape, k.shape, padding=1, backend=backend,
                           three_m=three_m, compute_dtype=torch.bfloat16)
    jplan = jconv.plan_conv(x.shape, k.shape, padding=1,
                            backend=jax_backend, three_m=three_m,
                            compute_dtype=jnp.bfloat16)
    with tconv.stage_trace() as counts:
        y = plan(_t(x), _t(k))
    assert counts[("cgemm_dtype", "bfloat16")] == 1
    yj = np.asarray(jplan(jnp.asarray(x), jnp.asarray(k)))
    scale = np.abs(yj).max()
    np.testing.assert_allclose(y.numpy() / scale, yj / scale, atol=tol)


def test_complex_spectrum_and_residual_epilogue():
    """The full-spectrum twin and a residual epilogue (composed stage-4
    path, not the fused kernel) on fft-cuda match fft-pallas."""
    x, k = _rand((2, 3, 12, 12), 6), _rand((5, 3, 3, 3), 7)
    b, r = _rand((5,), 8), _rand((2, 5, 12, 12), 9)
    ep = dict(bias=True, activation="gelu", residual=True)
    plan = tconv.plan_conv(x.shape, k.shape, padding=1, backend="fft-cuda",
                           spectrum="complex",
                           epilogue=tconv.Epilogue(**ep))
    jplan = jconv.plan_conv(x.shape, k.shape, padding=1,
                            backend="fft-pallas", spectrum="complex",
                            epilogue=jconv.Epilogue(**ep))
    y = plan(_t(x), _t(k), bias=_t(b), residual=_t(r))
    yj = jplan(*map(jnp.asarray, (x, k)), bias=jnp.asarray(b),
               residual=jnp.asarray(r))
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), rtol=1e-4,
                               atol=1e-4)


def test_auto_backend_picks_like_jax():
    """1x1 layers go direct; a wide 3x3 layer goes to the FFT (fft-torch
    here where JAX says fft-xla)."""
    small = ((1, 8, 16, 16), (8, 8, 1, 1))
    wide = ((4, 256, 56, 56), (256, 256, 3, 3))
    assert tconv.plan_conv(*small).backend == "direct"
    assert jconv.plan_conv(*small).backend == "direct"
    assert tconv.plan_conv(*wide, padding=1).backend == "fft-torch"
    assert jconv.plan_conv(*wide, padding=1).backend == "fft-xla"
    x, k = _rand(small[0], 10), _rand(small[1], 11)
    np.testing.assert_allclose(
        tconv.plan_conv(*small)(_t(x), _t(k)).numpy(),
        np.asarray(jconv.plan_conv(*small)(jnp.asarray(x), jnp.asarray(k))),
        rtol=1e-5, atol=1e-5)


def _cache_sequence(conv, asarray, k1, k2):
    conv.clear_plan_cache()
    conv.clear_prepared_cache()
    shapes = ((2, 3, 16, 16), (4, 3, 3, 3))
    plan = conv.plan_conv(*shapes, padding=1, backend="fft-xla"
                          if conv is jconv else "fft-torch")
    again = conv.plan_conv(*shapes, padding=1, backend=plan.backend)
    assert again is plan
    conv.plan_conv((2, 3, 17, 16), (4, 3, 3, 3), padding=1,
                   backend=plan.backend)
    k1, k2 = asarray(k1), asarray(k2)
    p1 = plan.prepare(k1, weights_version=1)
    assert plan.prepare(k1, weights_version=1) is p1        # hit
    plan.prepare(k2, weights_version=2)                     # miss
    assert plan.prepare(k1, weights_version=2) is not p1    # invalidation
    plan.prepare(k1)                                        # never cached
    out = (tuple(conv.plan_cache_info()), tuple(conv.prepared_cache_info()))
    conv.clear_plan_cache()
    conv.clear_prepared_cache()
    return out


def test_cache_counts_follow_jax():
    k1, k2 = _rand((4, 3, 3, 3), 12), _rand((4, 3, 3, 3), 13)
    ours = _cache_sequence(tconv, _t, k1, k2)
    theirs = _cache_sequence(jconv, jnp.asarray, k1, k2)
    assert ours == theirs == ((1, 2, 2), (1, 3, 1, 2))


def test_stage_counts_one_shot_and_prepared():
    x, k = _rand((1, 2, 12, 12), 14), _rand((3, 2, 3, 3), 15)
    plan = tconv.plan_conv(x.shape, k.shape, padding=1, backend="fft-cuda",
                           epilogue=tconv.Epilogue(bias=True,
                                                   activation="relu"))
    b = _t(_rand((3,), 16))
    with tconv.stage_trace() as full:
        plan(_t(x), _t(k), bias=b)
    for op in ("input_transform", "kernel_transform", "cgemm",
               "output_inverse"):
        assert full[op] == 1
    assert full[("cgemm_dtype", "float32")] == 1
    assert full[("cgemm_shape", (plan.spec.M, 3, 2))] == 1
    with tconv.stage_trace() as prep:
        prepared = plan.prepare(_t(k))
    with tconv.stage_trace() as exe:
        prepared(_t(x), bias=b)
        prepared(_t(x), bias=b)
    assert prep["kernel_transform"] == 1 and "cgemm" not in prep
    assert exe.get("kernel_transform", 0) == 0 and exe["cgemm"] == 2


@pytest.mark.parametrize("kwargs", [
    dict(backend="tuned", mesh=object()),
    dict(backend="tuned", schedule="nfft"),
    dict(backend="tuned", schedule="wfft"),
    dict(backend="fft-cuda", dft_bt=128),
])
def test_not_ported_knobs_raise(kwargs):
    """The knobs that were not ported before the tuner over the sharded
    schedules and ``dft_bt`` are now taken; each case here is their
    invalid form, refused as the reference refuses it: a mesh that is not
    a ``DeviceMesh``, a sharded schedule without a mesh (refused before a
    sweep), a ``dft_bt`` the inverse kernel was not compiled at."""
    if "mesh" in kwargs:
        error, match = TypeError, "DeviceMesh"
    elif "schedule" in kwargs:
        error, match = ValueError, f"schedule '{kwargs['schedule']}' " \
                                   "requires a mesh"
    else:
        error, match = ValueError, r"not compiled.*\(4, 8, 16\)"
    with pytest.raises(error, match=match):
        tconv.plan_conv((1, 3, 16, 16), (4, 3, 3, 3), padding=1, **kwargs)


@pytest.mark.parametrize("backend", ["direct", "fft-torch", "fft-cuda"])
def test_mesh_axis_knobs_are_taken_on_local_plans(backend):
    """data_axis/model_axis/replicate_kernel_transform are plan knobs
    with the reference's defaults; a local plan takes them (they matter
    only on a mesh)."""
    shape, kshape = (1, 3, 16, 16), (4, 3, 3, 3)
    kw = dict(data_axis="dp", model_axis="tp",
              replicate_kernel_transform=True)
    plan = tconv.plan_conv(shape, kshape, padding=1, backend=backend, **kw)
    jplan = jconv.plan_conv(shape, kshape, padding=1, backend="fft-xla"
                            if backend != "direct" else "direct", **kw)
    for name, value in kw.items():
        assert getattr(plan, name) == getattr(jplan, name) == value
    default = tconv.plan_conv(shape, kshape, padding=1, backend=backend)
    assert (default.data_axis, default.model_axis,
            default.replicate_kernel_transform) == ("data", "model", False)
    x, k = _rand(shape, 21), _rand(kshape, 22)
    np.testing.assert_array_equal(plan(_t(x), _t(k)).numpy(),
                                  default(_t(x), _t(k)).numpy())


@pytest.mark.parametrize("backend", ["direct", "fft-torch", "fft-cuda"])
def test_slab_overlap_on_a_local_plan_raises_the_reference_error(backend):
    shape, kshape = (4, 3, 16, 16), (4, 3, 3, 3)
    with pytest.raises(ValueError) as theirs:
        jconv.plan_conv(shape, kshape, padding=1, overlap="slab:2",
                        backend="fft-xla" if backend != "direct"
                        else "direct")
    with pytest.raises(ValueError) as ours:
        tconv.plan_conv(shape, kshape, padding=1, overlap="slab:2",
                        backend=backend)
    assert "requires a sharded stage-pipeline schedule" in str(ours.value)
    assert str(ours.value) == str(theirs.value).replace(
        "'fft-xla'", f"'{backend}'")


@pytest.mark.parametrize("backend", ["direct", "fft-torch", "fft-cuda"])
def test_dft_bt_pin_is_checked_stored_and_keyed(backend):
    """``plan_conv(dft_bt=)`` takes a value the inverse kernel was
    compiled at, stores it (on ``direct`` and ``fft-torch`` stored and
    unused, as in the reference), shows it in ``describe()`` as the
    reference does, and keys the plan cache with it; a value not compiled
    is a ValueError naming the compiled ones."""
    shp = ((1, 3, 16, 16), (4, 3, 3, 3))
    jbackend = {"direct": "direct", "fft-torch": "fft-xla",
                "fft-cuda": "fft-pallas"}[backend]
    p16 = tconv.plan_conv(*shp, padding=1, backend=backend, dft_bt=16)
    jp16 = jconv.plan_conv(*shp, padding=1, backend=jbackend, dft_bt=16)
    assert p16.dft_bt == jp16.dft_bt == 16
    assert "dft_bt=16" in p16.describe() and "dft_bt=16" in jp16.describe()
    assert tconv.plan_conv(*shp, padding=1, backend=backend,
                           dft_bt=16) is p16
    assert tconv.plan_conv(*shp, padding=1, backend=backend,
                           dft_bt=4) is not p16
    assert tconv.plan_conv(*shp, padding=1, backend=backend).dft_bt is None
    # the dx plan of training launches its inverse at the forward's pin
    from repro_torch.conv import autodiff
    assert autodiff._transposed_plan(p16).dft_bt == 16
    with pytest.raises(ValueError, match=r"not compiled.*\(4, 8, 16\)"):
        tconv.plan_conv(*shp, padding=1, backend=backend, dft_bt=64)


def _spy_cgemm(monkeypatch):
    """Record the ``shape=`` of every ``cgemm_cuda`` call."""
    from repro_torch.kernels import cgemm
    seen, real = [], cgemm.cgemm_cuda

    def spy(*args, **kwargs):
        seen.append(kwargs.get("shape"))
        return real(*args, **kwargs)
    monkeypatch.setattr(cgemm, "cgemm_cuda", spy)
    return seen


@pytest.mark.parametrize("row", range(len(SHAPES)))
def test_cgemm_pin_reaches_the_kernel(monkeypatch, row):
    """bm alone names a row of the kernel's tile table: the plan stores
    the row's full triple, and the row reaches ``cgemm_cuda`` on the
    forward plan and on the dx plan of its VJP; the output is the
    unpinned plan's."""
    x, k = _rand((2, 3, 18, 18), 31), _rand((4, 3, 3, 3), 32)
    base = tconv.plan_conv(x.shape, k.shape, padding=1,
                           backend="fft-cuda")(_t(x), _t(k))
    seen = _spy_cgemm(monkeypatch)
    plan = tconv.plan_conv(x.shape, k.shape, padding=1, backend="fft-cuda",
                           bm=SHAPES[row][0], cache=False)
    assert (plan.bm, plan.bn, plan.bk) == SHAPES[row][:3]
    xg = _t(x).requires_grad_()
    y = plan(xg, _t(k))
    assert seen == [row]
    y.sum().backward()
    assert seen == [row, row]                  # forward, then dx
    assert torch.equal(y.detach(), base)
    seen.clear()
    tconv.plan_conv(x.shape, k.shape, padding=1, backend="fft-cuda",
                    cache=False)(_t(x), _t(k))
    assert seen == [None]                      # unpinned: the chooser


def test_cgemm_pin_is_in_the_plan_cache_key():
    shape, kshape = (1, 3, 16, 16), (4, 3, 3, 3)
    free = tconv.plan_conv(shape, kshape, padding=1, backend="fft-cuda")
    pinned = tconv.plan_conv(shape, kshape, padding=1, backend="fft-cuda",
                             bm=8)
    assert pinned is not free and pinned != free
    assert tconv.plan_conv(shape, kshape, padding=1, backend="fft-cuda",
                           bm=8) is pinned
    # the full triple names the same row: an equal plan
    assert tconv.plan_conv(shape, kshape, padding=1, backend="fft-cuda",
                           bm=8, bn=128, bk=16) == pinned
    assert "blocks bm=8 bn=128 bk=16" in pinned.describe()
    assert "blocks" not in free.describe()


@pytest.mark.parametrize("pins", [
    dict(bm=12), dict(bk=16), dict(bn=128), dict(bm=64, bn=128),
    dict(bm=True), dict(bm="64")])
def test_illegal_cgemm_pin_lists_the_table(pins):
    with pytest.raises(ValueError, match=r"tile table; its rows are 0: "
                                         r"\(bm=64, bn=64, bk=16\)"):
        tconv.plan_conv((1, 3, 16, 16), (4, 3, 3, 3), padding=1,
                        backend="fft-cuda", cache=False, **pins)


@pytest.mark.parametrize("backend", ["direct", "fft-torch"])
def test_pins_are_stored_unused_off_fft_cuda(backend):
    """As the reference does for fft-xla: the knobs ride on the plan and
    change nothing."""
    x, k = _rand((1, 3, 16, 16), 33), _rand((4, 3, 3, 3), 34)
    plan = tconv.plan_conv(x.shape, k.shape, padding=1, backend=backend,
                           bm=12, bk=7, cache=False)
    assert (plan.bm, plan.bn, plan.bk) == (12, None, 7)
    base = tconv.plan_conv(x.shape, k.shape, padding=1, backend=backend)
    assert torch.equal(plan(_t(x), _t(k)), base(_t(x), _t(k)))


@pytest.mark.parametrize("delta", [33, 48])
def test_fft_cuda_refuses_delta_beyond_its_kernels(delta):
    """fft-cuda is refused at planning time beyond the tile DFT kernels'
    delta <= 32 (plan_network too); fft-torch runs those deltas and
    matches the JAX fft-xla there."""
    x, k = _rand((1, 2, 40, 40), 11), _rand((3, 2, 3, 3), 12)
    with pytest.raises(ValueError, match=r"fft-cuda.*delta <= 32"):
        tconv.plan_conv(x.shape, k.shape, padding=1, delta=delta,
                        backend="fft-cuda")
    layers = [tconv.NetworkConv("c1", x.shape, k.shape, 1)]
    with pytest.raises(ValueError, match=r"fft-cuda.*delta <= 32"):
        tconv.plan_network(layers, backend="fft-cuda", delta=delta)
    plan = tconv.plan_conv(x.shape, k.shape, padding=1, delta=delta,
                           backend="fft-torch")
    jplan = jconv.plan_conv(x.shape, k.shape, padding=1, delta=delta,
                            backend="fft-xla")
    y = plan(_t(x), _t(k))
    np.testing.assert_allclose(y.numpy(), np.asarray(jplan(
        jnp.asarray(x), jnp.asarray(k))), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        y.numpy(), conv2d_direct(_t(x), _t(k), padding=1).numpy(),
        rtol=3e-4, atol=3e-4)


@pytest.mark.parametrize("backend", ["direct", "fft-torch", "fft-cuda"])
def test_overlap_auto_is_off_on_a_local_plan(backend):
    """As in the reference, "auto" resolves to "off" on a local plan
    before the plan-cache key: one plan for both."""
    shape, kshape = (1, 3, 16, 16), (4, 3, 3, 3)
    off = tconv.plan_conv(shape, kshape, padding=1, backend=backend)
    auto = tconv.plan_conv(shape, kshape, padding=1, backend=backend,
                           overlap="auto")
    assert auto is off
    jauto = jconv.plan_conv(shape, kshape, padding=1, overlap="auto",
                            backend="fft-xla" if backend != "direct"
                            else "direct")
    assert jauto.overlap == "off"


@pytest.mark.parametrize("overlap", ["slab:1", "bogus", "slab:x", "slab:"])
def test_malformed_overlap_raises_value_error(overlap):
    """Malformed values are a ValueError with the reference's message."""
    shape, kshape = (1, 3, 16, 16), (4, 3, 3, 3)
    with pytest.raises(ValueError) as theirs:
        jconv.plan_conv(shape, kshape, padding=1, overlap=overlap)
    with pytest.raises(ValueError) as ours:
        tconv.plan_conv(shape, kshape, padding=1, overlap=overlap)
    assert str(ours.value) == str(theirs.value)


def test_fft_plans_are_forward_only():
    """Forward only where no grad is asked for: under torch.no_grad(), or
    with no operand requiring grad, an FFT plan records nothing for
    autograd.  With grad mode on and an operand requiring grad it trains
    through the plan-level VJP (tests/test_torch_grad.py holds the grads
    against JAX), like direct through native autograd."""
    x, k = _rand((1, 2, 10, 10), 17), _rand((3, 2, 3, 3), 18)
    plan = tconv.plan_conv(x.shape, k.shape, padding=1, backend="fft-cuda")
    xg = _t(x).requires_grad_()
    with torch.no_grad():
        assert plan(xg, _t(k)).grad_fn is None
        assert plan.prepare(_t(k))(xg).grad_fn is None
    assert plan(_t(x), _t(k)).grad_fn is None
    assert plan.differentiable
    plan(xg, _t(k)).sum().backward()
    plan.prepare(_t(k))(xg).sum().backward()
    assert xg.grad is not None
    direct = tconv.plan_conv(x.shape, k.shape, padding=1, backend="direct")
    assert direct.differentiable
    xg.grad = None
    direct(xg, _t(k)).sum().backward()
    assert xg.grad is not None


def test_netplan_prepares_once_per_version():
    layers = [tconv.NetworkConv("a", (1, 3, 12, 12), (4, 3, 3, 3), 1),
              tconv.NetworkConv("b", (1, 4, 12, 12), (4, 4, 3, 3), 1)]
    net = tconv.plan_network(layers, backend="fft-cuda")
    params = {"a": _t(_rand((4, 3, 3, 3), 19)),
              "b": _t(_rand((4, 4, 3, 3), 20))}
    with tconv.stage_trace() as counts:
        p0 = net.prepare(params, weights_version=0)
        p0b = net.prepare(params, weights_version=0)
    assert counts["kernel_transform"] == 2
    assert all(p0[n] is p0b[n] for n in net)
    assert "2 layers" in net.describe()
    with pytest.raises(ValueError, match="missing kernels"):
        net.prepare({"a": params["a"]})
    tconv.clear_prepared_cache()


def test_convert_carries_params_and_prepared_slab():
    """params_from_jax keeps values exactly; prepared_from_jax turns the
    JAX prepared state into the slab the port's stage 2 produces (1e-5),
    and executing against it gives the port's output."""
    k, b, x = _rand((4, 3, 3, 3), 21), _rand((4,), 22), _rand((1, 3, 14, 14),
                                                               23)
    ks, bs = convert.params_from_jax({"c": k}, {"c": b}, device="cpu")
    assert np.array_equal(ks["c"].numpy(), k)
    assert np.array_equal(bs["c"].numpy(), b)
    plan = tconv.plan_conv(x.shape, k.shape, padding=1, backend="fft-cuda")
    jplan = jconv.plan_conv(x.shape, k.shape, padding=1,
                            backend="fft-pallas")
    jstate = [np.asarray(g) for g in jplan.prepare(jnp.asarray(k)).state]
    slab = convert.prepared_from_jax(jstate, plan, device="cpu")
    ours = plan.prepare(ks["c"])
    for a, c in zip(slab, ours.state):
        np.testing.assert_allclose(a.numpy(), c.numpy(), rtol=1e-5,
                                   atol=1e-5)
    y = tconv.PreparedConv(plan=plan, state=slab)(_t(x))
    np.testing.assert_allclose(y.numpy(), ours(_t(x)).numpy(), rtol=1e-5,
                               atol=1e-5)
    with pytest.raises(TypeError, match="float32"):
        convert.params_from_jax({"c": k.astype(np.float64)}, {"c": b},
                                device="cpu")
    with pytest.raises(ValueError, match="expected"):
        convert.prepared_from_jax([g[:-1] for g in jstate], plan,
                                  device="cpu")
