"""repro_torch.core stage primitives against repro.core: the input and
kernel transforms and the output inverse on Table-I geometries (channels
narrowed, spatial extent capped, batch 1-2), the plain CGEMM, the direct
oracle and the epilogue.  Numpy makes every input from a seed; stage
outputs are held to 1e-4 (float32, different summation order)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

import jax
import jax.numpy as jnp

from repro.configs.paper_convs import TABLE1
from repro.conv import epilogue as jep
from repro.core import fftconv as jF
from repro.core.cgemm import cgemm as j_cgemm
from repro_torch.conv import epilogue as tep
from repro_torch.core import fftconv as tF
from repro_torch.core.cgemm import cgemm as t_cgemm

TOL = dict(rtol=1e-4, atol=1e-4)


def _rand(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _narrow(name, batch):
    """A Table-I layer with channels divided by 16 (C=3 kept) and the
    spatial extent capped at 40."""
    l = next(l for l in TABLE1 if l.name == name)
    l = dataclasses.replace(l, C=l.C if l.C == 3 else max(2, l.C // 16),
                            Cout=max(2, l.Cout // 16), H=min(l.H, 40),
                            W=min(l.W, 40))
    return tF.make_spec((batch, l.C, l.H, l.W), (l.Cout, l.C, l.kh, l.kw),
                        padding=l.pad)


GEOMETRIES = [("Vconv1.1", 1), ("Aconv2", 2), ("Aconv3", 1),
              ("Rconv5.2", 2)]
# plans use real/complex; rect is the raw primitives' default
CASES = [(n, b, sp) for n, b in GEOMETRIES for sp in ("real", "complex")] \
    + [("Vconv1.1", 1, "rect"), ("Aconv2", 2, "rect")]


def _jspec(spec):
    from repro.core.conv_spec import ConvSpec
    return ConvSpec(**dataclasses.asdict(spec))


# one XLA compile per JAX stage call instead of one per primitive
_j_input = jax.jit(jF.input_transform, static_argnums=1,
                   static_argnames="spectrum")
_j_kernel = jax.jit(jF.kernel_transform, static_argnums=1,
                    static_argnames="spectrum")
_j_inverse = jax.jit(jF.output_inverse, static_argnums=2,
                     static_argnames="spectrum")


def _close(t_pair, j_pair):
    for t, j in zip(t_pair, j_pair):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


@pytest.mark.parametrize("name,batch,spectrum", CASES)
def test_stages_match_jax(name, batch, spectrum):
    spec = _narrow(name, batch)
    js = _jspec(spec)
    x = _rand((spec.B, spec.C, spec.H, spec.W), 1)
    k = _rand((spec.Cout, spec.C, spec.kh, spec.kw), 2)
    D = tF.input_transform(torch.from_numpy(x), spec, spectrum=spectrum)
    _close(D, _j_input(jnp.asarray(x), js, spectrum=spectrum))
    G = tF.kernel_transform(torch.from_numpy(k), spec, spectrum=spectrum)
    _close(G, _j_kernel(jnp.asarray(k), js, spectrum=spectrum))
    assert D[0].is_contiguous() and G[0].is_contiguous()
    P = tF.freq_count(spec, spectrum)
    assert D[0].shape == (P, spec.M, spec.C)
    assert G[0].shape == (P, spec.C, spec.Cout)
    Zr = _rand((P, spec.M, spec.Cout), 3)
    Zi = _rand((P, spec.M, spec.Cout), 4)
    y = tF.output_inverse(torch.from_numpy(Zr), torch.from_numpy(Zi), spec,
                          spectrum=spectrum)
    yj = _j_inverse(jnp.asarray(Zr), jnp.asarray(Zi), js,
                    spectrum=spectrum)
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), **TOL)


@pytest.mark.parametrize("name,batch", GEOMETRIES)
def test_stage_composition_is_the_convolution(name, batch):
    """Stages 1-4 on the compact layout reproduce the direct oracle."""
    spec = _narrow(name, batch)
    x = torch.from_numpy(_rand((spec.B, spec.C, spec.H, spec.W), 5))
    k = torch.from_numpy(_rand((spec.Cout, spec.C, spec.kh, spec.kw), 6))
    Dr, Di = tF.input_transform(x, spec, spectrum="real")
    Gr, Gi = tF.kernel_transform(k, spec, spectrum="real")
    Zr, Zi = t_cgemm(Dr, Di, Gr, Gi)
    y = tF.output_inverse(Zr, Zi, spec, spectrum="real")
    y0 = tF.conv2d_direct(x, k, padding=(spec.pad_h, spec.pad_w))
    np.testing.assert_allclose(y.numpy(), y0.numpy(), rtol=3e-4, atol=3e-4)


@pytest.mark.parametrize("three_m", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_cgemm_matches_jax(three_m, dtype):
    """The fft-torch stage 3 is the twin of fft-xla's: same 3M/4M algebra,
    float32 accumulation (bf16 operands: exact products, 1e-4)."""
    ops = [_rand((3, 20, 7), 10), _rand((3, 20, 7), 11),
           _rand((3, 7, 9), 12), _rand((3, 7, 9), 13)]
    t_ops = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in ops]
    j_ops = [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in ops]
    Zr, Zi = t_cgemm(*t_ops, three_m=three_m)
    Jr, Ji = j_cgemm(*j_ops, three_m=three_m)
    assert Zr.dtype == torch.float32
    _close((Zr, Zi), (Jr, Ji))


@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("padding", [0, 1, (2, 1)])
def test_conv2d_direct_matches_jax(compute_dtype, padding):
    x, k = _rand((2, 3, 11, 9), 20), _rand((4, 3, 3, 3), 21)
    y = tF.conv2d_direct(
        torch.from_numpy(x), torch.from_numpy(k), padding=padding,
        compute_dtype=compute_dtype and getattr(torch, compute_dtype))
    yj = jF.conv2d_direct(
        jnp.asarray(x), jnp.asarray(k), padding=padding,
        compute_dtype=compute_dtype and getattr(jnp, compute_dtype))
    assert y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), **TOL)


@pytest.mark.parametrize("activation", ["none", "relu", "gelu", "silu"])
@pytest.mark.parametrize("residual", [False, True])
def test_apply_epilogue_matches_jax(activation, residual):
    """Bias, then residual, then the activation (gelu: tanh form); 1e-6."""
    y, b, r = _rand((2, 3, 5, 5), 30), _rand((3,), 31), _rand((2, 3, 5, 5),
                                                             32)
    ep_t = tep.Epilogue(bias=True, activation=activation, residual=residual)
    ep_j = jep.Epilogue(bias=True, activation=activation, residual=residual)
    out = tep.apply_epilogue(torch.from_numpy(y), ep_t,
                             bias=torch.from_numpy(b),
                             residual=torch.from_numpy(r) if residual
                             else None)
    outj = jep.apply_epilogue(jnp.asarray(y), ep_j, bias=jnp.asarray(b),
                              residual=jnp.asarray(r) if residual else None)
    np.testing.assert_allclose(out.numpy(), np.asarray(outj), rtol=1e-6,
                               atol=1e-6)
    assert ep_t.describe() == ep_j.describe()
    assert ep_t.is_noop == ep_j.is_noop


def test_geometry_matches_jax():
    """ConvSpec is a copy: every derived size and cost agrees."""
    for l in TABLE1:
        spec = tF.make_spec((2, l.C, l.H, l.W), (l.Cout, l.C, l.kh, l.kw),
                            padding=l.pad)
        js = jF.make_spec((2, l.C, l.H, l.W), (l.Cout, l.C, l.kh, l.kw),
                          padding=l.pad)
        for attr in ("M", "X", "D", "Hp", "Wp", "Ho", "Wo", "P"):
            assert getattr(spec, attr) == getattr(js, attr)
        for sp in ("rect", "real", "complex"):
            assert spec.freq_points(sp) == js.freq_points(sp)
            assert tF.freq_count(spec, sp) == jF.freq_count(js, sp)
            assert spec.cgemm_flops(True, sp) == js.cgemm_flops(True, sp)
        assert spec.direct_flops() == js.direct_flops()
        assert spec.transform_flops() == js.transform_flops()


def _hooked_input(x, spec, spectrum, dtype=torch.float32):
    """Stage 1 with a recording ``image_rfft``: (result, calls)."""
    calls = []

    def image_rfft(x, spec):
        calls.append(spec)
        return tF.input_transform(x, spec, spectrum="real")
    D = tF.input_transform(x, spec, dtype=dtype, spectrum=spectrum,
                           image_rfft=image_rfft)
    return D, calls


@pytest.mark.parametrize("case", ["taken", "complex", "rect", "delta 8",
                                  "float64 image", "float64 stage"])
def test_input_transform_takes_the_image_hook_where_it_applies(case):
    """Stage 1 hands the image to ``image_rfft`` for the compact layout on
    a float32 image and stage, and composes itself otherwise, with the
    same result; the ``fft-cuda`` backend hands the hook to delta-16 plans
    alone (the image form's tile)."""
    spec = _narrow("Aconv2", 2)
    x = torch.from_numpy(_rand((spec.B, spec.C, spec.H, spec.W), 40))
    if case == "delta 8":
        from repro_torch.conv import plan_conv
        from repro_torch.conv.registry import get_backend
        k_shape = (spec.Cout, spec.C, spec.kh, spec.kw)
        hooks = [get_backend("fft-cuda").make_pipeline(plan_conv(
            x.shape, k_shape, padding=spec.pad_h, delta=delta,
            backend="fft-cuda")).image_rfft for delta in (8, 16)]
        assert hooks[0] is None and hooks[1] is not None
        return
    spectrum = case if case in ("complex", "rect") else "real"
    dtype = torch.float64 if case == "float64 stage" else torch.float32
    if case == "float64 image":
        x = x.double()
    D, calls = _hooked_input(x, spec, spectrum, dtype)
    assert len(calls) == (case == "taken")
    D0 = tF.input_transform(x, spec, dtype=dtype, spectrum=spectrum)
    assert all(torch.equal(a, b) for a, b in zip(D, D0))


@pytest.mark.parametrize("schedule", ["local", "nfft", "wfft"])
def test_image_hook_leaves_stage_counts_and_outputs(schedule):
    """An ``fft-cuda`` plan on the CPU with its pipeline's image hook and
    without it: the same stage counts, CGEMM shapes and collectives, and
    the same output bit for bit (the hook's plain form is the composed
    stage 1)."""
    from repro_torch.conv import Epilogue, plan_conv, stages
    from repro_torch.conv.registry import get_backend
    from repro_torch.launch import mesh as M
    mesh = None
    if schedule != "local":
        M.start_process_group("gloo")
        mesh = M.make_host_mesh(1, 1)
    try:
        x = torch.from_numpy(_rand((2, 3, 20, 20), 41))
        k = torch.from_numpy(_rand((4, 3, 3, 3), 42))
        b = torch.from_numpy(_rand((4,), 43))
        plan = plan_conv(x.shape, k.shape, padding=1, backend="fft-cuda",
                         epilogue=Epilogue(bias=True, activation="relu"),
                         schedule=schedule, mesh=mesh)
        pipe = get_backend("fft-cuda").make_pipeline(plan)
        assert pipe.image_rfft is not None
        runs = []
        for image_rfft in (pipe.image_rfft, None):
            pipe.image_rfft = image_rfft
            with stages.stage_trace() as counts:
                y = pipe.full(plan, x, k, bias=b)
            y = y.full_tensor() if hasattr(y, "full_tensor") else y
            runs.append((dict(counts), y))
        assert runs[0][0] == runs[1][0]
        assert runs[0][0]["input_transform"] == 1
        assert torch.equal(runs[0][1], runs[1][1])
    finally:
        if mesh is not None:
            M.destroy_process_group()
