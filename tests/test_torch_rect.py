"""The rect-layout tile-DFT path of the port against the JAX package.

The rect layout is the (delta, delta//2 + 1) rfft2 grid, P = 144 at
delta = 16: the default ``spectrum`` of the raw stage primitives, which no
plan uses.  On the CPU each rect wrapper runs its kernel's plain PyTorch
version; those are held to the JAX package's Pallas wrappers in interpret
mode, on the same numpy inputs:

- ``tile_fft_cuda`` / ``tile_ifft_cuda`` against ``tile_fft_pallas`` /
  ``tile_ifft_pallas``: delta in {5, 8, 15, 16}, n in {1, 7, 300} (the
  Pallas wrappers pad n to their block), 1e-4 relative to max|T| or
  max|y|;
- ``tile_ifft_epilogue_cuda`` against ``tile_ifft_epilogue_pallas``: every
  activation, delta in {8, 15, 16}, 1e-4;
- ``backends._cuda_fused_inverse`` against ``_pallas_fused_inverse`` under
  every activation, 1e-4;
- the whole rect stage path (the ``tile_fft`` hooks, ``cgemm_cuda`` and
  ``_cuda_fused_inverse``, or the unfused ``tile_ifft`` route) against the
  JAX stage ops at rect with ``cgemm_pallas`` and ``_pallas_fused_inverse``
  and against the direct oracle, 1e-4 relative to max|y|.

tests/test_torch_cuda.py holds the CUDA kernels themselves to these plain
versions on the card.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

import jax.numpy as jnp

from repro.conv import backends as jbackends
from repro.conv import epilogue as jep
from repro.conv import stages as jstages
from repro.core.conv_spec import ConvSpec as JConvSpec
from repro.kernels.cgemm import cgemm_pallas
from repro.kernels.dft_tile import (
    tile_fft_pallas, tile_ifft_epilogue_pallas, tile_ifft_pallas)
from repro_torch.conv import backends as tbackends
from repro_torch.conv import epilogue as tep
from repro_torch.conv import stages as tstages
from repro_torch.core import fftconv as tF
from repro_torch.kernels.cgemm import cgemm_cuda
from repro_torch.kernels.dft_tile import (
    tile_fft_cuda, tile_ifft_cuda, tile_ifft_epilogue_cuda, tile_irfft_cuda,
    tile_rfft_cuda)

ACTIVATIONS = ["none", "relu", "gelu", "silu"]
TOL = 1e-4


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _rect_planes(n, delta, seed):
    dh = delta // 2 + 1
    return _rand((n, delta, dh), seed), _rand((n, delta, dh), seed + 1)


def _close(ours, theirs, scale=None):
    theirs = np.asarray(theirs)
    scale = scale or float(np.abs(theirs).max()) + 1e-9
    np.testing.assert_allclose(ours.numpy() / scale, theirs / scale,
                               atol=TOL)


# --------------------------------------------------------------------------
# kernels 5, 6 and 7: rect forward, rect inverse, rect inverse + epilogue
# --------------------------------------------------------------------------

TILE_CASES = [(d, n) for d in (5, 8, 15, 16) for n in (1, 7, 300)]


@pytest.mark.parametrize("delta,n", TILE_CASES)
def test_fft_plain_matches_pallas(delta, n):
    x = _rand((n, delta, delta), 300 + delta + n)
    Tr, Ti = tile_fft_cuda(torch.from_numpy(x), delta=delta)
    Jr, Ji = tile_fft_pallas(jnp.asarray(x), delta=delta)
    assert tuple(Tr.shape) == (n, delta, delta // 2 + 1)
    scale = max(np.abs(np.asarray(Jr)).max(), np.abs(np.asarray(Ji)).max())
    _close(Tr, Jr, scale)
    _close(Ti, Ji, scale)


@pytest.mark.parametrize("delta,n", TILE_CASES)
def test_ifft_plain_matches_pallas(delta, n):
    zr, zi = _rect_planes(n, delta, seed=400 + delta + n)
    y = tile_ifft_cuda(torch.from_numpy(zr), torch.from_numpy(zi),
                       delta=delta)
    yj = tile_ifft_pallas(jnp.asarray(zr), jnp.asarray(zi), delta=delta)
    assert tuple(y.shape) == (n, delta, delta)
    _close(y, yj)


@pytest.mark.parametrize("delta", [8, 15, 16])
@pytest.mark.parametrize("activation", ACTIVATIONS)
def test_ifft_epilogue_plain_matches_pallas(delta, activation):
    zr, zi = _rect_planes(7, delta, seed=500 + delta)
    b = _rand((7,), 600 + delta)
    y = tile_ifft_epilogue_cuda(*map(torch.from_numpy, (zr, zi, b)),
                                activation=activation, delta=delta)
    yj = tile_ifft_epilogue_pallas(*map(jnp.asarray, (zr, zi, b)),
                                   activation=activation, delta=delta)
    assert tuple(y.shape) == (7, delta, delta)
    _close(y, yj)


def test_rect_wrappers_refuse_what_the_kernels_do_not_take():
    x = torch.from_numpy(_rand((4, 16, 16), 11))
    zr, zi = map(torch.from_numpy, _rect_planes(3, 16, seed=12))
    b = torch.from_numpy(_rand((3,), 13))
    with pytest.raises(TypeError, match="float32"):
        tile_fft_cuda(x.double())
    with pytest.raises(ValueError, match="contiguous"):
        tile_fft_cuda(x.transpose(1, 2))
    with pytest.raises(ValueError, match="delta <= 32"):
        tile_fft_cuda(torch.zeros((2, 33, 33)), delta=33)
    with pytest.raises(ValueError, match="tiles"):
        tile_fft_cuda(x, delta=8)
    for inverse in (tile_ifft_cuda, functools.partial(
            tile_ifft_epilogue_cuda, bias=b)):
        with pytest.raises(TypeError, match="float32"):
            inverse(zr.double(), zi.double())
        # the layout z_to_tiles gives before it is made contiguous
        with pytest.raises(ValueError, match="contiguous"):
            inverse(zr.transpose(0, 1).contiguous().transpose(0, 1),
                    zi.transpose(0, 1).contiguous().transpose(0, 1))
        with pytest.raises(ValueError, match="delta <= 32"):
            inverse(torch.zeros((3, 33, 17)), torch.zeros((3, 33, 17)),
                    delta=33)
        with pytest.raises(ValueError, match=r"\(n, 16, 9\) planes"):
            inverse(zr.reshape(3, -1), zi.reshape(3, -1))
        with pytest.raises(ValueError, match=r"\(n, 15, 8\) planes"):
            inverse(zr, zi, delta=15)
    with pytest.raises(ValueError, match="one value per tile"):
        tile_ifft_epilogue_cuda(zr, zi, b[:2])
    with pytest.raises(ValueError, match="activation"):
        tile_ifft_epilogue_cuda(zr, zi, b, activation="tanh")
    wrappers = (tile_fft_cuda, tile_ifft_cuda, tile_ifft_epilogue_cuda)
    before = [w.launches for w in wrappers]
    tile_fft_cuda(x)                    # CPU: the plain versions, no launch
    tile_ifft_cuda(zr, zi)
    tile_ifft_epilogue_cuda(zr, zi, b)
    assert [w.launches for w in wrappers] == before


# --------------------------------------------------------------------------
# the rect stage path
# --------------------------------------------------------------------------

# (B, C, H, W), (C', kh, kw), padding, delta: C = 3, a 5x5 kernel, odd delta
GEOMETRIES = [((1, 3, 20, 20), (4, 3, 3), 1, 16),
              ((2, 5, 13, 11), (6, 5, 5), 2, 16),
              ((1, 4, 17, 17), (3, 3, 3), 1, 15)]


def _spec(geom):
    (B, C, H, W), (Co, kh, kw), pad, delta = geom
    return tF.make_spec((B, C, H, W), (Co, C, kh, kw), padding=pad,
                        delta=delta)


def _jspec(spec):
    return JConvSpec(**dataclasses.asdict(spec))


def _operands(spec, seed):
    x = _rand((spec.B, spec.C, spec.H, spec.W), seed)
    k = _rand((spec.Cout, spec.C, spec.kh, spec.kw), seed + 1)
    return x, k, _rand((spec.Cout,), seed + 2)


@pytest.mark.parametrize("activation", ACTIVATIONS)
def test_cuda_fused_inverse_matches_pallas(activation):
    spec = _spec(GEOMETRIES[1])
    Zr, Zi = (_rand((spec.P, spec.M, spec.Cout), 700 + i) for i in (0, 1))
    b = _rand((spec.Cout,), 702)
    y = tbackends._cuda_fused_inverse(
        torch.from_numpy(Zr), torch.from_numpy(Zi), spec,
        tep.Epilogue(bias=True, activation=activation), torch.from_numpy(b))
    yj = jbackends._pallas_fused_inverse(
        jnp.asarray(Zr), jnp.asarray(Zi), _jspec(spec),
        jep.Epilogue(bias=True, activation=activation), jnp.asarray(b))
    assert tuple(y.shape) == (spec.B, spec.Cout, spec.Ho, spec.Wo)
    _close(y, yj)


def _torch_rect_conv(x, k, b, spec, fused):
    """One conv layer through the port's rect stage ops and kernels."""
    ep = tep.Epilogue(bias=True, activation="relu")
    G = tstages.stage_kernel_transform(k, spec, "rect",
                                       tile_fft=tile_fft_cuda)
    D = tstages.stage_input_transform(x, spec, "rect",
                                      tile_fft=tile_fft_cuda)
    Zr, Zi = tstages.stage_cgemm(*D, *G, three_m=True, cgemm_fn=cgemm_cuda)
    if fused:
        return tstages.stage_output_inverse(
            Zr, Zi, spec, epilogue=ep, bias=b,
            inverse_fn=tbackends._cuda_fused_inverse, spectrum="rect")
    return tstages.stage_output_inverse(Zr, Zi, spec, epilogue=ep, bias=b,
                                        tile_ifft=tile_ifft_cuda,
                                        spectrum="rect")


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("geom", GEOMETRIES,
                         ids=["C3", "k5", "delta15"])
def test_rect_stage_path_matches_jax_and_direct(geom, fused):
    spec = _spec(geom)
    x, k, b = _operands(spec, seed=800)
    with tstages.stage_trace() as counts:
        y = _torch_rect_conv(*map(torch.from_numpy, (x, k, b)), spec, fused)
    assert {op: counts[op] for op in ("input_transform", "kernel_transform",
                                      "cgemm", "output_inverse")} == {
        "input_transform": 1, "kernel_transform": 1, "cgemm": 1,
        "output_inverse": 1}
    assert counts[("cgemm_shape", (spec.M, spec.Cout, spec.C))] == 1
    js = _jspec(spec)
    Dj = jstages.stage_input_transform(jnp.asarray(x), js, "rect")
    Gj = jstages.stage_kernel_transform(jnp.asarray(k), js, "rect")
    Zj = jstages.stage_cgemm(*Dj, *Gj, three_m=True, cgemm_fn=cgemm_pallas)
    yj = jstages.stage_output_inverse(
        *Zj, js, epilogue=jep.Epilogue(bias=True, activation="relu"),
        bias=jnp.asarray(b), inverse_fn=jbackends._pallas_fused_inverse,
        spectrum="rect")
    _close(y, yj)
    y0 = torch.relu(tF.conv2d_direct(torch.from_numpy(x),
                                     torch.from_numpy(k),
                                     padding=(spec.pad_h, spec.pad_w))
                    + torch.from_numpy(b)[None, :, None, None])
    _close(y, y0.numpy())


def test_rect_hooks_match_the_plain_transforms():
    """Stages 1 and 2 through the ``tile_fft`` hook give what the plain
    rect transforms give, in the same contiguous (P, M, C) / (P, C, C')
    layout."""
    spec = _spec(GEOMETRIES[0])
    x, k, _ = (torch.from_numpy(a) for a in _operands(spec, seed=900))
    D = tF.input_transform(x, spec, spectrum="rect")
    G = tF.kernel_transform(k, spec, spectrum="rect")
    Dk = tF.input_transform(x, spec, spectrum="rect", tile_fft=tile_fft_cuda)
    Gk = tF.kernel_transform(k, spec, spectrum="rect", tile_fft=tile_fft_cuda)
    for ours, theirs in zip(Dk + Gk, D + G):
        _close(ours, theirs.numpy())
    assert Dk[0].is_contiguous() and Gk[0].is_contiguous()


def test_layout_hooks_refuse_the_other_layout():
    spec = _spec(GEOMETRIES[0])
    x, k, _ = (torch.from_numpy(a) for a in _operands(spec, seed=1000))
    Z = torch.zeros((spec.P, spec.M, spec.Cout))
    for spectrum in ("real", "complex"):
        with pytest.raises(ValueError, match="'rect' layout"):
            tF.input_transform(x, spec, spectrum=spectrum,
                               tile_fft=tile_fft_cuda)
        with pytest.raises(ValueError, match="'rect' layout"):
            tF.kernel_transform(k, spec, spectrum=spectrum,
                                tile_fft=tile_fft_cuda)
        with pytest.raises(ValueError, match="'rect' layout"):
            tstages.stage_output_inverse(Z, Z, spec, spectrum=spectrum,
                                         tile_ifft=tile_ifft_cuda)
    with pytest.raises(ValueError, match="compact 'real' layout"):
        tstages.stage_input_transform(x, spec, "rect",
                                      tile_rfft=tile_rfft_cuda)
    with pytest.raises(ValueError, match="compact 'real' layout"):
        tstages.stage_kernel_transform(k, spec, "rect",
                                       tile_rfft=tile_rfft_cuda)
    with pytest.raises(ValueError, match="compact 'real' layout"):
        tF.output_inverse(Z, Z, spec, spectrum="rect",
                          tile_irfft=tile_irfft_cuda)
