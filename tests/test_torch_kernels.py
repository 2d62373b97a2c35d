"""The port's kernel wrappers against the JAX package's Pallas kernels.

On the CPU each wrapper runs its kernel's plain PyTorch version; those are
held to ``cgemm_pallas``, ``tile_rfft_pallas``, ``tile_irfft_pallas`` and
``tile_irfft_epilogue_pallas`` running in interpret mode, on the same
numpy inputs:

- CGEMM: the cases of tests/test_kernels.py (ragged dims, C=3), 3M and 4M,
  scaled atol 2e-5; bfloat16 operands at 5e-2 (the Pallas kernel adds its
  K blocks in bf16, the port in float32: they agree within bf16 rounding).
- fused compact inverse + epilogue: every activation, delta in {8, 15,
  16}, with the spectrum padded past P_real, 1e-4.
- forward tile DFT + compact gather and the plain compact inverse: delta
  in {5, 8, 15, 16}, n in {1, 7, 300}, the inverse also with the spectrum
  padded past P_real, 1e-4 (the forward relative to max|T|, whose entries
  grow with delta).
- the forward's image form (stage 1 in one pass): its plain version is
  the composed stage 1 bit for bit, and within 1e-4 of the JAX package's
  stage 1, on strided images too.

tests/test_torch_cuda.py holds the CUDA kernels themselves to these plain
versions on the card.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

import jax.numpy as jnp

from repro.core.dft import num_freq_real
from repro.kernels.cgemm import cgemm_pallas, cgemm_ref as j_cgemm_ref
from repro.kernels.dft_tile import (
    tile_irfft_epilogue_pallas, tile_irfft_pallas, tile_rfft_pallas)
from repro_torch.kernels.cgemm import cgemm_cuda
from repro_torch.kernels.dft_tile import (
    image_rfft_cuda, tile_irfft_cuda, tile_irfft_epilogue_cuda,
    tile_rfft_cuda)


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _operands(P, M, C, N, seed=1):
    return [_rand((P, M, C), seed), _rand((P, M, C), seed + 1),
            _rand((P, C, N), seed + 2), _rand((P, C, N), seed + 3)]



# --------------------------------------------------------------------------
# kernel 1: batched complex GEMM
# --------------------------------------------------------------------------

CGEMM_CASES = [(4, 128, 128, 128), (3, 200, 67, 130), (2, 16, 3, 5),
               (1, 256, 64, 256), (9, 32, 512, 64)]


@pytest.mark.parametrize("P,M,C,N", CGEMM_CASES)
@pytest.mark.parametrize("three_m", [True, False])
def test_cgemm_plain_matches_pallas(P, M, C, N, three_m):
    ops = _operands(P, M, C, N)
    Zr, Zi = cgemm_cuda(*map(torch.from_numpy, ops), three_m=three_m)
    Jr, Ji = cgemm_pallas(*map(jnp.asarray, ops), three_m=three_m)
    scale = float(np.abs(np.asarray(Jr)).max()) + 1e-9
    np.testing.assert_allclose(Zr.numpy() / scale, np.asarray(Jr) / scale,
                               atol=2e-5)
    np.testing.assert_allclose(Zi.numpy() / scale, np.asarray(Ji) / scale,
                               atol=2e-5)


@pytest.mark.parametrize("three_m", [True, False])
def test_cgemm_plain_bf16_matches_pallas(three_m):
    ops = _operands(2, 64, 32, 48, seed=5)
    Zr, Zi = cgemm_cuda(*(torch.from_numpy(a).bfloat16() for a in ops),
                        three_m=three_m)
    assert Zr.dtype == torch.bfloat16
    Jr, Ji = cgemm_pallas(*(jnp.asarray(a).astype(jnp.bfloat16)
                            for a in ops), three_m=three_m)
    R, _ = j_cgemm_ref(*map(jnp.asarray, ops))
    scale = float(np.abs(np.asarray(R)).max()) + 1e-9
    for ours, theirs in ((Zr, Jr), (Zi, Ji)):
        np.testing.assert_allclose(ours.float().numpy() / scale,
                                   np.asarray(theirs, np.float32) / scale,
                                   atol=5e-2)


def test_cgemm_wrapper_refuses_what_the_kernel_does_not_take():
    ops = [torch.from_numpy(a) for a in _operands(2, 8, 4, 6)]
    with pytest.raises(ValueError, match="contiguous"):
        cgemm_cuda(ops[0].transpose(1, 2).contiguous().transpose(1, 2),
                   *ops[1:])
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        cgemm_cuda(*(t.double() for t in ops))
    with pytest.raises(ValueError, match="shape mismatch"):
        cgemm_cuda(ops[0], ops[1], ops[2][:, :3], ops[3][:, :3])
    before = cgemm_cuda.launches
    cgemm_cuda(*ops)                    # CPU: the plain version, no launch
    assert cgemm_cuda.launches == before


# --------------------------------------------------------------------------
# kernel 2: fused compact-spectrum inverse + bias + activation
# --------------------------------------------------------------------------

ACTIVATIONS = ["none", "relu", "gelu", "silu"]
INVERSE_CASES = [(d, act, pad) for d in (8, 15, 16) for act in ACTIVATIONS
                 for pad in (0, 6) if pad == 0 or d == 16]


def _inverse_inputs(n, delta, pad, seed):
    P = num_freq_real(delta) + pad
    return _rand((n, P), seed), _rand((n, P), seed + 1), _rand((n,), seed + 2)


@pytest.mark.parametrize("delta,activation,pad", INVERSE_CASES)
def test_irfft_epilogue_plain_matches_pallas(delta, activation, pad):
    zr, zi, b = _inverse_inputs(7, delta, pad, seed=delta)
    y = tile_irfft_epilogue_cuda(*map(torch.from_numpy, (zr, zi, b)),
                                 activation=activation, delta=delta)
    yj = tile_irfft_epilogue_pallas(*map(jnp.asarray, (zr, zi, b)),
                                    activation=activation, delta=delta)
    assert tuple(y.shape) == (7, delta, delta)
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), rtol=1e-4,
                               atol=1e-4)


def test_irfft_epilogue_wrapper_refuses_what_the_kernel_does_not_take():
    zr, zi, b = map(torch.from_numpy, _inverse_inputs(3, 16, 0, seed=9))
    with pytest.raises(ValueError, match="delta <= 32"):
        tile_irfft_epilogue_cuda(zr, zi, b, delta=33)
    with pytest.raises(ValueError, match="activation"):
        tile_irfft_epilogue_cuda(zr, zi, b, activation="tanh")
    with pytest.raises(ValueError, match="below the 130 points"):
        tile_irfft_epilogue_cuda(zr[:, :129], zi[:, :129], b)
    with pytest.raises(ValueError, match="one value per tile"):
        tile_irfft_epilogue_cuda(zr, zi, b[:2])
    with pytest.raises(TypeError, match="float32"):
        tile_irfft_epilogue_cuda(zr.double(), zi.double(), b.double())
    before = tile_irfft_epilogue_cuda.launches
    tile_irfft_epilogue_cuda(zr, zi, b)
    assert tile_irfft_epilogue_cuda.launches == before


# --------------------------------------------------------------------------
# kernels 3 and 4: forward tile DFT + compact gather, plain compact inverse
# --------------------------------------------------------------------------

TILE_CASES = [(d, n) for d in (5, 8, 15, 16) for n in (1, 7, 300)]


@pytest.mark.parametrize("delta,n", TILE_CASES)
def test_rfft_plain_matches_pallas(delta, n):
    x = _rand((n, delta, delta), 100 + delta + n)
    Tr, Ti = tile_rfft_cuda(torch.from_numpy(x), delta=delta)
    Jr, Ji = tile_rfft_pallas(jnp.asarray(x), delta=delta)
    assert tuple(Tr.shape) == (n, num_freq_real(delta))
    scale = max(np.abs(np.asarray(Jr)).max(), np.abs(np.asarray(Ji)).max())
    for ours, theirs in ((Tr, Jr), (Ti, Ji)):
        np.testing.assert_allclose(ours.numpy() / scale,
                                   np.asarray(theirs) / scale, atol=1e-4)


@pytest.mark.parametrize("delta,n", TILE_CASES)
@pytest.mark.parametrize("pad", [0, 6])
def test_irfft_plain_matches_pallas(delta, n, pad):
    zr, zi, _ = _inverse_inputs(n, delta, pad, seed=200 + delta + n)
    y = tile_irfft_cuda(*map(torch.from_numpy, (zr, zi)), delta=delta)
    yj = tile_irfft_pallas(*map(jnp.asarray, (zr, zi)), delta=delta)
    assert tuple(y.shape) == (n, delta, delta)
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), rtol=1e-4,
                               atol=1e-4)


def test_tile_wrappers_refuse_what_the_kernels_do_not_take():
    x = torch.from_numpy(_rand((4, 16, 16), 11))
    zr, zi, _ = map(torch.from_numpy, _inverse_inputs(3, 16, 0, seed=12))
    with pytest.raises(TypeError, match="float32"):
        tile_rfft_cuda(x.double())
    with pytest.raises(ValueError, match="contiguous"):
        tile_rfft_cuda(x.transpose(1, 2))
    with pytest.raises(ValueError, match="delta <= 32"):
        tile_rfft_cuda(torch.zeros((2, 33, 33)), delta=33)
    with pytest.raises(ValueError, match="tiles"):
        tile_rfft_cuda(x, delta=8)
    with pytest.raises(TypeError, match="float32"):
        tile_irfft_cuda(zr.double(), zi.double())
    with pytest.raises(ValueError, match="contiguous"):
        tile_irfft_cuda(zr.t().contiguous().t(), zi.t().contiguous().t())
    with pytest.raises(ValueError, match="delta <= 32"):
        tile_irfft_cuda(torch.zeros((2, 600)), torch.zeros((2, 600)),
                        delta=33)
    with pytest.raises(ValueError, match="below the 130 points"):
        tile_irfft_cuda(zr[:, :129].contiguous(), zi[:, :129].contiguous())
    before = (tile_rfft_cuda.launches, tile_irfft_cuda.launches)
    tile_rfft_cuda(x)                   # CPU: the plain versions, no launch
    tile_irfft_cuda(zr, zi)
    assert (tile_rfft_cuda.launches, tile_irfft_cuda.launches) == before


# --------------------------------------------------------------------------
# kernel 3, image form: stage 1 in one pass (image -> (P, M, C) planes)
# --------------------------------------------------------------------------

# (B, C, H, W, kernel, padding, view): Vconv1.1's C=3, Aconv2's 5x5 at
# 27x27, a dx plan's full-correlation padding, M*C not a multiple of 16,
# and inputs that are views: channels last, and a crop of a larger image
IMAGE_CASES = [(1, 3, 20, 20, 3, 1, None), (2, 4, 27, 27, 5, 2, None),
               (1, 5, 13, 11, 3, 2, None), (2, 3, 9, 15, 3, 1, "last"),
               (1, 2, 18, 18, 1, 0, "crop")]


def _image(B, C, H, W, view, seed):
    if view == "crop":
        return torch.from_numpy(_rand((B, C, H + 3, W + 5), seed))[
            :, :, 1:H + 1, 2:W + 2]
    x = torch.from_numpy(_rand((B, C, H, W), seed))
    return x.to(memory_format=torch.channels_last) if view else x


@pytest.mark.parametrize("B,C,H,W,kh,pad,view", IMAGE_CASES)
def test_image_rfft_plain_is_the_composed_stage_1(B, C, H, W, kh, pad, view):
    """On the CPU the image form is the composed stage 1 (pad and tile
    copy, the plain forward tile DFT, permute) bit for bit, which holds to
    the JAX package's stage 1 on the compact layout."""
    from repro.core import fftconv as jF
    from repro.core.conv_spec import ConvSpec as JSpec
    from repro_torch.core import fftconv as tF
    x = _image(B, C, H, W, view, 300 + C)
    spec = tF.make_spec(tuple(x.shape), (4, C, kh, kh), padding=pad)
    before = (tile_rfft_cuda.launches, dict(tile_rfft_cuda.form_launches))
    Dr, Di = image_rfft_cuda(x, spec)
    assert (tile_rfft_cuda.launches,
            tile_rfft_cuda.form_launches) == before     # nothing launched
    Rr, Ri = tF.input_transform(x, spec, spectrum="real",
                                tile_rfft=tile_rfft_cuda)
    assert torch.equal(Dr, Rr) and torch.equal(Di, Ri)
    assert tuple(Dr.shape) == (num_freq_real(16), spec.M, C)
    Jr, Ji = jF.input_transform(jnp.asarray(x.contiguous().numpy()),
                                JSpec(**dataclasses.asdict(spec)),
                                spectrum="real")
    for ours, theirs in ((Dr, Jr), (Di, Ji)):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs),
                                   rtol=1e-4, atol=1e-4)


def test_image_rfft_refuses_what_the_kernel_does_not_take():
    from repro_torch.core.fftconv import make_spec
    x = torch.from_numpy(_rand((1, 2, 10, 10), 13))
    spec = make_spec(tuple(x.shape), (3, 2, 3, 3), padding=1)
    with pytest.raises(TypeError, match="float32"):
        image_rfft_cuda(x.double(), spec)
    with pytest.raises(ValueError, match="delta 16"):
        image_rfft_cuda(x, make_spec(tuple(x.shape), (3, 2, 3, 3),
                                     padding=1, delta=8))
    with pytest.raises(ValueError, match="wants the image"):
        image_rfft_cuda(x[:, :1], spec)
    with pytest.raises(ValueError, match="unsupported device meta"):
        image_rfft_cuda(x.to("meta"), spec)


def test_image_rfft_on_fake_operands():
    """A fake image (the analyzer's) gets fake planes of the (P, M, C)
    shape, and nothing is built, launched or counted."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.core.fftconv import make_spec
    spec = make_spec((2, 3, 30, 30), (4, 3, 3, 3), padding=1)
    before = (tile_rfft_cuda.launches, dict(tile_rfft_cuda.form_launches))
    with FakeTensorMode():
        Dr, Di = image_rfft_cuda(torch.empty((2, 3, 30, 30)), spec)
    assert tuple(Dr.shape) == tuple(Di.shape) == (130, spec.M, 3)
    assert Dr.dtype == Di.dtype == torch.float32
    assert (tile_rfft_cuda.launches, tile_rfft_cuda.form_launches) == before


def test_argtypes_match_the_entry_points():
    """Each ``dft_tile`` entry point's ctypes signature has the C one's
    parameters, kind for kind (pointer, long long, int): a count off by
    one passes every argument after it in the wrong register."""
    import ctypes
    import re
    from repro_torch.kernels import _build
    from repro_torch.kernels.dft_tile import ops
    src = _build.source("dft_tile").read_text()
    entries = dict(re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src))
    kinds = {"*": ctypes.c_void_p, "long long": ctypes.c_longlong,
             "int": ctypes.c_int}
    for name, argtypes in ops._ARGTYPES.items():
        params = [p.strip() for p in entries[name].split(",")]
        want = [next(kinds[k] for k in kinds if k in p) for p in params]
        assert argtypes == want, name
