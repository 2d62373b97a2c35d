"""repro_torch.core.dft against repro.core.dft and numpy.fft: the DFT and
compact-layout tables, the tile transforms, and the half-spectrum
pack/unpack.  Inputs come from numpy with a fixed seed and go to both
packages; transforms are held to 1e-4 (float32 DFT-as-matmul over 16x16
tiles, summed in a different order by XLA and by PyTorch)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

import jax.numpy as jnp

from repro.core import dft as jdft
from repro_torch.core import dft as tdft

TOL = dict(rtol=1e-4, atol=1e-4)
DELTAS = [5, 8, 15, 16, 32]


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("delta", DELTAS)
def test_tables_bit_equal(delta):
    """The numpy tables are built the same way: bit-equal, including the
    odd-delta Nyquist weight and the compact store/src/sgn maps."""
    for a, b in zip(tdft._dft_mats_np(delta), jdft._dft_mats_np(delta)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for a, b in zip(tdft._compact_layout_np(delta),
                    jdft._compact_layout_np(delta)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert tdft.num_freq_real(delta) == jdft.num_freq_real(delta)
    assert tdft.num_freq(delta) == jdft.num_freq(delta)
    assert tdft.num_freq_full(delta) == jdft.num_freq_full(delta)


@pytest.mark.parametrize("delta", DELTAS)
def test_rfft2_tiles_matches_jax_and_numpy(delta):
    x = _rand((3, 2, delta, delta), delta)
    Tr, Ti = tdft.rfft2_tiles(torch.from_numpy(x), delta)
    Jr, Ji = jdft.rfft2_tiles(jnp.asarray(x), delta)
    ref = np.fft.rfft2(x)
    np.testing.assert_allclose(Tr.numpy(), np.asarray(Jr), **TOL)
    np.testing.assert_allclose(Ti.numpy(), np.asarray(Ji), **TOL)
    np.testing.assert_allclose(Tr.numpy(), ref.real, **TOL)
    np.testing.assert_allclose(Ti.numpy(), ref.imag, **TOL)


@pytest.mark.parametrize("delta", DELTAS)
def test_irfft2_tiles_matches_jax_and_roundtrips(delta):
    x = _rand((4, delta, delta), 100 + delta)
    ref = np.fft.rfft2(x)
    Zr, Zi = ref.real.astype(np.float32), ref.imag.astype(np.float32)
    y = tdft.irfft2_tiles(torch.from_numpy(Zr), torch.from_numpy(Zi), delta)
    yj = jdft.irfft2_tiles(jnp.asarray(Zr), jnp.asarray(Zi), delta)
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), **TOL)
    np.testing.assert_allclose(y.numpy(), x, **TOL)


@pytest.mark.parametrize("delta", [8, 15, 16])
def test_full_spectrum_tiles_match_jax(delta):
    x = _rand((3, delta, delta), 200 + delta)
    Tr, Ti = tdft.fft2_full_tiles(torch.from_numpy(x), delta)
    Jr, Ji = jdft.fft2_full_tiles(jnp.asarray(x), delta)
    np.testing.assert_allclose(Tr.numpy(), np.asarray(Jr), **TOL)
    np.testing.assert_allclose(Ti.numpy(), np.asarray(Ji), **TOL)
    ref = np.fft.fft2(x)
    np.testing.assert_allclose(Tr.numpy(), ref.real, **TOL)
    y = tdft.ifft2_full_tiles(Tr, Ti, delta)
    yj = jdft.ifft2_full_tiles(Jr, Ji, delta)
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), **TOL)
    np.testing.assert_allclose(y.numpy(), x, **TOL)


@pytest.mark.parametrize("delta", DELTAS)
@pytest.mark.parametrize("pad", [0, 6])
def test_pack_unpack_half_spectrum_match_jax(delta, pad):
    """pack keeps the compact list; unpack rebuilds the rect grid and
    ignores trailing points past P_real (``pad`` of them, here NaN)."""
    x = _rand((2, delta, delta), 300 + delta)
    ref = np.fft.rfft2(x)
    Tr = torch.from_numpy(ref.real.astype(np.float32))
    Ti = torch.from_numpy(ref.imag.astype(np.float32))
    Cr, Ci = tdft.pack_half_spectrum(Tr, Ti, delta)
    Jr, Ji = jdft.pack_half_spectrum(jnp.asarray(Tr.numpy()),
                                     jnp.asarray(Ti.numpy()), delta)
    assert Cr.shape[-1] == tdft.num_freq_real(delta)
    np.testing.assert_array_equal(Cr.numpy(), np.asarray(Jr))
    np.testing.assert_array_equal(Ci.numpy(), np.asarray(Ji))
    if pad:
        nan = torch.full((2, pad), float("nan"))
        Cr, Ci = torch.cat([Cr, nan], -1), torch.cat([Ci, nan], -1)
    Ur, Ui = tdft.unpack_half_spectrum(Cr, Ci, delta)
    Vr, Vi = jdft.unpack_half_spectrum(jnp.asarray(Cr.numpy()),
                                       jnp.asarray(Ci.numpy()), delta)
    np.testing.assert_array_equal(Ur.numpy(), np.asarray(Vr))
    np.testing.assert_array_equal(Ui.numpy(), np.asarray(Vi))
    np.testing.assert_allclose(Ur.numpy(), ref.real, **TOL)
    np.testing.assert_allclose(Ui.numpy(), ref.imag, **TOL)
