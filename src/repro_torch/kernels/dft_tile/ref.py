"""Plain PyTorch versions of the tile DFT kernels: the compact-spectrum
forms and the rect-grid forms."""
from __future__ import annotations

from repro_torch.conv.epilogue import ACTIVATIONS
from repro_torch.core.dft import (
    irfft2_tiles, pack_half_spectrum, rfft2_tiles, unpack_half_spectrum,
)


def tile_rfft_ref(x, delta: int = 16):
    """Tiles (n, delta, delta) -> compact planes (n, num_freq_real(delta))
    x2: the rfft2 of each tile, gathered at the ``store`` points."""
    Tr, Ti = rfft2_tiles(x, delta)
    return pack_half_spectrum(Tr, Ti, delta)


def tile_irfft_ref(Zr, Zi, delta: int = 16):
    """Compact planes (n, P >= num_freq_real(delta)) x2 -> irfft2 of each
    tile: (n, delta, delta)."""
    Zr, Zi = unpack_half_spectrum(Zr, Zi, delta)
    return irfft2_tiles(Zr, Zi, delta)


def tile_irfft_epilogue_ref(Zr, Zi, bias, *, activation: str = "none",
                            delta: int = 16):
    """Compact planes (n, P >= num_freq_real(delta)) x2 + (n,) per-tile bias
    -> act(irfft2(tile) + bias): (n, delta, delta)."""
    y = tile_irfft_ref(Zr, Zi, delta)
    y = y + bias.to(y.dtype)[:, None, None]
    return ACTIVATIONS[activation](y)


def tile_fft_ref(x, delta: int = 16):
    """Tiles (n, delta, delta) -> the rfft2 of each tile on the rect grid:
    (n, delta, delta//2 + 1) x2."""
    return rfft2_tiles(x, delta)


def tile_ifft_ref(Zr, Zi, delta: int = 16):
    """Rect planes (n, delta, delta//2 + 1) x2 -> irfft2 of each tile:
    (n, delta, delta)."""
    return irfft2_tiles(Zr, Zi, delta)


def tile_ifft_epilogue_ref(Zr, Zi, bias, *, activation: str = "none",
                           delta: int = 16):
    """Rect planes (n, delta, delta//2 + 1) x2 + (n,) per-tile bias ->
    act(irfft2(tile) + bias): (n, delta, delta)."""
    y = tile_ifft_ref(Zr, Zi, delta)
    y = y + bias.to(y.dtype)[:, None, None]
    return ACTIVATIONS[activation](y)
