"""Plain PyTorch version of the fused compact-spectrum inverse kernel."""
from __future__ import annotations

from repro_torch.conv.epilogue import ACTIVATIONS
from repro_torch.core.dft import irfft2_tiles, unpack_half_spectrum


def tile_irfft_epilogue_ref(Zr, Zi, bias, *, activation: str = "none",
                            delta: int = 16):
    """Compact planes (n, P >= num_freq_real(delta)) x2 + (n,) per-tile bias
    -> act(irfft2(tile) + bias): (n, delta, delta)."""
    Zr, Zi = unpack_half_spectrum(Zr, Zi, delta)
    y = irfft2_tiles(Zr, Zi, delta)
    y = y + bias.to(y.dtype)[:, None, None]
    return ACTIVATIONS[activation](y)
