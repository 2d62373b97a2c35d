"""DFT-as-matmul: every (i)rfft2 of a tile as small dense matrix products.

The paper computes 16x16 tile FFTs with hand-vectorised butterflies; here
each (i)rfft2 of a tile is two small matrix products against precomputed
DFT matrices:

    rfft2(x)  = F_full @ x @ F_half^T            (x real, delta x delta)
    irfft2(Z) = Re( (Finv @ Z) @ Wr^T )          (Z complex, delta x delta_h)

where delta_h = delta//2 + 1 and Wr folds the Hermitian-redundant columns
back with weight 2 (columns 0 and Nyquist with weight 1).

All complex arithmetic is struct-of-arrays (separate real/imag float
planes), the layout the CUDA kernels of ``repro_torch.kernels`` consume.
The numpy tables are built exactly as ``repro.core.dft`` builds them.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.fake import constant_cache, fake_mode, fakes_like


@constant_cache
def _dft_mats_np(delta: int):
    """Precompute (numpy, float64 -> float32) all DFT matrices for a tile size."""
    dh = delta // 2 + 1
    u = np.arange(delta)
    # Forward full DFT: F[u, h] = exp(-2i pi u h / delta)
    ang = -2.0 * np.pi * np.outer(u, u) / delta
    F = np.cos(ang) + 1j * np.sin(ang)
    F_half = F[:dh, :]                      # rfft over the last axis
    # Inverse full DFT (axis 0): Finv[h, u] = exp(+2i pi u h / delta) / delta
    Finv = np.conj(F).T / delta
    # Weighted inverse-rfft (last axis): x[., w] = Re(sum_v c_v Y[., v] e^{2i pi v w/delta})/delta
    # Fold weight 1 only for self-conjugate bins: DC always, Nyquist only
    # when delta is even (odd delta has no Nyquist bin — v == delta//2 there
    # still has a dropped conjugate partner and needs weight 2).
    v = np.arange(dh)
    self_conj = (v == 0) | ((delta % 2 == 0) & (v == delta // 2))
    c = np.where(self_conj, 1.0, 2.0)
    angw = 2.0 * np.pi * np.outer(np.arange(delta), v) / delta
    W = (np.cos(angw) + 1j * np.sin(angw)) * c[None, :] / delta   # (delta, dh)
    return (
        F.real.astype(np.float32), F.imag.astype(np.float32),
        F_half.real.astype(np.float32), F_half.imag.astype(np.float32),
        Finv.real.astype(np.float32), Finv.imag.astype(np.float32),
        W.real.astype(np.float32), W.imag.astype(np.float32),
    )


@constant_cache
def _dft_mats_on(delta: int, device: torch.device, dtype: torch.dtype):
    # contiguous: the kernels read the tables row-major
    return tuple(torch.as_tensor(m).to(device=device, dtype=dtype)
                 .contiguous() for m in _dft_mats_np(delta))


def dft_mats(delta: int, device=None, dtype=torch.float32):
    """Tensor copies of all DFT matrices for tile size ``delta`` (cached
    per device and dtype: the tables are constants).  Under a fake mode:
    fakes of their shapes on ``device`` (``repro_torch.fake``)."""
    device = torch.device(device or "cpu")
    if fake_mode() is not None:
        return fakes_like(_dft_mats_on(delta, torch.device("cpu"), dtype),
                          device)
    return _dft_mats_on(delta, device, dtype)


def rfft2_tiles(x, delta: int):
    """Batched rfft2 of real tiles via matmul.

    x: (..., delta, delta) real -> (Tr, Ti): (..., delta, delta_h).
    """
    Fr, Fi, Fhr, Fhi, *_ = dft_mats(delta, x.device, x.dtype)
    # A = F @ x  (x real): 2 real matmuls
    Ar = torch.matmul(Fr, x)
    Ai = torch.matmul(Fi, x)
    # T = A @ F_half^T: (Ar + iAi)(Fhr^T + iFhi^T)
    Tr = torch.matmul(Ar, Fhr.T) - torch.matmul(Ai, Fhi.T)
    Ti = torch.matmul(Ar, Fhi.T) + torch.matmul(Ai, Fhr.T)
    return Tr, Ti


def irfft2_tiles(Zr, Zi, delta: int):
    """Batched irfft2 via matmul. (Zr, Zi): (..., delta, delta_h) -> (..., delta, delta) real."""
    *_, Fvr, Fvi, Wr, Wi = dft_mats(delta, Zr.device, Zr.dtype)
    # Y = Finv @ Z (complex x complex)
    Yr = torch.matmul(Fvr, Zr) - torch.matmul(Fvi, Zi)
    Yi = torch.matmul(Fvr, Zi) + torch.matmul(Fvi, Zr)
    # x = Re( Y @ W^T ) = Yr @ Wr^T - Yi @ Wi^T
    return torch.matmul(Yr, Wr.T) - torch.matmul(Yi, Wi.T)


def num_freq(delta: int) -> int:
    """Number of stored complex frequency points P in the rfft2 layout."""
    return delta * (delta // 2 + 1)


def num_freq_full(delta: int) -> int:
    """Frequency points in the full complex spectrum (``spectrum="complex"``)."""
    return delta * delta


def num_freq_real(delta: int) -> int:
    """Frequency points in the compact Hermitian layout (``spectrum="real"``).

    The rect rfft2 layout (delta x delta_h) still stores u-redundant rows in
    its self-conjugate columns (v = 0, and v = delta/2 for even delta):
    T[u, v] = conj(T[delta-u, v]) there.  Dropping them leaves
    delta^2/2 + 2 points for even delta and (delta^2 + 1)/2 for odd — just
    over half the full spectrum, vs 0.5625x for the rect layout at delta=16.
    """
    return len(_compact_layout_np(delta)[0])


@constant_cache
def _compact_layout_np(delta: int):
    """Gather/scatter index maps between the rect rfft2 layout and the
    compact Hermitian frequency list.

    Returns ``(store, src, sgn)`` numpy arrays:

    - ``store`` (P_real,) int32: flat rect indices (u * delta_h + v) kept in
      the compact layout, in stored order.
    - ``src``   (delta * delta_h,) int32: for every rect point, the compact
      index holding its value (its own slot, or its u-conjugate mirror
      ``(delta - u) % delta`` for dropped points).
    - ``sgn``   (delta * delta_h,) float32: +1 for stored points, -1 for
      dropped ones (imag plane is negated when reading through the mirror).
    """
    d = delta
    dh = d // 2 + 1
    keep = np.ones((d, dh), dtype=bool)
    # Self-conjugate columns: only u in [0, d//2] carries information.
    keep[d // 2 + 1:, 0] = False
    if d % 2 == 0:
        keep[d // 2 + 1:, d // 2] = False
    store = np.flatnonzero(keep.ravel())
    comp_of_rect = -np.ones(d * dh, dtype=np.int64)
    comp_of_rect[store] = np.arange(store.size)
    src = np.empty(d * dh, dtype=np.int64)
    sgn = np.empty(d * dh, dtype=np.float32)
    for u in range(d):
        for v in range(dh):
            r = u * dh + v
            if comp_of_rect[r] >= 0:
                src[r], sgn[r] = comp_of_rect[r], 1.0
            else:
                m = ((d - u) % d) * dh + v
                src[r], sgn[r] = comp_of_rect[m], -1.0
    return (store.astype(np.int32), src.astype(np.int32), sgn)


@constant_cache
def _compact_layout_on(delta: int, device: torch.device):
    store, src, sgn = _compact_layout_np(delta)
    return (torch.as_tensor(store).to(device),
            torch.as_tensor(src).to(device),
            torch.as_tensor(sgn).to(device))


def compact_layout(delta: int, device=None):
    """Tensor copies of the (store, src, sgn) compact-layout index maps.
    Under a fake mode: fakes of their shapes on ``device``."""
    device = torch.device(device or "cpu")
    if fake_mode() is not None:
        return fakes_like(_compact_layout_on(delta, torch.device("cpu")),
                          device)
    return _compact_layout_on(delta, device)


def pack_half_spectrum(Tr, Ti, delta: int):
    """Rect rfft2 planes (..., delta, delta_h) -> compact (..., P_real)."""
    store, _, _ = compact_layout(delta, Tr.device)
    dh = delta // 2 + 1
    Tr = Tr.reshape(*Tr.shape[:-2], delta * dh).index_select(-1, store)
    Ti = Ti.reshape(*Ti.shape[:-2], delta * dh).index_select(-1, store)
    return Tr, Ti


def unpack_half_spectrum(Zr, Zi, delta: int):
    """Compact planes (..., P >= P_real) -> rect rfft2 (..., delta, delta_h).

    Trailing padding past P_real (e.g. all-to-all divisibility padding) is
    ignored: every ``src`` index points below P_real.
    """
    _, src, sgn = compact_layout(delta, Zr.device)
    dh = delta // 2 + 1
    shape = (*Zr.shape[:-1], delta, dh)
    Zr = Zr.index_select(-1, src).reshape(shape)
    Zi = (Zi.index_select(-1, src) * sgn.to(Zi.dtype)).reshape(shape)
    return Zr, Zi


def fft2_full_tiles(x, delta: int):
    """Batched full fft2 of real tiles: (..., delta, delta) -> two
    (..., delta, delta) planes (the ``spectrum="complex"`` twin)."""
    Fr, Fi, *_ = dft_mats(delta, x.device, x.dtype)
    Ar = torch.matmul(Fr, x)
    Ai = torch.matmul(Fi, x)
    Tr = torch.matmul(Ar, Fr.T) - torch.matmul(Ai, Fi.T)
    Ti = torch.matmul(Ar, Fi.T) + torch.matmul(Ai, Fr.T)
    return Tr, Ti


def ifft2_full_tiles(Zr, Zi, delta: int):
    """Batched full ifft2: two (..., delta, delta) planes -> real tiles.

    Returns Re(Finv @ Z @ Finv^T); the imaginary part cancels for spectra of
    real signals.
    """
    _, _, _, _, Fvr, Fvi, _, _ = dft_mats(delta, Zr.device, Zr.dtype)
    Yr = torch.matmul(Fvr, Zr) - torch.matmul(Fvi, Zi)
    Yi = torch.matmul(Fvr, Zi) + torch.matmul(Fvi, Zr)
    return torch.matmul(Yr, Fvr.T) - torch.matmul(Yi, Fvi.T)
