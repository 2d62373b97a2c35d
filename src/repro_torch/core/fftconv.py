"""FFT-based convolution (the paper's algorithm): the stage primitives.

Four stages, kept as separate functions so the stage graph in
``repro_torch.conv.stages`` can run the kernel transform once per weight
version (``ConvPlan.prepare``):

  1. ``input_transform``   I (B,C,H,W)      -> D (P, M, C)   [rfft2 of 16x16 tiles]
  2. ``kernel_transform``  K (C',C,kh,kw)   -> G (P, C, C')  [conjugate rfft2]
  3. ``cgemm``             Z[p] = D[p] @ G[p]                [hot stage]
  4. ``output_inverse``    Z (P, M, C')     -> O (B,C',Ho,Wo) [irfft2 + crop]

All complex tensors are (real, imag) pairs of float tensors. ``M = B*X*Delta``
(tile count), ``P`` frequency points (see ``freq_count``).

Convolution here is ML cross-correlation; ``conv2d_direct`` is the oracle.
"""
from __future__ import annotations

import warnings

import torch
import torch.nn.functional as TF

from repro_torch.core.conv_spec import ConvSpec
from repro_torch.core import dft
from repro_torch.core.dft import (
    rfft2_tiles, irfft2_tiles, fft2_full_tiles, ifft2_full_tiles,
    pack_half_spectrum, unpack_half_spectrum,
)
from repro_torch.core.trace import span


# --------------------------------------------------------------------------
# Spectrum layouts
# --------------------------------------------------------------------------
#
# Three frequency-axis layouts share the (P, M, C)-shaped stage interface:
#
#   "rect"    P = delta * (delta//2 + 1)  — the rfft2 grid; still carries
#             u-redundant rows in its self-conjugate columns.
#   "real"    P = num_freq_real(delta)    — compact Hermitian frequency list
#             (~0.51x the full spectrum at delta=16); the ConvPlan default.
#   "complex" P = delta^2                 — full spectrum.
#
# Plans only use "real"/"complex"; "rect" remains the no-argument default of
# the raw stage primitives for direct callers.

SPECTRA = ("real", "complex")            # the layouts a plan may use


def freq_count(spec: ConvSpec, spectrum: str = "rect") -> int:
    """Stored frequency points P for a spectrum layout."""
    if spectrum == "rect":
        return spec.P
    if spectrum == "real":
        return dft.num_freq_real(spec.delta)
    if spectrum == "complex":
        return dft.num_freq_full(spec.delta)
    raise ValueError(f"unknown spectrum {spectrum!r}")


# --------------------------------------------------------------------------
# Oracle
# --------------------------------------------------------------------------

def _pair(padding):
    return (padding, padding) if isinstance(padding, int) else tuple(padding)


def conv2d_direct(x, k, *, padding=0, stride=1, compute_dtype=None):
    """Direct convolution oracle: ``F.conv2d``, NCHW/OIHW.

    ``padding`` is an int or ``(pad_h, pad_w)``, symmetric per axis — the
    same convention as the FFT path; ``stride`` an int or ``(s_h, s_w)``
    (the FFT path runs unit stride only).  ``compute_dtype`` rounds the
    operands to that dtype and convolves them in float32 (exact products,
    float32 accumulation), returning ``x.dtype`` — the direct-backend
    analogue of the FFT schedules' hot CGEMM operand cast.
    """
    pad, stride = _pair(padding), _pair(stride)
    if compute_dtype is None:
        return TF.conv2d(x, k, stride=stride, padding=pad)
    xc = x.to(compute_dtype).to(torch.float32)
    kc = k.to(compute_dtype).to(torch.float32)
    return TF.conv2d(xc, kc, stride=stride, padding=pad).to(x.dtype)


# --------------------------------------------------------------------------
# Stage 1: input transform
# --------------------------------------------------------------------------

def extract_tiles(x, spec: ConvSpec):
    """(B, C, H, W) -> overlap-save patches (B, C, X, Delta, delta, delta).

    ``Tensor.unfold`` over both spatial axes yields the strided window view
    directly (the padded extent holds exactly X x Delta windows).
    """
    d = spec.delta
    x = TF.pad(x, (spec.pad_w, spec.Wp - spec.W - spec.pad_w,
                   spec.pad_h, spec.Hp - spec.H - spec.pad_h))
    return x.unfold(2, d, spec.t_h).unfold(3, d, spec.t_w)


def _tiles_to_spectrum(tiles, spec: ConvSpec, spectrum: str,
                       tile_rfft=None, tile_fft=None):
    """Real tile batch (..., delta, delta) -> flat spectrum planes (..., P).

    A tile kernel runs on the tiles made contiguous, in place of the DFT
    matmuls (and the gather): ``tile_rfft`` (the ``spectrum="real"``
    layout only) ``(tiles (n, delta, delta), delta=) -> two (n, P_real)
    planes``; ``tile_fft`` (``spectrum="rect"`` only) ``(tiles, delta=) ->
    two (n, delta, delta//2 + 1) planes``.  Stage 2 runs this way, and
    stage 1 where ``input_transform`` has no ``image_rfft`` to take.
    """
    if tile_rfft is not None and spectrum != "real":
        raise ValueError(f"a tile_rfft kernel computes the compact 'real' "
                         f"layout, not {spectrum!r}")
    if tile_fft is not None and spectrum != "rect":
        raise ValueError(f"a tile_fft kernel computes the 'rect' layout, "
                         f"not {spectrum!r}")
    if spectrum == "complex":
        Tr, Ti = fft2_full_tiles(tiles, spec.delta)
        P = spec.delta * spec.delta
        return Tr.reshape(*Tr.shape[:-2], P), Ti.reshape(*Ti.shape[:-2], P)
    if spectrum not in ("real", "rect"):
        raise ValueError(f"unknown spectrum {spectrum!r}")
    kernel = tile_rfft or tile_fft
    if kernel is not None:
        d, lead = spec.delta, tiles.shape[:-2]
        Tr, Ti = kernel(tiles.reshape(-1, d, d).contiguous(), delta=d)
        return Tr.reshape(*lead, -1), Ti.reshape(*lead, -1)
    Tr, Ti = rfft2_tiles(tiles, spec.delta)
    if spectrum == "real":
        return pack_half_spectrum(Tr, Ti, spec.delta)
    P = spec.P
    return Tr.reshape(*Tr.shape[:-2], P), Ti.reshape(*Ti.shape[:-2], P)


def input_transform(x, spec: ConvSpec, *, dtype=torch.float32,
                    spectrum: str = "rect", tile_rfft=None, tile_fft=None,
                    image_rfft=None):
    """Stage 1: I -> D (P, M, C) as (real, imag).

    ``image_rfft`` ``(x (B, C, H, W), spec) -> D`` is stage 1 in one pass:
    a kernel that reads the tiles from the image and writes the spectra in
    the (P, M, C) layout.  It computes the compact layout from a float32
    image (its backend hands it only to plans whose tiles it takes), and
    runs where those hold; anything else takes the composed path: the
    padded tiles (made contiguous for a tile kernel), their spectra
    (``_tiles_to_spectrum``), the permute to (P, M, C).
    """
    if (image_rfft is not None and spectrum == "real"
            and x.dtype == dtype == torch.float32):
        return image_rfft(x, spec)
    with span("copy/tiles"):
        patches = extract_tiles(x.to(dtype), spec)     # (B, C, X, Dl, d, d)
        if tile_rfft is not None or tile_fft is not None:
            patches = patches.contiguous()             # what a tile kernel reads
    Tr, Ti = _tiles_to_spectrum(patches, spec, spectrum, tile_rfft,
                                tile_fft)
    P = Tr.shape[-1]                                   # == freq_count(...)

    def to_pmc(T):                                     # (B, C, X, Dl, P)
        T = T.permute(4, 0, 2, 3, 1)                   # (P, B, X, Dl, C)
        return T.reshape(P, spec.M, spec.C).contiguous()
    with span("copy/spectra"):
        return to_pmc(Tr), to_pmc(Ti)


# --------------------------------------------------------------------------
# Stage 2: kernel transform
# --------------------------------------------------------------------------

def kernel_transform(k, spec: ConvSpec, *, dtype=torch.float32,
                     spectrum: str = "rect", tile_rfft=None, tile_fft=None):
    """Stage 2: K -> G (P, C, C') as (real, imag); imag is conjugated."""
    d = spec.delta
    with span("copy/kernel"):
        kp = TF.pad(k.to(dtype), (0, d - spec.kw, 0, d - spec.kh))
    Tr, Ti = _tiles_to_spectrum(kp, spec, spectrum, tile_rfft,
                                tile_fft)              # (C', C, P)
    P = Tr.shape[-1]                                   # == freq_count(...)

    def to_pcc(T):                                     # the kernels' layout
        return T.permute(2, 1, 0).reshape(P, spec.C, spec.Cout).contiguous()
    with span("copy/kernel"):
        return to_pcc(Tr), to_pcc(-Ti)                 # conj: F*(K)


# --------------------------------------------------------------------------
# Stage 4: inverse transform
# --------------------------------------------------------------------------

def z_to_tiles(Z, spec: ConvSpec):
    """(P, M, C') frequency layout -> per-tile (B, C', X, Dl, d, dh)."""
    d, dh = spec.delta, spec.delta_h
    Z = Z.reshape(d, dh, spec.B, spec.X, spec.D, spec.Cout)
    return Z.permute(2, 5, 3, 4, 0, 1)                 # (B, C', X, Dl, d, dh)


def z_to_rect_planes(Z, spec: ConvSpec):
    """(P', M, C') rect layout -> contiguous (n, d, dh) planes, one per
    output tile in (B, C', X, Dl) order: what the rect ``dft_tile`` inverse
    kernels read.  Rows past ``spec.P`` (padding) are dropped."""
    d, dh = spec.delta, spec.delta_h
    with span("copy/planes"):
        return z_to_tiles(Z[:spec.P], spec).reshape(-1, d, dh).contiguous()


def z_to_flat_tiles(Z, spec: ConvSpec, P: int):
    """(P', M, C') flat frequency layout -> per-tile (B, C', X, Dl, P).

    ``P`` is the layout's true point count; rows past it (padding) are
    dropped.  The result is a permuted view of ``Z``.
    """
    Z = Z[:P].reshape(P, spec.B, spec.X, spec.D, spec.Cout)
    return Z.permute(1, 4, 2, 3, 0)                    # (B, C', X, Dl, P)


def z_to_tile_planes(Z, spec: ConvSpec, P: int):
    """(P', M, C') flat frequency layout -> contiguous (n, P) planes, one
    row per output tile in (B, C', X, Dl) order: what the ``dft_tile``
    inverse kernels read."""
    with span("copy/planes"):
        return z_to_flat_tiles(Z, spec, P).reshape(-1, P).contiguous()


def assemble_output_tiles(y, spec: ConvSpec):
    """Inverse-transformed tiles (B, C', X, Dl, d, d) -> O (B, C', Ho, Wo)
    (overlap-save crop + spatial reassembly)."""
    with span("copy/assemble"):
        y = y[..., :spec.t_h, :spec.t_w]
        y = y.permute(0, 1, 2, 4, 3, 5).reshape(
            spec.B, spec.Cout, spec.X * spec.t_h, spec.D * spec.t_w)
        return y[:, :, :spec.Ho, :spec.Wo]


def output_inverse(Zr, Zi, spec: ConvSpec, *, spectrum: str = "rect",
                   tile_irfft=None, tile_ifft=None):
    """Stage 4: Z (P, M, C') -> O (B, C', Ho, Wo).

    The P axis may carry trailing padding past the layout's point count;
    it is sliced off here.  A tile kernel runs on the tile planes in place
    of the (scatter and the) DFT matmuls: ``tile_irfft`` (the
    ``spectrum="real"`` layout only) ``(Zr, Zi (n, P), delta=) -> (n,
    delta, delta)``; ``tile_ifft`` (``spectrum="rect"`` only) ``(Zr, Zi
    (n, delta, delta//2 + 1), delta=) -> (n, delta, delta)``.
    """
    d = spec.delta
    if tile_irfft is not None and spectrum != "real":
        raise ValueError(f"a tile_irfft kernel reads the compact 'real' "
                         f"layout, not {spectrum!r}")
    if tile_ifft is not None and spectrum != "rect":
        raise ValueError(f"a tile_ifft kernel reads the 'rect' layout, not "
                         f"{spectrum!r}")
    if tile_irfft is not None:
        P = dft.num_freq_real(d)
        y = tile_irfft(z_to_tile_planes(Zr, spec, P),
                       z_to_tile_planes(Zi, spec, P), delta=d)
        y = y.reshape(spec.B, spec.Cout, spec.X, spec.D, d, d)
    elif tile_ifft is not None:
        y = tile_ifft(z_to_rect_planes(Zr, spec), z_to_rect_planes(Zi, spec),
                      delta=d)
        y = y.reshape(spec.B, spec.Cout, spec.X, spec.D, d, d)
    elif spectrum == "rect":
        y = irfft2_tiles(z_to_tiles(Zr[:spec.P], spec),
                         z_to_tiles(Zi[:spec.P], spec), d)
    elif spectrum == "real":
        P = dft.num_freq_real(d)
        Zr, Zi = unpack_half_spectrum(z_to_flat_tiles(Zr, spec, P),
                                      z_to_flat_tiles(Zi, spec, P), d)
        y = irfft2_tiles(Zr, Zi, d)
    elif spectrum == "complex":
        P = d * d
        shape = (spec.B, spec.Cout, spec.X, spec.D, d, d)
        y = ifft2_full_tiles(z_to_flat_tiles(Zr, spec, P).reshape(shape),
                             z_to_flat_tiles(Zi, spec, P).reshape(shape), d)
    else:
        raise ValueError(f"unknown spectrum {spectrum!r}")
    return assemble_output_tiles(y, spec)


# --------------------------------------------------------------------------
# Geometry
# --------------------------------------------------------------------------

def make_spec(x_shape, k_shape, padding=0, delta=16) -> ConvSpec:
    B, C, H, W = x_shape
    Cout, C2, kh, kw = k_shape
    if C != C2:
        raise ValueError(f"channel mismatch: input C={C}, kernel C={C2}")
    pad = _pair(padding)
    return ConvSpec(B=B, C=C, Cout=Cout, H=H, W=W, kh=kh, kw=kw,
                    pad_h=pad[0], pad_w=pad[1], delta=delta)


# --------------------------------------------------------------------------
# Deprecated entry points (the reference's signatures)
# --------------------------------------------------------------------------

def fft_conv2d(x, k, *, padding=0, delta=16, three_m: bool = True):
    """Deprecated: use ``repro_torch.conv.plan_conv(...,
    backend="fft-torch")``.

    FFT-based 2-D convolution (cross-correlation), differentiable.
    Thin shim over the plan API with the old signature.
    """
    warnings.warn(
        "fft_conv2d is deprecated; use repro_torch.conv.plan_conv(x.shape, "
        "k.shape, backend='fft-torch') and call the plan",
        DeprecationWarning, stacklevel=2)
    from repro_torch.conv import plan_conv
    plan = plan_conv(tuple(x.shape), tuple(k.shape), padding=padding,
                     delta=delta, backend="fft-torch", three_m=three_m)
    return plan(x, k)


def fft_conv2d_pallas(x, k, *, padding=0, delta=16, three_m: bool = True,
                      bm=None, bn=None, bk=None):
    """Deprecated: use ``repro_torch.conv.plan_conv(...,
    backend="fft-cuda")``.

    fft_conv2d with its stages on the hand-written CUDA kernels (the
    CGEMM and the tile DFTs; their plain versions on a CPU tensor).
    ``bm``/``bn``/``bk`` name a row of the CGEMM's tile table as the plan
    takes them: a triple that names no row is the plan's ``ValueError``.
    """
    warnings.warn(
        "fft_conv2d_pallas is deprecated; use repro_torch.conv.plan_conv("
        "x.shape, k.shape, backend='fft-cuda', bm=..., bn=..., bk=...) and "
        "call the plan", DeprecationWarning, stacklevel=2)
    from repro_torch.conv import plan_conv
    plan = plan_conv(tuple(x.shape), tuple(k.shape), padding=padding,
                     delta=delta, backend="fft-cuda", three_m=three_m,
                     bm=bm, bn=bn, bk=bk)
    return plan(x, k)
