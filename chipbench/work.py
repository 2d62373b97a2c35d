"""The benchmark's yardstick for work: operations, bytes and the card's peaks.

Everything here is computed from a layer's shape alone, by fixed counting
rules, so that it reads the same work whatever implements it:

- direct-convolution FLOPs, 2*B*C'*C*Ho*Wo*kh*kw, the paper's own
  normalisation and the numerator of every ``mfu``;
- the complex GEMM of the FFT method: P x M x C x C' complex multiply-adds
  at 6 real FLOPs each (Gauss's 3M form, the least any float32
  implementation needs), P = 130 frequency points at tile 16 (the compact
  real-input spectrum), M the overlap-save tiles of the batch;
- bytes: each input read once and each output written once (complex64
  spectra, float32 images);
- the tile DFTs: bytes as above, operations as a radix-2 real FFT of the
  tile (2.5 N log2 N for N = 16*16 points), which keeps them bytes-bound.

Peaks are the NVIDIA H100 SXM data sheet's dense rates.
"""
from __future__ import annotations

import math

TILE = 16                        # the paper's overlap-save tile (delta)
FREQ = TILE * TILE // 2 + 2      # compact real spectrum: 130 points
CGEMM_FLOPS_PER_CMAC = 6         # 3M form: three real products a point
F32, C64 = 4, 8                  # bytes of a float32 and a complex64

PEAK_F32_FLOPS = 67e12           # float32 outside the tensor cores
PEAK_HBM_BYTES = 3.35e12         # 80 GB HBM3
# mfu's peak: float32 operands on the tensor cores (TF32).  A transform-
# domain program does about a third of the direct count's arithmetic, so
# its direct-equivalent rate may pass the 67 TFLOP/s float32 peak.
MFU_PEAK_FLOPS = 495e12


def out_hw(layer) -> tuple:
    """(Ho, Wo) of a unit-stride layer with symmetric padding."""
    p = layer["pad"]
    return (layer["H"] + 2 * p - layer["k"] + 1,
            layer["W"] + 2 * p - layer["k"] + 1)


def direct_flops(layer, batch: int) -> int:
    """2*B*C'*C*Ho*Wo*kh*kw."""
    ho, wo = out_hw(layer)
    k = layer["k"]
    return 2 * batch * layer["Cout"] * layer["C"] * ho * wo * k * k


def tiles(layer, batch: int) -> int:
    """M: overlap-save tiles of the batch, each yielding a
    (TILE-k+1)^2 block of outputs."""
    ho, wo = out_hw(layer)
    t = TILE - layer["k"] + 1
    return batch * math.ceil(ho / t) * math.ceil(wo / t)


def least_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the two
    bounds."""
    return max(flops / PEAK_F32_FLOPS, nbytes / PEAK_HBM_BYTES)


def cgemm_work(layer, batch: int) -> tuple:
    """(FLOPs, bytes) of the CGEMM stage of one call: P x M x C x C'
    complex multiply-adds; the input spectrum, the kernel spectrum and the
    output spectrum each moved once.  The same for a dx plan (C and C'
    trade places, the count is symmetric)."""
    m, c, co = tiles(layer, batch), layer["C"], layer["Cout"]
    flops = CGEMM_FLOPS_PER_CMAC * FREQ * m * c * co
    nbytes = C64 * FREQ * (m * c + c * co + m * co)
    return flops, nbytes


def _fft_flops(n_transforms: int) -> float:
    n = TILE * TILE
    return n_transforms * 2.5 * n * math.log2(n)


def dft_forward_work(layer, batch: int, channels=None) -> tuple:
    """(FLOPs, bytes) of the forward tile DFT of an input of ``channels``
    (default C): the image read once, its spectrum written once."""
    c = layer["C"] if channels is None else channels
    m = tiles(layer, batch)
    nbytes = F32 * batch * c * layer["H"] * layer["W"] + C64 * FREQ * m * c
    return _fft_flops(m * c), nbytes


def dft_inverse_work(layer, batch: int, channels=None, bias=True) -> tuple:
    """(FLOPs, bytes) of the inverse tile DFT to ``channels`` (default C')
    output maps: the spectrum read once, the output (and bias) once."""
    c = layer["Cout"] if channels is None else channels
    m = tiles(layer, batch)
    ho, wo = out_hw(layer)
    nbytes = C64 * FREQ * m * c + F32 * batch * c * ho * wo
    if bias:
        nbytes += F32 * c
    return _fft_flops(m * c), nbytes


def dft_kernel_work(layer) -> tuple:
    """(FLOPs, bytes) of one kernel transform: C' x C kernels of k x k
    read, their spectra written."""
    c, co, k = layer["C"], layer["Cout"], layer["k"]
    return _fft_flops(c * co), F32 * c * co * k * k + C64 * FREQ * c * co


def conv_least_s(calls, kind: str) -> float:
    """The least time of the work in ``calls``, a list of records
    ``{"layer": {...}, "batch": B, "n": calls, "pass": "fwd"|"dx"}``
    (``"kernel"`` passes count one kernel transform each), for ``kind``
    ``"cgemm"`` or ``"dft"``."""
    total = 0.0
    for c in calls:
        layer, b, n, kind_of = c["layer"], c["batch"], c["n"], c["pass"]
        if kind == "cgemm":
            if kind_of in ("fwd", "dx"):
                total += n * least_s(*cgemm_work(layer, b))
        elif kind == "dft":
            if kind_of == "fwd":
                total += n * (least_s(*dft_forward_work(layer, b))
                              + least_s(*dft_inverse_work(layer, b)))
            elif kind_of == "dx":
                # dz (C' maps) forward, dx (C maps) back, no epilogue
                total += n * (
                    least_s(*dft_forward_work(layer, b, layer["Cout"]))
                    + least_s(*dft_inverse_work(layer, b, layer["C"],
                                                bias=False)))
            elif kind_of == "kernel":
                total += n * least_s(*dft_kernel_work(layer))
        else:
            raise ValueError(f"unknown kind {kind!r}")
    return total


def model_flops(layers, images: int, *, train: bool = False) -> int:
    """Direct-convolution FLOPs of ``images`` through ``layers``; training
    counts the forward, dk of every layer and dx of every layer but the
    first (the input needs no gradient)."""
    fwd = sum(direct_flops(l, 1) for l in layers)
    if not train:
        return images * fwd
    return images * (3 * fwd - direct_flops(layers[0], 1))
