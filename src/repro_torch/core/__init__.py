"""Core FFT-based convolution algorithm (the paper's contribution)."""
from repro_torch.core.conv_spec import ConvSpec
from repro_torch.core.fftconv import (
    conv2d_direct, make_spec, input_transform, kernel_transform,
    output_inverse,
)
from repro_torch.core.cgemm import cgemm, cgemm_3m, cgemm_4m
from repro_torch.core.dft import rfft2_tiles, irfft2_tiles, dft_mats, num_freq

__all__ = [
    "ConvSpec", "conv2d_direct", "make_spec",
    "input_transform", "kernel_transform", "output_inverse",
    "cgemm", "cgemm_3m", "cgemm_4m",
    "rfft2_tiles", "irfft2_tiles", "dft_mats", "num_freq",
]
