"""Wrapper of the CUDA fused compact-spectrum inverse + epilogue kernel
(stage 4 of ``fft-cuda`` on the ``spectrum="real"`` layout).

``tile_irfft_epilogue_cuda`` dispatches on the operands' device: a CPU
tensor runs the plain PyTorch version (``ref.tile_irfft_epilogue_ref``); a
CUDA tensor launches the ``csrc/dft_tile.cu`` kernel on the current stream,
or raises.  ``tile_irfft_epilogue_cuda.launches`` counts the launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.dft import compact_layout, dft_mats, num_freq_real
from repro_torch.kernels import _build
from repro_torch.kernels.dft_tile.ref import tile_irfft_epilogue_ref

MAX_DELTA = 32                          # per-warp buffers in shared memory
ACTIVATION_CODES = {"none": 0, "relu": 1, "gelu": 2, "silu": 3}


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("dft_tile")
    fn = lib.tile_irfft_epilogue_f32
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_longlong] \
        + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.dft_tile_error_string.argtypes = [ctypes.c_int]
    lib.dft_tile_error_string.restype = ctypes.c_char_p
    return lib


def _check(Zr, Zi, bias, activation, delta):
    if activation not in ACTIVATION_CODES:
        raise ValueError(f"unsupported kernel-tail activation "
                         f"{activation!r}: {tuple(ACTIVATION_CODES)}")
    if not 1 <= delta <= MAX_DELTA:
        raise ValueError(f"tile_irfft_epilogue supports delta <= "
                         f"{MAX_DELTA}, got {delta}")
    if Zr.dim() != 2 or Zi.shape != Zr.shape:
        raise ValueError(f"want two (n, P) planes, got {tuple(Zr.shape)} "
                         f"and {tuple(Zi.shape)}")
    n, P = Zr.shape
    if P < num_freq_real(delta):
        raise ValueError(f"P={P} is below the {num_freq_real(delta)} "
                         f"points of the compact layout at delta={delta}")
    if tuple(bias.shape) != (n,):
        raise ValueError(f"bias must hold one value per tile ({n},), got "
                         f"{tuple(bias.shape)}")
    if len({t.device for t in (Zr, Zi, bias)}) != 1:
        raise ValueError("operands lie on different devices")
    # the kernel's contract, held on the CPU too so that host runs catch
    # what the card would refuse
    if any(t.dtype != torch.float32 for t in (Zr, Zi, bias)):
        raise TypeError("tile_irfft_epilogue takes float32 operands")
    if not all(t.is_contiguous() for t in (Zr, Zi, bias)):
        raise ValueError("tile_irfft_epilogue needs contiguous operands")


def tile_irfft_epilogue_cuda(Zr, Zi, bias, *, activation: str = "none",
                             delta: int = 16):
    """Compact-layout inverse tile DFT with the conv epilogue fused into the
    tail: 2x (n, P) + (n,) bias -> (n, delta, delta) float32, bias-shifted
    and activated.  Accepts ``P >= num_freq_real(delta)`` (trailing points
    are never read) and any ``delta <= 32``.  The planes are read row by
    row, so they must be contiguous (n, P): callers holding the CGEMM's
    (P, M, C') layout transpose it first."""
    _check(Zr, Zi, bias, activation, delta)
    device = Zr.device
    if device.type == "cpu":
        return tile_irfft_epilogue_ref(Zr, Zi, bias, activation=activation,
                                       delta=delta)
    if device.type != "cuda":
        raise ValueError(f"tile_irfft_epilogue_cuda: unsupported device "
                         f"{device}")
    n, P = Zr.shape
    y = torch.empty((n, delta, delta), dtype=torch.float32, device=device)
    if n == 0:
        return y
    *_, Fvr, Fvi, Wr, Wi = dft_mats(delta, device, torch.float32)
    _, src, sgn = compact_layout(delta, device)
    lib = _lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.tile_irfft_epilogue_f32(
            Zr.data_ptr(), Zi.data_ptr(), bias.data_ptr(), y.data_ptr(),
            Fvr.data_ptr(), Fvi.data_ptr(), Wr.data_ptr(), Wi.data_ptr(),
            src.data_ptr(), sgn.data_ptr(), n, P, delta,
            ACTIVATION_CODES[activation], stream)
    if rc != 0:
        raise RuntimeError(f"dft_tile kernel launch failed: "
                           f"{lib.dft_tile_error_string(rc).decode()} "
                           f"({rc})")
    tile_irfft_epilogue_cuda.launches += 1
    return y


tile_irfft_epilogue_cuda.launches = 0
