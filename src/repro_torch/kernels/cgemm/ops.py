"""Wrapper of the CUDA P-batched complex GEMM (stage 3 of ``fft-cuda``).

``cgemm_cuda`` dispatches on the operands' device: a CPU tensor runs the
plain PyTorch version (``ref.cgemm_ref``); a CUDA tensor launches the
``csrc/cgemm.cu`` kernel on the current stream, or raises.  The kernel's
tiles are fixed and it masks ragged dims itself, so nothing is padded.
``cgemm_cuda.launches`` counts the kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.cgemm.ref import cgemm_ref

_ENTRY = {torch.float32: "cgemm_f32", torch.bfloat16: "cgemm_bf16"}


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("cgemm")
    for name in _ENTRY.values():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.cgemm_error_string.argtypes = [ctypes.c_int]
    lib.cgemm_error_string.restype = ctypes.c_char_p
    return lib


def _check(Dr, Di, Gr, Gi):
    if Dr.dim() != 3 or Gr.dim() != 3:
        raise ValueError(f"cgemm wants D (P, M, C) and G (P, C, N), got "
                         f"{tuple(Dr.shape)} and {tuple(Gr.shape)}")
    P, M, C = Dr.shape
    if (Gr.shape[0], Gr.shape[1]) != (P, C):
        raise ValueError(f"cgemm shape mismatch: D {tuple(Dr.shape)} vs "
                         f"G {tuple(Gr.shape)}")
    if Di.shape != Dr.shape or Gi.shape != Gr.shape:
        raise ValueError("cgemm real and imaginary planes differ in shape")
    if len({t.device for t in (Dr, Di, Gr, Gi)}) != 1:
        raise ValueError("cgemm operands lie on different devices")
    # the kernel's contract, held on the CPU too so that host runs catch
    # what the card would refuse
    dtype = Dr.dtype
    if dtype not in _ENTRY or any(t.dtype != dtype for t in (Di, Gr, Gi)):
        got = [str(t.dtype) for t in (Dr, Di, Gr, Gi)]
        raise TypeError(f"cgemm takes float32 or bfloat16 operands of one "
                        f"dtype, got {got}")
    if not all(t.is_contiguous() for t in (Dr, Di, Gr, Gi)):
        raise ValueError("cgemm needs contiguous operands")


def cgemm_cuda(Dr, Di, Gr, Gi, *, three_m: bool = True):
    """Batched complex GEMM: (P,M,C) x (P,C,N) -> (P,M,N) (real, imag),
    3M (Karatsuba) or 4M, float32 accumulation, Z in the operand dtype."""
    _check(Dr, Di, Gr, Gi)
    device = Dr.device
    if device.type == "cpu":
        return cgemm_ref(Dr, Di, Gr, Gi, three_m=three_m)
    if device.type != "cuda":
        raise ValueError(f"cgemm_cuda: unsupported device {device}")
    dtype = Dr.dtype
    P, M, C = Dr.shape
    N = Gr.shape[2]
    Zr = torch.empty((P, M, N), dtype=dtype, device=device)
    Zi = torch.empty((P, M, N), dtype=dtype, device=device)
    if Zr.numel() == 0:
        return Zr, Zi
    lib = _lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, _ENTRY[dtype])(
            Dr.data_ptr(), Di.data_ptr(), Gr.data_ptr(), Gi.data_ptr(),
            Zr.data_ptr(), Zi.data_ptr(), P, M, C, N, int(three_m), stream)
    if rc != 0:
        raise RuntimeError(f"cgemm kernel launch failed: "
                           f"{lib.cgemm_error_string(rc).decode()} ({rc})")
    cgemm_cuda.launches += 1
    return Zr, Zi


cgemm_cuda.launches = 0
