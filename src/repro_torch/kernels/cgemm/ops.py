"""Wrapper of the CUDA P-batched complex GEMM (stage 3 of ``fft-cuda``).

``cgemm_cuda`` dispatches on the operands' device: a CPU tensor runs the
plain PyTorch version (``ref.cgemm_ref``); a CUDA tensor launches the
``csrc/cgemm.cu`` kernel on the current stream, or raises.  It masks ragged
dims itself, so nothing is padded.  ``cgemm_cuda.launches`` counts the
kernel launches.  A fake operand (the static analyzer's,
``repro_torch.fake``) gets fake outputs of the plain version's shape and
dtype once the contract is checked: nothing is built, launched or
counted.

The kernel has two regimes on an H100, and ``choose_variant`` picks its
form from the shapes alone:

- large M (M > 32; Vconv1.x-3.x of the VGG trunk): bound by arithmetic on
  the CUDA cores (67 TFLOP/s float32).  Form ``large``: a 64x64 block
  tile, 128 threads, an 8x4 register micro-tile per product plane, a
  3-slot ``cp.async`` ring; two or three blocks share an SM.
- small M (M <= 32; Vconv4.1-5): bound by the bytes of the G slab at
  3.35 TB/s.  Form ``small``: BM in {4, 8, 16, 32} covers all of M, so
  each G element is read once per launch, streamed through a 3- or 4-slot
  ring.

Either form loads with 16-byte ``cp.async`` when every row of D and G is a
multiple of 16 bytes and every operand pointer is 16-byte aligned, and
otherwise with masked scalar loads (``Variant.scalar``; C = 3 at
Vconv1.1).  The variant only changes the kernel: a CUDA tensor never falls
back to the plain version.  The tiles and ring depths are the fastest of
those ``python -m repro_torch.kernels.cgemm.sweep`` timed on the card.

A caller may pin the tile: ``cgemm_cuda(..., shape=i)`` launches row ``i``
of ``SHAPES`` whatever M is (every row's grid covers any M), with the
load form still taken from the operands.  ``shape_for_blocks(bm, bn, bk)``
names the row of a plan's ``bm``/``bn``/``bk`` knobs, and
``cgemm_cuda.variant_launches`` counts the launches by variant name.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional

import torch

from repro_torch.fake import constant_cache, is_fake
from repro_torch.kernels import _build
from repro_torch.kernels.cgemm.ref import cgemm_ref

_ENTRY = {torch.float32: "cgemm_f32", torch.bfloat16: "cgemm_bf16"}

# (bm, bn, bk, tm, tn, stages): the table of csrc/cgemm.cu:kShapes, in its
# order (the index is the code passed to the kernel)
SHAPES = (
    (64, 64, 16, 8, 4, 3),
    (4, 128, 16, 1, 4, 3),
    (8, 128, 16, 2, 4, 4),
    (16, 128, 16, 4, 4, 4),
    (32, 128, 16, 8, 4, 4),
)
LARGE = 0
SMALL = (1, 2, 3, 4)
SMALL_M_MAX = 32                # the small-M form covers M <= this


@dataclasses.dataclass(frozen=True)
class Variant:
    """One launch configuration of the kernel."""
    code: int                   # passed to the kernel: shape (+ 5 if scalar)
    form: str                   # "large" or "small"
    scalar: bool                # masked scalar loads instead of cp.async
    bm: int
    bn: int
    bk: int
    threads: int
    stages: int                 # cp.async ring slots
    smem_bytes: int             # dynamic shared memory per block
    grid: tuple                 # (x, y, z) = (N tiles, M tiles, P)

    @property
    def name(self) -> str:
        return variant_name(self.code)


def variant_name(code: int) -> str:
    """``<form>-<bm>x<bn>[-scalar]`` of a variant code."""
    shape, scalar = code % len(SHAPES), code >= len(SHAPES)
    bm, bn = SHAPES[shape][:2]
    form = "small" if shape in SMALL else "large"
    return f"{form}-{bm}x{bn}" + ("-scalar" if scalar else "")


def shape_for_blocks(bm=None, bn=None, bk=None) -> Optional[int]:
    """The row of ``SHAPES`` that a (bm, bn, bk) triple names, ``None``
    entries matching any value; ``None`` when all three are ``None``.
    ``bm`` is unique across rows, so it alone names a row.  A triple that
    names no row, or more than one, is a ``ValueError``."""
    if bm is None and bn is None and bk is None:
        return None
    rows = [i for i, row in enumerate(SHAPES)
            if all(v is None or (type(v) is int and v == have)
                   for v, have in zip((bm, bn, bk), row))]
    if len(rows) != 1:
        table = ", ".join(f"{i}: (bm={r[0]}, bn={r[1]}, bk={r[2]})"
                          for i, r in enumerate(SHAPES))
        raise ValueError(
            f"bm={bm!r}, bn={bn!r}, bk={bk!r} name "
            f"{'no' if not rows else 'more than one'} row of the CUDA "
            f"CGEMM's tile table; its rows are {table} (bm alone names "
            "a row)")
    return rows[0]


def shape_smem_bytes(shape: int, element_size: int) -> int:
    """Dynamic shared memory of a tile shape (csrc/cgemm.cu:Layout):
    the ring of raw D (rows padded by 16 bytes) and G slices, D K-major
    in float32, and bf16 G widened to float32."""
    bm, bn, bk, _, _, stages = SHAPES[shape]
    vec = 16 // element_size
    stage = 2 * (bm * (bk + vec) + bk * bn) * element_size
    widened = 0 if element_size == 4 else 2 * bk * bn
    return stages * stage + 4 * (2 * bk * bm + widened)


def default_shape(M: int) -> int:
    """The row ``choose_variant`` picks for M when none is pinned."""
    return (next(i for i in SMALL if SHAPES[i][0] >= M)
            if M <= SMALL_M_MAX else LARGE)


# typed: a pin of True or 1.0 must not hit the cache entry of row 1
@functools.lru_cache(maxsize=4096, typed=True)
def choose_variant(P: int, M: int, C: int, N: int, dtype,
                   aligned: bool = True, shape: Optional[int] = None
                   ) -> Variant:
    """The kernel form for a (P, M, C) x (P, C, N) product.  ``aligned``
    says whether every operand's data pointer is 16-byte aligned.
    ``shape``, an index into ``SHAPES``, pins the tile in place of the
    M-based pick; the load form still follows the operands, so a pin
    never asks the kernel for ``cp.async`` on operands it refuses."""
    if dtype not in _ENTRY:
        raise TypeError(f"cgemm takes float32 or bfloat16, got {dtype}")
    _check_shape(shape)
    size = dtype.itemsize
    scalar = (not aligned or (C * size) % 16 != 0
              or (N * size) % 16 != 0)
    if shape is None:
        shape = default_shape(M)
    bm, bn, bk, tm, tn, stages = SHAPES[shape]
    return Variant(code=shape + len(SHAPES) * scalar,
                   form="small" if shape in SMALL else "large",
                   scalar=scalar, bm=bm, bn=bn, bk=bk,
                   threads=(bm // tm) * (bn // tn), stages=stages,
                   smem_bytes=shape_smem_bytes(shape, size),
                   grid=(-(-N // bn), -(-M // bm), P))


@constant_cache
def _lib():
    lib = _build.load("cgemm")
    for name in _ENTRY.values():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.cgemm_shape_info.argtypes = [ctypes.c_int, ctypes.c_int,
                                     ctypes.POINTER(ctypes.c_int)]
    lib.cgemm_shape_info.restype = ctypes.c_int
    lib.cgemm_num_shapes.restype = ctypes.c_int
    lib.cgemm_error_string.argtypes = [ctypes.c_int]
    lib.cgemm_error_string.restype = ctypes.c_char_p
    return lib


def compiled_shapes(dtype) -> list:
    """The kernel's own tile table, as built: one (bm, bn, bk, tm, tn,
    threads, stages, smem bytes) per shape.  Needs the built library."""
    lib = _lib()
    out = (ctypes.c_int * 8)()
    rows = []
    for i in range(lib.cgemm_num_shapes()):
        if lib.cgemm_shape_info(i, int(dtype == torch.bfloat16), out):
            raise RuntimeError(f"cgemm_shape_info({i}) failed")
        rows.append(tuple(out))
    return rows


def _check_shape(shape):
    if shape is not None and (type(shape) is not int
                              or not 0 <= shape < len(SHAPES)):
        raise ValueError(f"cgemm shape must be a row of SHAPES "
                         f"(0..{len(SHAPES) - 1}), got {shape!r}")


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


def operand_variant(Dr, Di, Gr, Gi, shape: Optional[int] = None
                    ) -> Variant:
    """The variant ``cgemm_cuda`` launches for these operands (with the
    tile row ``shape`` pinned, if given)."""
    P, M, C = Dr.shape
    aligned = all(t.data_ptr() % 16 == 0 for t in (Dr, Di, Gr, Gi))
    return choose_variant(P, M, C, Gr.shape[2], Dr.dtype, aligned, shape)


def cgemm_cuda(Dr, Di, Gr, Gi, *, three_m: bool = True,
               shape: Optional[int] = None):
    """Batched complex GEMM: (P,M,C) x (P,C,N) -> (P,M,N) (real, imag),
    3M (Karatsuba) or 4M, float32 accumulation, Z in the operand dtype.
    ``shape`` pins the kernel's tile row (``SHAPES``; ``None``: the
    chooser's pick)."""
    _check(Dr, Di, Gr, Gi)
    _check_shape(shape)
    P, M, C = Dr.shape
    N = Gr.shape[2]
    if is_fake(Dr):
        return Dr.new_empty((P, M, N)), Dr.new_empty((P, M, N))
    device = Dr.device
    if device.type == "cpu":
        return cgemm_ref(Dr, Di, Gr, Gi, three_m=three_m)
    if device.type != "cuda":
        raise ValueError(f"cgemm_cuda: unsupported device {device}")
    Zr = torch.empty((P, M, N), dtype=Dr.dtype, device=device)
    Zi = torch.empty((P, M, N), dtype=Dr.dtype, device=device)
    if Zr.numel() == 0:
        return Zr, Zi
    v = operand_variant(Dr, Di, Gr, Gi, shape)
    launch(Dr, Di, Gr, Gi, Zr, Zi, three_m, v.code)
    cgemm_cuda.launches += 1
    cgemm_cuda.variant_launches[v.name] += 1
    return Zr, Zi


def launch(Dr, Di, Gr, Gi, Zr, Zi, three_m: bool, code: int):
    """Launch variant ``code`` on checked CUDA operands and outputs; the
    kernel refuses a cp.async variant on operands it cannot take."""
    P, M, C = Dr.shape
    lib = _lib()
    with torch.cuda.device(Dr.device):
        stream = torch.cuda.current_stream(Dr.device).cuda_stream
        rc = getattr(lib, _ENTRY[Dr.dtype])(
            Dr.data_ptr(), Di.data_ptr(), Gr.data_ptr(), Gi.data_ptr(),
            Zr.data_ptr(), Zi.data_ptr(), P, M, C, Gr.shape[2],
            int(three_m), code, stream)
    if rc != 0:
        raise RuntimeError(f"cgemm kernel launch failed (variant {code}): "
                           f"{lib.cgemm_error_string(rc).decode()} ({rc})")


cgemm_cuda.launches = 0
cgemm_cuda.variant_launches = {variant_name(code): 0
                               for code in range(2 * len(SHAPES))}
