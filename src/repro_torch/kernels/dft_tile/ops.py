"""Wrappers of the CUDA tile DFT kernels (stages 1, 2 and 4 of FFT
convolution).

On the compact ``spectrum="real"`` layout, the one ``fft-cuda`` plans run:

- ``tile_rfft_cuda``: forward tile DFT + compact gather (stages 1 and 2).
- ``tile_irfft_cuda``: compact scatter + inverse tile DFT (stage 4 with no
  fusable epilogue: the dx plans of training, residual epilogues).
- ``tile_irfft_epilogue_cuda``: the same inverse with bias + activation
  fused into the tail (the served stage 4).

On the rect rfft2 grid, ``(n, delta, delta//2 + 1)`` planes, reached through
the raw stage primitives' ``spectrum="rect"`` hooks (no plan uses it):

- ``tile_fft_cuda``: forward tile DFT (stages 1 and 2).
- ``tile_ifft_cuda``: inverse tile DFT (an unfused stage 4).
- ``tile_ifft_epilogue_cuda``: the same inverse with bias + activation
  fused into the tail (``conv.backends._cuda_fused_inverse``).

Each dispatches on the operands' device: a CPU tensor runs the plain
PyTorch version (``ref.py``); a CUDA tensor launches the
``csrc/dft_tile.cu`` kernel on the current stream, or raises.  Each counts
its launches in ``<wrapper>.launches``.  A fake operand (the static
analyzer's, ``repro_torch.fake``) gets fake outputs of the plain
version's shapes and dtypes once the contract is checked: nothing is
built, launched or counted.

The forward kernel has two forms, and ``choose_form`` picks one from the
tile size and the tile tensor's alignment: ``specialised`` (delta 16, the
tile of every plan path: rows and columns in registers, the DFT table
passed by value to the launch, 16-byte row loads) and ``generic`` (any
delta <= 32, or tiles whose data pointer is off 16 bytes).  The inverse
kernel has the same two forms, and ``choose_inverse_form`` picks one from
the tile size, the planes' and the output's alignment and the row stride:
``specialised`` (delta 16: columns and then rows in registers, Finv and W
by value, the compact scatter compiled in) and ``generic``.  The form only
changes the kernel: a CUDA tensor never falls back to the plain version.
Each wrapper counts its launches by form in ``<wrapper>.form_launches``.

The four inverse wrappers take ``tiles=``, the tiles one block of the
inverse kernel takes (warps a block in the generic form, a tile a warp):
one of ``INVERSE_TILES``, the values the kernel is compiled at, or ``None``
for ``DEFAULT_TILES``.  It is the port's ``dft_bt`` (the reference's
``bt``, its tiles per grid step of the inverse): ``resolve_tiles`` checks
a pin, and ``<wrapper>.tiles_launches`` counts launches by value.  The
function computed does not depend on it.
"""
from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from repro_torch.core.dft import compact_layout, dft_mats, num_freq_real
from repro_torch.fake import constant_cache, is_fake
from repro_torch.kernels import _build
from repro_torch.kernels.dft_tile.ref import (
    tile_fft_ref, tile_ifft_epilogue_ref, tile_ifft_ref,
    tile_irfft_epilogue_ref, tile_irfft_ref, tile_rfft_ref,
)

MAX_DELTA = 32                          # per-warp buffers in shared memory
ACTIVATION_CODES = {"none": 0, "relu": 1, "gelu": 2, "silu": 3}
# tiles a block of the inverse kernel, as compiled (csrc: launch_inverse)
INVERSE_TILES = (4, 8, 16)
DEFAULT_TILES = 8

_P = ctypes.c_void_p
_ARGTYPES = {
    # x, tr, ti, fr, fi, fhr, fhi, store, n, P, delta, form, tables, stream
    "tile_rfft_f32": [_P] * 8 + [ctypes.c_longlong] + [ctypes.c_int] * 3
    + [_P, _P],
    # zr, zi, y, fvr, fvi, wr, wi, src, sgn, n, ld, delta, form, tiles,
    # tables, stream
    "tile_irfft_f32": [_P] * 9 + [ctypes.c_longlong] + [ctypes.c_int] * 4
    + [_P, _P],
    # zr, zi, bias, y, fvr, fvi, wr, wi, src, sgn, n, ld, delta, act, form,
    # tiles, tables, stream
    "tile_irfft_epilogue_f32": [_P] * 10 + [ctypes.c_longlong]
    + [ctypes.c_int] * 5 + [_P, _P],
    # x, tr, ti, fr, fi, fhr, fhi, n, delta, form, tables, stream
    "tile_fft_f32": [_P] * 7 + [ctypes.c_longlong, ctypes.c_int,
                                ctypes.c_int, _P, _P],
    # zr, zi, y, fvr, fvi, wr, wi, n, delta, form, tiles, tables, stream
    "tile_ifft_f32": [_P] * 7 + [ctypes.c_longlong] + [ctypes.c_int] * 3
    + [_P, _P],
    # zr, zi, bias, y, fvr, fvi, wr, wi, n, delta, act, form, tiles, tables,
    # stream
    "tile_ifft_epilogue_f32": [_P] * 8 + [ctypes.c_longlong]
    + [ctypes.c_int] * 4 + [_P, _P],
}


@dataclasses.dataclass(frozen=True)
class Form:
    """One form of a tile DFT kernel, forward or inverse."""
    code: int                   # passed to the kernel (csrc: kForm*)
    name: str


GENERIC = Form(0, "generic")
SPECIALISED = Form(1, "specialised")
SPECIALISED_DELTA = 16


def choose_form(delta: int, ptr: int) -> Form:
    """The forward kernel's form for tiles of size ``delta`` whose data
    pointer is ``ptr``: the specialised form reads each tile row in 16-byte
    loads, so it needs delta 16 and a 16-byte-aligned pointer."""
    return _form(delta, ptr % 16 == 0)


@constant_cache
def _form(delta: int, aligned: bool) -> Form:
    return SPECIALISED if delta == SPECIALISED_DELTA and aligned else GENERIC


def choose_inverse_form(delta: int, ptrs, ld: int) -> Form:
    """The inverse kernel's form for tiles of size ``delta``, planes and
    output at the data pointers ``ptrs`` and planes of row stride ``ld``
    floats: the specialised form copies the planes' rows in vectors (8
    bytes compact, 16 rect) and writes the output in 16-byte stores, so it
    needs delta 16, every pointer 16-byte aligned and an even ``ld``."""
    return _inverse_form(delta, all(p % 16 == 0 for p in ptrs), ld % 2 == 0)


@constant_cache
def _inverse_form(delta: int, aligned: bool, even: bool) -> Form:
    return (SPECIALISED if delta == SPECIALISED_DELTA and aligned and even
            else GENERIC)


def resolve_tiles(tiles=None) -> int:
    """The tiles a block of the inverse kernel for the pin ``tiles``
    (``dft_bt``): ``None`` is ``DEFAULT_TILES``; a pin must be a positive
    int (the reference's ``resolve_bt`` check and message) and one of the
    compiled ``INVERSE_TILES``."""
    if tiles is None:
        return DEFAULT_TILES
    if isinstance(tiles, bool) or not isinstance(tiles, int) or tiles <= 0:
        raise ValueError(
            f"dft_tile block override bt must be a positive int or None, "
            f"got {tiles!r}")
    if tiles not in INVERSE_TILES:
        raise ValueError(
            f"dft_bt={tiles} is not compiled: the inverse tile DFT kernel "
            f"takes {INVERSE_TILES} tiles a block (or None for "
            f"{DEFAULT_TILES})")
    return tiles


@constant_cache
def forward_tables(delta: int) -> np.ndarray:
    """The host copy of the table the specialised form takes by value:
    F_half (= rows 0..delta//2 of F), real then imaginary, (2, delta//2 +
    1, delta) float32 -- the values of ``dft_mats``."""
    _, _, Fhr, Fhi, *_ = dft_mats(delta)
    return np.ascontiguousarray(np.stack([Fhr.numpy(), Fhi.numpy()]))


@constant_cache
def inverse_tables(delta: int) -> np.ndarray:
    """The host copy of the tables the specialised inverse takes by value,
    flat float32: rows 0..delta//2 of Finv, real then imaginary (each
    (delta//2 + 1, delta)), then rows 0..delta//2 of W, real then
    imaginary (each (delta//2 + 1, delta//2 + 1)) -- the values of
    ``dft_mats``."""
    dh = delta // 2 + 1
    *_, Fvr, Fvi, Wr, Wi = dft_mats(delta)
    return np.concatenate([m.numpy()[:dh].ravel()
                           for m in (Fvr, Fvi, Wr, Wi)])


@constant_cache
def _lib():
    lib = _build.load("dft_tile")
    for name, argtypes in _ARGTYPES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.dft_tile_error_string.argtypes = [ctypes.c_int]
    lib.dft_tile_error_string.restype = ctypes.c_char_p
    return lib


def _check_delta(name, delta):
    if not 1 <= delta <= MAX_DELTA:
        raise ValueError(f"{name} supports delta <= {MAX_DELTA}, got "
                         f"{delta}")


def _check_layout(name, tensors):
    """The kernels' contract, held on the CPU too so that host runs catch
    what the card would refuse."""
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"{name}: operands lie on different devices")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"{name} takes float32 operands")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} needs contiguous operands")


def _check_planes(name, Zr, Zi, delta):
    if Zr.dim() != 2 or Zi.shape != Zr.shape:
        raise ValueError(f"{name} wants two (n, P) planes, got "
                         f"{tuple(Zr.shape)} and {tuple(Zi.shape)}")
    if Zr.shape[1] < num_freq_real(delta):
        raise ValueError(f"P={Zr.shape[1]} is below the "
                         f"{num_freq_real(delta)} points of the compact "
                         f"layout at delta={delta}")


def _check_rect_planes(name, Zr, Zi, delta):
    dh = delta // 2 + 1
    if Zr.dim() != 3 or tuple(Zr.shape[1:]) != (delta, dh) \
            or Zi.shape != Zr.shape:
        raise ValueError(f"{name} wants two (n, {delta}, {dh}) planes, got "
                         f"{tuple(Zr.shape)} and {tuple(Zi.shape)}")


def _check_tiles(name, x, delta):
    if x.dim() != 3 or tuple(x.shape[1:]) != (delta, delta):
        raise ValueError(f"{name} wants tiles (n, {delta}, {delta}), got "
                         f"{tuple(x.shape)}")


def _check_bias(Zr, bias):
    if tuple(bias.shape) != (Zr.shape[0],):
        raise ValueError(f"bias must hold one value per tile "
                         f"({Zr.shape[0]},), got {tuple(bias.shape)}")


def _check_activation(activation):
    if activation not in ACTIVATION_CODES:
        raise ValueError(f"unsupported kernel-tail activation "
                         f"{activation!r}: {tuple(ACTIVATION_CODES)}")


def _cuda_device(name, device):
    if device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {device}")


# torch's raw handle of the current stream: a private call (used here with
# torch 2.11.0+cu128) that costs far less host time than
# ``torch.cuda.current_stream(device).cuda_stream``, which a small launch
# pays in full; the public call where a release drops it
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def _stream(device):
    """The handle of ``device``'s current stream."""
    if _raw_stream is not None:
        return _raw_stream(device.index)
    return torch.cuda.current_stream(device).cuda_stream


def _launch(entry, device, *args):
    """Launch the kernel entry point ``entry`` on ``device``'s current
    stream (tensors pass as their data pointers); raise if the launch
    failed."""
    if device.index == torch.cuda.current_device():
        rc = getattr(_lib(), entry)(*args, _stream(device))
    else:
        with torch.cuda.device(device):
            rc = getattr(_lib(), entry)(*args, _stream(device))
    if rc != 0:
        raise RuntimeError(f"dft_tile kernel launch failed: "
                           f"{_lib().dft_tile_error_string(rc).decode()} "
                           f"({rc})")


def _count(wrapper, form, tiles=None):
    """One launch of ``wrapper``'s kernel in form ``form`` (an inverse's
    at ``tiles`` tiles a block)."""
    wrapper.launches += 1
    wrapper.form_launches[form.name] += 1
    if tiles is not None:
        wrapper.tiles_launches[tiles] += 1


@constant_cache
def _forward_consts(delta, device):
    """The forward launch's constant arguments, cached per device: the data
    pointers of the generic form's tables F, F_half (the caches of
    ``dft_mats`` and ``compact_layout`` keep them alive) and ``store``, and
    the address of the specialised form's host table."""
    Fr, Fi, Fhr, Fhi, *_ = dft_mats(delta, device, torch.float32)
    store, _, _ = compact_layout(delta, device)
    return (tuple(t.data_ptr() for t in (Fr, Fi, Fhr, Fhi)),
            store.data_ptr(), forward_tables(delta).ctypes.data)


def tile_rfft_cuda(x, *, delta: int = 16):
    """Forward tile DFT + compact-Hermitian gather: tiles (n, delta, delta)
    -> two (n, P_real) planes, ``P_real = num_freq_real(delta)``.  Tiles
    are read contiguous and the planes written contiguous (the Pallas
    contract); any ``delta <= 32``, odd included."""
    name = "tile_rfft"
    _check_delta(name, delta)
    _check_tiles(name, x, delta)
    _check_layout(name, (x,))
    P = num_freq_real(delta)
    if is_fake(x):
        return x.new_empty((x.shape[0], P)), x.new_empty((x.shape[0], P))
    device = x.device
    if device.type == "cpu":
        return tile_rfft_ref(x, delta)
    _cuda_device(name, device)
    n = x.shape[0]
    Tr = x.new_empty((n, P))        # x's float32 and device, less host time
    Ti = x.new_empty((n, P))
    if n == 0:
        return Tr, Ti
    mats, store, table = _forward_consts(delta, device)
    ptr = x.data_ptr()
    form = choose_form(delta, ptr)
    _launch("tile_rfft_f32", device, ptr, Tr.data_ptr(), Ti.data_ptr(),
            *mats, store, n, P, delta, form.code, table)
    _count(tile_rfft_cuda, form)
    return Tr, Ti


@constant_cache
def _inverse_consts(delta, device):
    """The inverse launch's constant arguments, cached per device: the data
    pointers of the generic form's tables Finv, W (the caches of
    ``dft_mats`` and ``compact_layout`` keep them alive) and of the compact
    layout's ``src``, ``sgn``, and the address of the specialised form's
    host table."""
    *_, Fvr, Fvi, Wr, Wi = dft_mats(delta, device, torch.float32)
    _, src, sgn = compact_layout(delta, device)
    return (tuple(t.data_ptr() for t in (Fvr, Fvi, Wr, Wi)),
            (src.data_ptr(), sgn.data_ptr()),
            inverse_tables(delta).ctypes.data)


def _inverse_output(Zr, Zi, delta, ld):
    """The output tiles (n, delta, delta) on the planes' device, the
    planes' and the output's data pointers and the form they take."""
    y = Zr.new_empty((Zr.shape[0], delta, delta))  # float32, less host time
    ptrs = (Zr.data_ptr(), Zi.data_ptr(), y.data_ptr())
    return y, ptrs, choose_inverse_form(delta, ptrs, ld)


def tile_irfft_cuda(Zr, Zi, *, delta: int = 16, tiles=None):
    """Compact-layout inverse tile DFT with no tail: two (n, P) planes ->
    (n, delta, delta) float32.  Accepts ``P >= num_freq_real(delta)``
    (trailing points are never read) and any ``delta <= 32``.  The planes
    are read row by row, so they must be contiguous (n, P).  ``tiles``:
    tiles a block (``resolve_tiles``)."""
    name = "tile_irfft"
    tiles = resolve_tiles(tiles)
    _check_delta(name, delta)
    _check_planes(name, Zr, Zi, delta)
    _check_layout(name, (Zr, Zi))
    if is_fake(Zr):
        return Zr.new_empty((Zr.shape[0], delta, delta))
    device = Zr.device
    if device.type == "cpu":
        return tile_irfft_ref(Zr, Zi, delta)
    _cuda_device(name, device)
    n, P = Zr.shape
    y, (zr, zi, out), form = _inverse_output(Zr, Zi, delta, P)
    if n == 0:
        return y
    mats, layout, table = _inverse_consts(delta, device)
    _launch("tile_irfft_f32", device, zr, zi, out, *mats, *layout, n, P,
            delta, form.code, tiles, table)
    _count(tile_irfft_cuda, form, tiles)
    return y


def tile_irfft_epilogue_cuda(Zr, Zi, bias, *, activation: str = "none",
                             delta: int = 16, tiles=None):
    """Compact-layout inverse tile DFT with the conv epilogue fused into the
    tail: 2x (n, P) + (n,) bias -> (n, delta, delta) float32, bias-shifted
    and activated.  Accepts ``P >= num_freq_real(delta)`` (trailing points
    are never read) and any ``delta <= 32``.  The planes are read row by
    row, so they must be contiguous (n, P): callers holding the CGEMM's
    (P, M, C') layout transpose it first.  ``tiles``: tiles a block
    (``resolve_tiles``)."""
    name = "tile_irfft_epilogue"
    tiles = resolve_tiles(tiles)
    _check_activation(activation)
    _check_delta(name, delta)
    _check_planes(name, Zr, Zi, delta)
    _check_bias(Zr, bias)
    _check_layout(name, (Zr, Zi, bias))
    if is_fake(Zr):
        return Zr.new_empty((Zr.shape[0], delta, delta))
    device = Zr.device
    if device.type == "cpu":
        return tile_irfft_epilogue_ref(Zr, Zi, bias, activation=activation,
                                       delta=delta)
    _cuda_device(name, device)
    n, P = Zr.shape
    y, (zr, zi, out), form = _inverse_output(Zr, Zi, delta, P)
    if n == 0:
        return y
    mats, layout, table = _inverse_consts(delta, device)
    _launch("tile_irfft_epilogue_f32", device, zr, zi, bias.data_ptr(), out,
            *mats, *layout, n, P, delta, ACTIVATION_CODES[activation],
            form.code, tiles, table)
    _count(tile_irfft_epilogue_cuda, form, tiles)
    return y


def tile_fft_cuda(x, *, delta: int = 16):
    """Forward tile DFT on the rect grid: tiles (n, delta, delta) -> two
    (n, delta, delta//2 + 1) planes, the rfft2 of each tile.  Tiles are
    read contiguous and the planes written contiguous (the Pallas
    contract); any ``delta <= 32``, odd included."""
    name = "tile_fft"
    _check_delta(name, delta)
    _check_tiles(name, x, delta)
    _check_layout(name, (x,))
    if is_fake(x):
        shape = (x.shape[0], delta, delta // 2 + 1)
        return x.new_empty(shape), x.new_empty(shape)
    device = x.device
    if device.type == "cpu":
        return tile_fft_ref(x, delta)
    _cuda_device(name, device)
    n = x.shape[0]
    Tr = x.new_empty((n, delta, delta // 2 + 1))
    Ti = x.new_empty((n, delta, delta // 2 + 1))
    if n == 0:
        return Tr, Ti
    mats, _, table = _forward_consts(delta, device)
    ptr = x.data_ptr()
    form = choose_form(delta, ptr)
    _launch("tile_fft_f32", device, ptr, Tr.data_ptr(), Ti.data_ptr(), *mats,
            n, delta, form.code, table)
    _count(tile_fft_cuda, form)
    return Tr, Ti


def tile_ifft_cuda(Zr, Zi, *, delta: int = 16, tiles=None):
    """Inverse tile DFT from the rect grid with no tail: two contiguous
    (n, delta, delta//2 + 1) planes -> (n, delta, delta) float32, the
    irfft2 of each tile; any ``delta <= 32``.  ``tiles``: tiles a block
    (``resolve_tiles``)."""
    name = "tile_ifft"
    tiles = resolve_tiles(tiles)
    _check_delta(name, delta)
    _check_rect_planes(name, Zr, Zi, delta)
    _check_layout(name, (Zr, Zi))
    if is_fake(Zr):
        return Zr.new_empty((Zr.shape[0], delta, delta))
    device = Zr.device
    if device.type == "cpu":
        return tile_ifft_ref(Zr, Zi, delta)
    _cuda_device(name, device)
    n = Zr.shape[0]
    y, (zr, zi, out), form = _inverse_output(Zr, Zi, delta,
                                             delta * (delta // 2 + 1))
    if n == 0:
        return y
    mats, _, table = _inverse_consts(delta, device)
    _launch("tile_ifft_f32", device, zr, zi, out, *mats, n, delta, form.code,
            tiles, table)
    _count(tile_ifft_cuda, form, tiles)
    return y


def tile_ifft_epilogue_cuda(Zr, Zi, bias, *, activation: str = "none",
                            delta: int = 16, tiles=None):
    """Inverse tile DFT from the rect grid with the conv epilogue fused
    into the tail: two contiguous (n, delta, delta//2 + 1) planes + (n,)
    bias -> (n, delta, delta) float32, bias-shifted and activated; any
    ``delta <= 32``.  ``tiles``: tiles a block (``resolve_tiles``)."""
    name = "tile_ifft_epilogue"
    tiles = resolve_tiles(tiles)
    _check_activation(activation)
    _check_delta(name, delta)
    _check_rect_planes(name, Zr, Zi, delta)
    _check_bias(Zr, bias)
    _check_layout(name, (Zr, Zi, bias))
    if is_fake(Zr):
        return Zr.new_empty((Zr.shape[0], delta, delta))
    device = Zr.device
    if device.type == "cpu":
        return tile_ifft_epilogue_ref(Zr, Zi, bias, activation=activation,
                                      delta=delta)
    _cuda_device(name, device)
    n = Zr.shape[0]
    y, (zr, zi, out), form = _inverse_output(Zr, Zi, delta,
                                             delta * (delta // 2 + 1))
    if n == 0:
        return y
    mats, _, table = _inverse_consts(delta, device)
    _launch("tile_ifft_epilogue_f32", device, zr, zi, bias.data_ptr(), out,
            *mats, n, delta, ACTIVATION_CODES[activation], form.code, tiles,
            table)
    _count(tile_ifft_epilogue_cuda, form, tiles)
    return y


# launches of each kernel, by form (``choose_form``,
# ``choose_inverse_form``), and the inverses' by tiles a block
for _wrapper in (tile_rfft_cuda, tile_irfft_cuda, tile_irfft_epilogue_cuda,
                 tile_fft_cuda, tile_ifft_cuda, tile_ifft_epilogue_cuda):
    _wrapper.launches = 0
    _wrapper.form_launches = {GENERIC.name: 0, SPECIALISED.name: 0}
for _wrapper in (tile_irfft_cuda, tile_irfft_epilogue_cuda, tile_ifft_cuda,
                 tile_ifft_epilogue_cuda):
    _wrapper.tiles_launches = dict.fromkeys(INVERSE_TILES, 0)
del _wrapper
