"""The port's CUDA kernels on the card, held to their plain PyTorch
versions; and an ``fft-cuda`` plan on the card held to cuDNN.

Every test here needs an NVIDIA GPU and skips without one (the kernels
have no CPU mode).  The file imports neither jax nor repro, so it runs on
a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: CGEMM scaled atol 2e-5 in float32 and 5e-2 with bf16
operands (as tests/test_kernels.py), at ragged M, C and N that reach every
variant of the kernel (each tile, each small-M row tile, cp.async and
scalar loads), on operands offset from 16 bytes, and at a prepared slab's
shape at P = 144; the forward tile DFTs (compact and
rect, in both kernel forms, on aligned tiles and on a 4-byte-offset view)
scaled atol 2e-5; the forward's image form (stage 1 in one pass) equal
bit for bit to the composed stage 1 at every Table-I layer, a dx plan's
geometry and strided views, and launched for every stage 1 of a plan;
the inverses and fused inverses (in both kernel forms, on aligned planes,
on NaN-padded compact rows and on 4-byte-offset views) 1e-4 absolute on
unit-scale spectra; a whole conv, and its grads, 3e-4 against cuDNN with
TF32 off.  The serve engine's CUDA graphs (one per
replica and bucket) against the eager prepared forward of the same
kernels and spectra: 1e-5 of the largest |y| (the same kernels run on the
same operands).  Every row of the CGEMM's tile table pinned at each layer
of the served trunk, against the unpinned launch: scaled atol 2e-5; and
the measured autotuner's sweep and cache round trip on the card.  The
sharded schedules on a one-rank NCCL mesh (one card): ``fft-cuda``
``nfft``/``wfft`` against ``fft-torch`` on the same mesh and against the
local ``fft-cuda`` plan, 1e-5 of the largest |y|, with exact launches and
collectives; and the serving engine on that mesh, its graphs' replays
within 1e-5 of the largest |y| of the eager sharded forward, its
collectives counted at warm-up and capture only.  Across two or four
cards (it skips with fewer than two), the engine's replays run NCCL
kernels and give the local engine's rows within 1e-5 of the largest |y|.
"""
import itertools
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

from repro_torch.configs.paper_convs import TABLE1  # noqa: E402
from repro_torch.conv import (  # noqa: E402
    Epilogue, NetworkConv, plan_conv, plan_network, stages)
from repro_torch.conv.backends import _cuda_fused_inverse  # noqa: E402
from repro_torch.core.dft import (  # noqa: E402
    compact_layout, dft_mats, num_freq_real)
from repro_torch.core.fftconv import (  # noqa: E402
    conv2d_direct, input_transform, make_spec)
from repro_torch.kernels.cgemm import (  # noqa: E402
    cgemm_cuda, cgemm_ref, operand_variant)
from repro_torch.kernels.cgemm.ops import (  # noqa: E402
    LARGE, SHAPES, SMALL, compiled_shapes, shape_smem_bytes)
from repro_torch.kernels.dft_tile import (  # noqa: E402
    image_rfft_cuda, tile_fft_cuda, tile_fft_ref, tile_ifft_cuda,
    tile_ifft_epilogue_cuda, tile_ifft_epilogue_ref, tile_ifft_ref,
    tile_irfft_cuda, tile_irfft_epilogue_cuda, tile_irfft_epilogue_ref,
    tile_irfft_ref, tile_rfft_cuda, tile_rfft_ref)
from repro_torch.kernels.dft_tile import ops as dft_ops  # noqa: E402
from repro_torch.kernels.dft_tile.ops import (  # noqa: E402
    GENERIC, SPECIALISED, choose_form, choose_inverse_form)
from repro_torch.launch.batcher import (  # noqa: E402
    WARMUP_PASSES, BucketPolicy, ServeEngine)

pytestmark = pytest.mark.cuda

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ACTIVATIONS = ["none", "relu", "gelu", "silu"]
# every M with every C and every N (the other dim cycling), so that each
# variant is launched; then larger shapes, and a prepared slab at P = 144
CGEMM_MS = (1, 4, 8, 15, 16, 17, 32, 33, 64, 65, 1024)
CGEMM_CS = (1, 3, 4, 5, 17, 64, 513)
CGEMM_NS = (1, 3, 64, 65, 512)
CGEMM_CASES = (
    [(2, M, C, CGEMM_NS[i % len(CGEMM_NS)])
     for i, (M, C) in enumerate(itertools.product(CGEMM_MS, CGEMM_CS))]
    + [(2, M, CGEMM_CS[i % len(CGEMM_CS)], N)
       for i, (M, N) in enumerate(itertools.product(CGEMM_MS, CGEMM_NS))]
    + [(4, 128, 128, 128), (3, 200, 67, 130), (2, 16, 3, 5),
       (1, 256, 64, 256), (9, 32, 512, 64), (130, 4, 512, 512),
       (144, 16, 512, 512)])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _ptrs(*tensors):
    return [t.data_ptr() for t in tensors]


def _rand(shape, seed):
    return torch.from_numpy(
        np.random.default_rng(seed).standard_normal(shape).astype(
            np.float32))


def _cgemm_operands(P, M, C, N, dtype, device, offset=False):
    """The four planes, random from a seed; with ``offset`` each lies one
    element past an allocation (a 4-byte-offset view in float32)."""
    gen = torch.Generator(device=device).manual_seed(P + 7 * M + 31 * C + N)
    ops = []
    for shape in ((P, M, C), (P, M, C), (P, C, N), (P, C, N)):
        t = torch.randn(shape, generator=gen, device=device).to(dtype)
        if offset:
            n = t.numel()
            t = torch.empty(n + 1, dtype=dtype, device=device)[1:].view(
                shape).copy_(t)
        ops.append(t)
    return ops


def _check_cgemm(ops, three_m, dtype):
    before = cgemm_cuda.launches
    Zr, Zi = cgemm_cuda(*ops, three_m=three_m)
    Rr, Ri = cgemm_ref(*ops, three_m=three_m)
    torch.cuda.synchronize()
    assert cgemm_cuda.launches == before + 1
    assert Zr.dtype == dtype
    scale = Rr.float().abs().max().item() + 1e-9
    tol = 2e-5 if dtype == torch.float32 else 5e-2
    for ours, ref in ((Zr, Rr), (Zi, Ri)):
        err = (ours.float() - ref.float()).abs().max().item() / scale
        assert err <= tol, (tuple(ops[0].shape), ops[2].shape[2], err)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("three_m", [True, False])
def test_cgemm_kernel_matches_plain(cuda, dtype, three_m):
    codes = set()
    for P, M, C, N in CGEMM_CASES:
        ops = _cgemm_operands(P, M, C, N, dtype, cuda)
        codes.add(operand_variant(*ops).code)
        _check_cgemm(ops, three_m, dtype)
    # every variant the chooser gives ran: each tile, cp.async and scalar
    assert codes == {i + len(SHAPES) * scalar for i in (LARGE,) + SMALL
                     for scalar in (0, 1)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("three_m", [True, False])
def test_cgemm_kernel_on_offset_views(cuda, dtype, three_m):
    """Operands whose data pointers are off 16 bytes take the scalar-load
    form, of the large tile and of the small ones."""
    for P, M, C, N in ((2, 200, 64, 128), (3, 16, 512, 512), (2, 5, 17, 3)):
        ops = _cgemm_operands(P, M, C, N, dtype, cuda, offset=True)
        assert operand_variant(*ops).scalar
        _check_cgemm(ops, three_m, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cgemm_compiled_tiles_match_the_chooser(cuda, dtype):
    """ops.SHAPES and shape_smem_bytes are the kernel's own table."""
    size = torch.tensor([], dtype=dtype).element_size()
    assert compiled_shapes(dtype) == [
        (bm, bn, bk, tm, tn, (bm // tm) * (bn // tn), st,
         shape_smem_bytes(i, size))
        for i, (bm, bn, bk, tm, tn, st) in enumerate(SHAPES)]


@pytest.mark.parametrize("delta,pad", [(8, 0), (15, 0), (16, 0), (16, 6),
                                       (32, 0)])
def test_irfft_epilogue_kernel_matches_plain(cuda, delta, pad):
    P = num_freq_real(delta) + pad
    zr, zi = _rand((1000, P), 1).to(cuda), _rand((1000, P), 2).to(cuda)
    b = _rand((1000,), 3).to(cuda)
    for activation in ACTIVATIONS:
        before = tile_irfft_epilogue_cuda.launches
        y = tile_irfft_epilogue_cuda(zr, zi, b, activation=activation,
                                     delta=delta)
        y0 = tile_irfft_epilogue_ref(zr, zi, b, activation=activation,
                                     delta=delta)
        torch.cuda.synchronize()
        assert tile_irfft_epilogue_cuda.launches == before + 1
        assert (y - y0).abs().max().item() <= 1e-4


# forward kernels: n = 0 returns empty planes without a launch; the other
# counts are not all multiples of a block's tiles (8 in the specialised
# form, so 20001 ends in a block of one tile)
FORWARD_TILE_COUNTS = (0, 1, 7, 1001, 3000, 3001, 20001)


def _check_forward(wrapper, ref, x, delta, out_shape, form=None):
    """One launch of a forward wrapper on tiles ``x``, in the form the
    chooser gives (``form``, when given), held to its plain version; the
    wrapper's per-form count shows the form it launched."""
    n = x.shape[0]
    got_form = choose_form(delta, x.data_ptr())
    if form is not None:
        assert got_form == form
    before = wrapper.launches
    forms = dict(wrapper.form_launches)
    Tr, Ti = wrapper(x, delta=delta)
    Rr, Ri = ref(x, delta)
    torch.cuda.synchronize()
    assert wrapper.launches == before + (n > 0)
    forms[got_form.name] += n > 0
    assert wrapper.form_launches == forms
    assert Tr.shape == Ti.shape == out_shape
    if n:
        scale = max(Rr.abs().max().item(), Ri.abs().max().item())
        for ours, ref_plane in ((Tr, Rr), (Ti, Ri)):
            err = (ours - ref_plane).abs().max().item() / scale
            assert err <= 2e-5, (delta, n, got_form.name, err)
    return got_form


@pytest.mark.parametrize("delta", [5, 8, 15, 16, 32])
def test_rfft_kernel_matches_plain(cuda, delta):
    """Both forms: the specialised one at delta 16, the generic elsewhere."""
    want = SPECIALISED if delta == 16 else GENERIC
    for n in FORWARD_TILE_COUNTS:
        x = _rand((n, delta, delta), delta).to(cuda)
        _check_forward(tile_rfft_cuda, tile_rfft_ref, x, delta,
                       (n, num_freq_real(delta)), want)


@pytest.mark.parametrize("delta,pad", [(5, 0), (8, 0), (15, 0), (16, 0),
                                       (16, 6), (32, 0)])
def test_irfft_kernel_matches_plain(cuda, delta, pad):
    P = num_freq_real(delta) + pad
    zr, zi = _rand((1000, P), 7).to(cuda), _rand((1000, P), 8).to(cuda)
    before = tile_irfft_cuda.launches
    y = tile_irfft_cuda(zr, zi, delta=delta)
    y0 = tile_irfft_ref(zr, zi, delta)
    torch.cuda.synchronize()
    assert tile_irfft_cuda.launches == before + 1
    assert (y - y0).abs().max().item() <= 1e-4


# rect inverse kernels: n = 0 returns empty planes without a launch; 1001
# is not a multiple of a block's 8 warps
RECT_TILE_COUNTS = (0, 1, 1001)


@pytest.mark.parametrize("delta", [5, 8, 15, 16, 32])
def test_fft_kernel_matches_plain(cuda, delta):
    """Both forms: the specialised one at delta 16, the generic elsewhere."""
    want = SPECIALISED if delta == 16 else GENERIC
    for n in FORWARD_TILE_COUNTS:
        x = _rand((n, delta, delta), 20 + delta).to(cuda)
        _check_forward(tile_fft_cuda, tile_fft_ref, x, delta,
                       (n, delta, delta // 2 + 1), want)


@pytest.mark.parametrize("delta", [5, 16])
def test_forward_kernels_on_offset_views(cuda, delta):
    """Contiguous tiles one float past an allocation (a 4-byte offset):
    the generic form, held to the plain version; the outputs the wrapper
    allocates stay aligned."""
    for n in (1, 7, 1001):
        base = _rand((n, delta, delta), 90 + n)
        x = torch.empty(base.numel() + 1, device=cuda)[1:].view(
            n, delta, delta).copy_(base.to(cuda))
        assert x.is_contiguous() and x.data_ptr() % 16 == 4
        _check_forward(tile_rfft_cuda, tile_rfft_ref, x, delta,
                       (n, num_freq_real(delta)), GENERIC)
        _check_forward(tile_fft_cuda, tile_fft_ref, x, delta,
                       (n, delta, delta // 2 + 1), GENERIC)


def test_specialised_form_refuses_a_misaligned_view(cuda):
    """Forced onto tiles off 16 bytes, the specialised form refuses to
    launch (no silent fallback): the wrapper raises."""
    x = torch.zeros(16 * 16 * 8 + 1, device=cuda)[1:].view(8, 16, 16)
    Tr, Ti = (torch.empty((8, num_freq_real(16)), device=cuda)
              for _ in range(2))
    Fr, Fi, Fhr, Fhi, *_ = dft_mats(16, cuda, torch.float32)
    store, _, _ = compact_layout(16, cuda)
    with pytest.raises(RuntimeError, match="launch failed"):
        dft_ops._launch("tile_rfft_f32", x.device,
                        *_ptrs(x, Tr, Ti, Fr, Fi, Fhr, Fhi, store),
                        8, num_freq_real(16), 16,
                        SPECIALISED.code,
                        dft_ops.forward_tables(16).ctypes.data)


# the inverse wrappers: (wrapper, plain version, compact, fused tail)
INVERSES = (
    (tile_irfft_cuda, tile_irfft_ref, True, False),
    (tile_irfft_epilogue_cuda, tile_irfft_epilogue_ref, True, True),
    (tile_ifft_cuda, tile_ifft_ref, False, False),
    (tile_ifft_epilogue_cuda, tile_ifft_epilogue_ref, False, True),
)
INVERSE_IDS = ["irfft", "irfft_epilogue", "ifft", "ifft_epilogue"]


def _inverse_planes(n, compact, device, seed, pad=0, offset=False):
    """Two random planes of n tiles at delta 16: (n, 130 + pad) compact,
    with NaN past point 130 (never to be read), or (n, 16, 9) rect; with
    ``offset`` each lies one float past an allocation."""
    shape = (n, 130 + pad) if compact else (n, 16, 9)
    planes = []
    for k in range(2):
        t = _rand(shape, seed + k).to(device)
        if offset:
            t = torch.empty(t.numel() + 1, device=device)[1:].view(
                shape).copy_(t)
        if pad:
            t[:, 130:] = float("nan")
        planes.append(t)
    return planes


def _check_inverse(wrapper, ref, compact, tail, Zr, Zi, form, activation):
    """One launch of an inverse wrapper, held to its plain version (on the
    planes' first 130 points, compact) within 1e-4; the wrapper's per-form
    count shows it launched ``form``."""
    n = Zr.shape[0]
    b = _rand((n,), 77).to(Zr.device)
    args = (Zr, Zi, b) if tail else (Zr, Zi)
    kw = dict(activation=activation) if tail else {}
    before, forms = wrapper.launches, dict(wrapper.form_launches)
    y = wrapper(*args, delta=16, **kw)
    if compact:
        args = (Zr[:, :130], Zi[:, :130]) + args[2:]
    y0 = ref(*args, delta=16, **kw)
    torch.cuda.synchronize()
    assert wrapper.launches == before + (n > 0)
    forms[form.name] += n > 0
    assert wrapper.form_launches == forms
    assert y.shape == (n, 16, 16)
    if n:
        assert bool(torch.isfinite(y).all())
        assert (y - y0).abs().max().item() <= 1e-4


@pytest.mark.parametrize("wrapper,ref,compact,tail", INVERSES,
                         ids=INVERSE_IDS)
def test_specialised_inverse_at_delta_16(cuda, wrapper, ref, compact, tail):
    """Every inverse wrapper takes the specialised form at delta 16 on
    aligned planes (tile counts that end in a part block, and 0, which
    launches nothing), under every activation with the tail."""
    for n in FORWARD_TILE_COUNTS:
        Zr, Zi = _inverse_planes(n, compact, cuda, 200 + n)
        assert choose_inverse_form(16, (Zr.data_ptr(), Zi.data_ptr()),
                                   130 if compact else 144) == SPECIALISED
        for activation in (ACTIVATIONS if tail and n == 1001 else ["relu"]):
            _check_inverse(wrapper, ref, compact, tail, Zr, Zi, SPECIALISED,
                           activation)


@pytest.mark.parametrize("wrapper,ref,tail", [
    (tile_irfft_cuda, tile_irfft_ref, False),
    (tile_irfft_epilogue_cuda, tile_irfft_epilogue_ref, True)],
    ids=["irfft", "irfft_epilogue"])
def test_specialised_inverse_reads_no_trailing_point(cuda, wrapper, ref,
                                                     tail):
    """Compact planes padded to P = 136 with NaN past point 130: the
    specialised form reads rows of stride 136 and none of the NaNs."""
    for n in (1, 7, 1001):
        Zr, Zi = _inverse_planes(n, True, cuda, 300 + n, pad=6)
        _check_inverse(wrapper, ref, True, tail, Zr, Zi, SPECIALISED,
                       "relu")


@pytest.mark.parametrize("wrapper,ref,compact,tail", INVERSES,
                         ids=INVERSE_IDS)
def test_inverse_on_offset_views(cuda, wrapper, ref, compact, tail):
    """Planes one float past an allocation (a 4-byte offset) take the
    generic form through choose_inverse_form, held to the plain version."""
    for n in (1, 7, 1001):
        Zr, Zi = _inverse_planes(n, compact, cuda, 400 + n, offset=True)
        assert Zr.data_ptr() % 16 == 4
        _check_inverse(wrapper, ref, compact, tail, Zr, Zi, GENERIC, "relu")


def test_specialised_inverse_refuses_a_misaligned_view(cuda):
    """Forced onto planes off 16 bytes, or onto an odd row stride, the
    specialised inverse refuses to launch (no silent fallback): the
    wrapper's launch raises."""
    y = torch.empty((8, 16, 16), device=cuda)
    mats, layout, table = dft_ops._inverse_consts(16, y.device)
    for P, offset in ((130, True), (131, False)):
        Zr, Zi = (torch.zeros(8 * P + 1, device=cuda)[int(offset):][
            :8 * P].view(8, P) for _ in range(2))
        with pytest.raises(RuntimeError, match="launch failed"):
            dft_ops._launch("tile_irfft_f32", y.device,
                            *_ptrs(Zr, Zi, y), *mats, *layout, 8, P,
                            16, SPECIALISED.code, dft_ops.DEFAULT_TILES,
                            table)
    Zr, Zi = _inverse_planes(8, False, cuda, 5, offset=True)
    with pytest.raises(RuntimeError, match="launch failed"):
        dft_ops._launch("tile_ifft_f32", y.device,
                        *_ptrs(Zr, Zi, y), *mats, 8, 16,
                        SPECIALISED.code, dft_ops.DEFAULT_TILES, table)


@pytest.mark.parametrize("tiles", dft_ops.INVERSE_TILES)
@pytest.mark.parametrize("wrapper,ref,compact,tail", INVERSES,
                         ids=INVERSE_IDS)
def test_inverse_at_every_tiles_value(cuda, wrapper, ref, compact, tail,
                                      tiles):
    """Every inverse wrapper at every compiled number of tiles a block
    (``dft_bt``): the specialised form at delta 16 on tile counts that end
    in a part block of every size, the generic form on offset planes,
    each held to its plain version within 1e-4; the wrapper counts the
    launch under its ``tiles``."""
    for n, offset in ((1, False), (5, False), (13, False), (1001, False),
                      (7, True), (1001, True)):
        Zr, Zi = _inverse_planes(n, compact, cuda, 500 + n, offset=offset)
        b = _rand((n,), 78).to(cuda)
        args = (Zr, Zi, b) if tail else (Zr, Zi)
        kw = dict(activation="relu") if tail else {}
        before = dict(wrapper.tiles_launches)
        forms = dict(wrapper.form_launches)
        y = wrapper(*args, delta=16, tiles=tiles, **kw)
        y0 = ref(*args, delta=16, **kw)
        torch.cuda.synchronize()
        before[tiles] += 1
        assert wrapper.tiles_launches == before
        form = GENERIC if offset else SPECIALISED
        forms[form.name] += 1
        assert wrapper.form_launches == forms
        assert (y - y0).abs().max().item() <= 1e-4


def test_inverse_refuses_an_uncompiled_tiles_value(cuda):
    """A number of tiles a block the kernel was not compiled at is
    refused by the wrapper (a ValueError listing the compiled values) and,
    forced past it, by the launch."""
    Zr, Zi = _inverse_planes(8, True, cuda, 6)
    with pytest.raises(ValueError, match=r"\(4, 8, 16\)"):
        tile_irfft_cuda(Zr, Zi, delta=16, tiles=32)
    y = torch.empty((8, 16, 16), device=cuda)
    mats, layout, table = dft_ops._inverse_consts(16, y.device)
    for form in (SPECIALISED, GENERIC):
        with pytest.raises(RuntimeError, match="launch failed"):
            dft_ops._launch("tile_irfft_f32", y.device,
                            *_ptrs(Zr, Zi, y), *mats, *layout, 8, 130, 16,
                            form.code, 12, table)


@pytest.mark.parametrize("delta", [5, 8, 15, 16, 32])
def test_ifft_kernel_matches_plain(cuda, delta):
    dh = delta // 2 + 1
    for n in RECT_TILE_COUNTS:
        zr = _rand((n, delta, dh), 30 + delta).to(cuda)
        zi = _rand((n, delta, dh), 40 + delta).to(cuda)
        before = tile_ifft_cuda.launches
        y = tile_ifft_cuda(zr, zi, delta=delta)
        y0 = tile_ifft_ref(zr, zi, delta)
        torch.cuda.synchronize()
        assert tile_ifft_cuda.launches == before + (n > 0)
        assert y.shape == (n, delta, delta)
        if n:
            assert (y - y0).abs().max().item() <= 1e-4


@pytest.mark.parametrize("delta", [5, 8, 15, 16, 32])
def test_ifft_epilogue_kernel_matches_plain(cuda, delta):
    dh = delta // 2 + 1
    for n in RECT_TILE_COUNTS:
        zr = _rand((n, delta, dh), 50 + delta).to(cuda)
        zi = _rand((n, delta, dh), 60 + delta).to(cuda)
        b = _rand((n,), 70 + delta).to(cuda)
        for activation in ACTIVATIONS:
            before = tile_ifft_epilogue_cuda.launches
            y = tile_ifft_epilogue_cuda(zr, zi, b, activation=activation,
                                        delta=delta)
            y0 = tile_ifft_epilogue_ref(zr, zi, b, activation=activation,
                                        delta=delta)
            torch.cuda.synchronize()
            assert tile_ifft_epilogue_cuda.launches == before + (n > 0)
            assert y.shape == (n, delta, delta)
            if n:
                assert (y - y0).abs().max().item() <= 1e-4


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_rect_path_matches_cudnn(cuda, fused):
    """Vconv3.1 of Table I at batch 2 through the rect stage ops and the
    rect kernels (the forward tile DFT for stages 1 and 2, the CGEMM at
    P = 144, the fused or the plain rect inverse), against cuDNN."""
    torch.backends.cudnn.allow_tf32 = False
    l = next(l for l in TABLE1 if l.name == "Vconv3.1")
    spec = make_spec((2, l.C, l.H, l.W), (l.Cout, l.C, l.kh, l.kw),
                     padding=l.pad)
    x = _rand((2, l.C, l.H, l.W), 13).to(cuda)
    k = (0.05 * _rand((l.Cout, l.C, l.kh, l.kw), 14)).to(cuda)
    b = _rand((l.Cout,), 15).to(cuda)
    ep = Epilogue(bias=True, activation="relu")
    wrappers = (tile_fft_cuda, cgemm_cuda, tile_ifft_epilogue_cuda,
                tile_ifft_cuda)
    before = [w.launches for w in wrappers]
    G = stages.stage_kernel_transform(k, spec, "rect",
                                      tile_fft=tile_fft_cuda)
    D = stages.stage_input_transform(x, spec, "rect", tile_fft=tile_fft_cuda)
    Zr, Zi = stages.stage_cgemm(*D, *G, three_m=True, cgemm_fn=cgemm_cuda)
    assert Zr.shape == (spec.P, spec.M, spec.Cout) and spec.P == 144
    y = stages.stage_output_inverse(
        Zr, Zi, spec, epilogue=ep, bias=b, spectrum="rect",
        **(dict(inverse_fn=_cuda_fused_inverse) if fused
           else dict(tile_ifft=tile_ifft_cuda)))
    assert [w.launches - n for w, n in zip(wrappers, before)] == [
        2, 1, int(fused), int(not fused)]
    y0 = torch.relu(conv2d_direct(x, k, padding=l.pad)
                    + b[None, :, None, None])
    scale = y0.abs().max().item()
    assert (y - y0).abs().max().item() / scale <= 3e-4


def test_fft_cuda_grads_match_cudnn(cuda):
    """dx, dk and d_bias of a fused bias+ReLU fft-cuda plan against the
    same loss on direct (cuDNN, TF32 off); the forward and the dx plan run
    through the tile DFT kernels."""
    torch.backends.cudnn.allow_tf32 = False
    ep = Epilogue(bias=True, activation="relu")
    x, k, bias = (_rand((2, 16, 30, 30), 9).to(cuda),
                  _rand((24, 16, 3, 3), 10).to(cuda),
                  _rand((24,), 11).to(cuda))
    r = _rand((2, 24, 30, 30), 12).to(cuda)
    grads = {}
    for backend in ("fft-cuda", "direct"):
        plan = plan_conv(x.shape, k.shape, padding=1, backend=backend,
                         epilogue=ep)
        ops = [t.clone().requires_grad_() for t in (x, k, bias)]
        launches = (tile_rfft_cuda.launches, tile_irfft_cuda.launches)
        (plan(ops[0], ops[1], bias=ops[2]) * r).sum().backward()
        if backend == "fft-cuda":        # forward x + k, dx plan dz + k
            assert (tile_rfft_cuda.launches - launches[0],
                    tile_irfft_cuda.launches - launches[1]) == (4, 1)
        grads[backend] = [t.grad for t in ops]
    for ours, ref in zip(grads["fft-cuda"], grads["direct"]):
        scale = ref.abs().max().item()
        assert (ours - ref).abs().max().item() / scale <= 3e-4


def test_fft_cuda_plan_matches_cudnn(cuda):
    torch.backends.cudnn.allow_tf32 = False
    x, k, bias = (_rand((2, 16, 30, 30), 4).to(cuda),
                  _rand((24, 16, 3, 3), 5).to(cuda), _rand((24,), 6).to(cuda))
    ep = Epilogue(bias=True, activation="relu")
    plan = plan_conv(x.shape, k.shape, padding=1, backend="fft-cuda",
                     epilogue=ep)
    direct = plan_conv(x.shape, k.shape, padding=1, backend="direct",
                       epilogue=ep)
    launches = (cgemm_cuda.launches, tile_irfft_epilogue_cuda.launches,
                tile_rfft_cuda.launches)
    y = plan.prepare(k)(x, bias=bias)
    assert (cgemm_cuda.launches, tile_irfft_epilogue_cuda.launches,
            tile_rfft_cuda.launches) == (
        launches[0] + 1, launches[1] + 1, launches[2] + 2)
    y0 = direct(x, k, bias=bias)
    scale = y0.abs().max().item()
    assert (y - y0).abs().max().item() / scale <= 3e-4


# --------------------------------------------------------------------------
# Stage 1 in one pass: the forward tile DFT's image form
# --------------------------------------------------------------------------

# (name, (B, C, H, W), kernel, padding, view): every Table-I layer at batch
# 2 (Vconv1.1's C = 3, Aconv2's 5x5 at 27x27); a dx plan's stage 1 (dz at
# the full-correlation padding kh - 1); M*C not a multiple of the 8 tiles
# a block; inputs that are views (channels last, a crop, 4 bytes off)
IMAGE_CASES = (
    [(l.name, (2, l.C, l.H, l.W), l.kh, l.pad, None) for l in TABLE1]
    + [("dx", (2, 128, 56, 56), 3, 2, None),
       ("ragged", (1, 5, 27, 27), 5, 2, None),
       ("last", (2, 64, 28, 28), 3, 1, "last"),
       ("crop", (2, 32, 30, 26), 3, 1, "crop"),
       ("offset", (1, 16, 20, 20), 3, 1, "offset")])


def _image_view(shape, view, seed, device):
    B, C, H, W = shape
    if view == "crop":
        return _rand((B, C, H + 3, W + 5), seed).to(device)[
            :, :, 1:H + 1, 2:W + 2]
    x = _rand(shape, seed).to(device)
    if view == "last":
        return x.to(memory_format=torch.channels_last)
    if view == "offset":
        return torch.empty(x.numel() + 1, device=device)[1:].view(
            shape).copy_(x)
    return x


@pytest.mark.parametrize("name,shape,kh,pad,view", IMAGE_CASES,
                         ids=[c[0] for c in IMAGE_CASES])
def test_image_form_is_bitwise_the_composed_stage_1(cuda, name, shape, kh,
                                                    pad, view):
    """One launch of the image form gives the (P, M, C) spectra of the
    composed stage 1 (pad and tile copy, ``tile_rfft_cuda``, permute) bit
    for bit: the same arithmetic on the same points."""
    x = _image_view(shape, view, sum(shape) + kh, cuda)
    spec = make_spec(tuple(x.shape), (8, shape[1], kh, kh), padding=pad)
    before = (tile_rfft_cuda.launches, dict(tile_rfft_cuda.form_launches))
    Dr, Di = image_rfft_cuda(x, spec)
    torch.cuda.synchronize()
    forms = dict(before[1], image=before[1]["image"] + 1)
    assert (tile_rfft_cuda.launches, tile_rfft_cuda.form_launches) == (
        before[0] + 1, forms)
    Rr, Ri = input_transform(x, spec, spectrum="real",
                             tile_rfft=tile_rfft_cuda)
    assert Dr.shape == Rr.shape == (num_freq_real(16), spec.M, spec.C)
    assert torch.equal(Dr, Rr) and torch.equal(Di, Ri), name


def _stage1_sites(fn, tmp_path):
    """Names of the ``rt:`` spans entered while ``fn`` runs on the card
    under the profiler."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return {e["name"][3:] for e in json.loads(path.read_text())["traceEvents"]
            if e.get("ph") == "X" and e["name"].startswith("rt:")}


def test_image_form_runs_every_stage_1(cuda, tmp_path):
    """A prepared fft-cuda forward launches the image form once (stage 1)
    and the tile form not at all; a training step (forward, then the dx
    plan's stage 1 on dz) twice, and the tile form for the two stage 2s.
    No stage-1 copy site is entered, so nothing launches under one."""
    torch.backends.cudnn.allow_tf32 = False
    ep = Epilogue(bias=True, activation="relu")
    x, k, bias = (_rand((2, 16, 30, 30), 60).to(cuda),
                  _rand((24, 16, 3, 3), 61).to(cuda),
                  _rand((24,), 62).to(cuda))
    plan = plan_conv(x.shape, k.shape, padding=1, backend="fft-cuda",
                     epilogue=ep)
    prepared = plan.prepare(k)
    steps = {
        "forward": lambda: prepared(x, bias=bias),
        "train": lambda: plan(*(t.clone().requires_grad_()
                                for t in (x, k)), bias=bias).sum().backward()}
    for what, fn in steps.items():
        fn()                                   # warm: kernels built
        before = dict(tile_rfft_cuda.form_launches)
        sites = _stage1_sites(fn, tmp_path)
        moved = {f: c - before[f]
                 for f, c in tile_rfft_cuda.form_launches.items()}
        want = ({"generic": 0, "specialised": 0, "image": 1}
                if what == "forward" else
                {"generic": 0, "specialised": 2, "image": 2})
        assert moved == want, what
        assert "stage/input" in sites, what
        assert not sites & {"copy/tiles", "copy/spectra"}, (what, sites)


# --------------------------------------------------------------------------
# The serve engine's CUDA graphs (repro_torch.launch.batcher)
# --------------------------------------------------------------------------

GRAPH_TOL = 1e-5                # scaled by max|y|
GRAPH_EP = Epilogue(bias=True, activation="relu")
GRAPH_WRAPPERS = (cgemm_cuda, tile_rfft_cuda, tile_irfft_epilogue_cuda)


def _graph_layers(batch):
    return [NetworkConv("g1", (batch, 8, 32, 32), (16, 8, 3, 3), padding=1,
                        epilogue=GRAPH_EP),
            NetworkConv("g2", (batch, 16, 32, 32), (16, 16, 3, 3),
                        padding=1, epilogue=GRAPH_EP)]


def _graph_params(cuda, seed=20):
    kernels = {"g1": _rand((16, 8, 3, 3), seed).to(cuda),
               "g2": _rand((16, 16, 3, 3), seed + 1).to(cuda)}
    biases = {"g1": _rand((16,), seed + 2).to(cuda),
              "g2": _rand((16,), seed + 3).to(cuda)}
    return kernels, biases


def _graph_forward(biases):
    def forward(prepared, x):
        for name in prepared:
            x = prepared[name](x, bias=biases[name])
        return x
    return forward


def _graph_engine(cuda, max_batch=4, **kw):
    kernels, biases = _graph_params(cuda)
    eng = ServeEngine(_graph_layers, kernels,
                      policy=BucketPolicy(max_batch=max_batch),
                      forward=_graph_forward(biases), backend="fft-cuda",
                      device=cuda, **kw)
    return eng, kernels, biases


def _eager_rows(eng, kernels, biases, rid, x, version=0):
    """The rows of request ``rid`` (input ``x``) through the eager
    prepared network of the bucket it ran in, at the same row offset."""
    label, _, off = eng.placements[rid]
    bucket = int(label[1:])
    net = plan_network(_graph_layers(bucket), backend="fft-cuda")
    prepared = net.prepare(kernels, weights_version=version)
    xpad = torch.zeros((bucket,) + tuple(x.shape[1:]), device=x.device)
    xpad[off:off + x.shape[0]] = x
    with torch.inference_mode():
        y = _graph_forward(biases)(prepared, xpad)
    return y[off:off + x.shape[0]]


def _assert_rows(y, y0):
    scale = y0.abs().max().item()
    assert (y - y0).abs().max().item() / scale <= GRAPH_TOL


def test_graph_replays_match_the_eager_forward(cuda):
    """Each batch replays its bucket's graph on a new input and gives that
    input's eager output, so the graph recorded the ctypes kernels'
    launches and reads the static input, not what it saw at capture."""
    eng, kernels, biases = _graph_engine(cuda)
    xs = [_rand((b, 8, 32, 32), 30 + i).to(cuda)
          for i, b in enumerate((3, 4, 1, 2, 4, 3))]
    rids = []
    for x in xs:
        rids.append(eng.submit(x))
        eng.drain(force=True)
    for rid, x in zip(rids, xs):
        _assert_rows(eng.results[rid], _eager_rows(eng, kernels, biases,
                                                   rid, x))
    rep = eng.report()
    assert rep["executor"] == "cuda-graph"
    assert sum(map(sum, rep["graph_replays"].values())) == len(xs) == \
        sum(b["n_batches"] for b in rep["buckets"].values())
    assert rep["graph_pool_bytes"] > 0
    assert rep["plan_cache_misses_after_warmup"] == 0


def test_graph_results_do_not_alias(cuda):
    """A request's result is a copy: later replays of the same bucket's
    graph leave it as it was."""
    eng, kernels, biases = _graph_engine(cuda)
    x0 = _rand((4, 8, 32, 32), 40).to(cuda)
    rid0 = eng.submit(x0)
    eng.drain(force=True)
    y0 = eng.results[rid0].clone()
    for i in range(3):
        eng.submit(_rand((4, 8, 32, 32), 41 + i).to(cuda))
        eng.drain(force=True)
    assert torch.equal(eng.results[rid0], y0)
    _assert_rows(eng.results[rid0], _eager_rows(eng, kernels, biases, rid0,
                                                x0))


def test_update_weights_recaptures(cuda):
    eng, kernels, biases = _graph_engine(cuda)
    x = _rand((2, 8, 32, 32), 50).to(cuda)
    rid = eng.submit(x)
    eng.drain(force=True)
    y_old = eng.results[rid]
    new = {n: k * 2.0 + 0.01 for n, k in kernels.items()}
    eng.update_weights(new, weights_version=1)
    rid2 = eng.submit(x)
    eng.drain(force=True)
    _assert_rows(eng.results[rid2],
                 _eager_rows(eng, new, biases, rid2, x, version=1))
    assert not torch.allclose(eng.results[rid2], y_old)
    assert eng.report()["plan_cache_misses_after_warmup"] == 0


def test_two_replicas_on_one_card(cuda):
    eng, kernels, biases = _graph_engine(cuda, max_batch=2, replicas=2)
    xs = [_rand((2, 8, 32, 32), 60 + i).to(cuda) for i in range(6)]
    rids = [eng.submit(x) for x in xs]
    eng.drain(force=True)
    rep = eng.report()
    assert rep["replica_batches"] == [3, 3]
    assert rep["graph_replays"] == {"b2": [3, 3]}
    assert [eng.placements[r][1] for r in rids] == [0, 1, 0, 1, 0, 1]
    for rid, x in zip(rids, xs):
        # each replica owns copies of the kernels: prepare the eager
        # reference from the same values
        _assert_rows(eng.results[rid], _eager_rows(eng, kernels, biases,
                                                   rid, x))


def test_replays_launch_no_kernel(cuda):
    """Launch counters are host-side: they advance at prepare, warm-up and
    capture, and never on a replay."""
    before = [w.launches for w in GRAPH_WRAPPERS]
    eng, _, _ = _graph_engine(cuda, max_batch=2)
    n_buckets, n_layers = 2, 2
    forwards = n_buckets * (WARMUP_PASSES + 1)
    assert [w.launches - b for w, b in zip(GRAPH_WRAPPERS, before)] == [
        forwards * n_layers, (n_buckets + forwards) * n_layers,
        forwards * n_layers]
    before = [w.launches for w in GRAPH_WRAPPERS]
    for i in range(5):
        eng.submit(_rand((1 + i % 2, 8, 32, 32), 70 + i).to(cuda))
        eng.drain(force=True)
    assert [w.launches for w in GRAPH_WRAPPERS] == before
    assert sum(map(sum, eng.report()["graph_replays"].values())) == 5


# --------------------------------------------------------------------------
# The CGEMM tile pin and the measured autotuner
# --------------------------------------------------------------------------

def _served_trunk_specs():
    from repro_torch.launch import serve
    from repro_torch.configs.paper_convs import network_convs
    net = plan_network(network_convs(serve._vgg_scale(224), 4),
                       backend="fft-cuda")
    return [(name, p.spec) for name, p in net.items()]


@pytest.mark.parametrize("shape", range(len(SHAPES)))
def test_every_pinned_row_on_every_vgg_layer(cuda, shape):
    """Each row of the tile table, pinned on the CGEMM shape of each layer
    of the served trunk (224x224, batch 4, P = 130), equals the unpinned
    launch within the CGEMM's tolerance, and ``variant_launches`` names
    the pinned row."""
    for name, spec in _served_trunk_specs():
        ops = _cgemm_operands(130, spec.M, spec.C, spec.Cout,
                              torch.float32, cuda)
        Ur, Ui = cgemm_cuda(*ops)
        want = operand_variant(*ops, shape=shape)
        assert want.code % len(SHAPES) == shape
        before = dict(cgemm_cuda.variant_launches)
        Zr, Zi = cgemm_cuda(*ops, shape=shape)
        torch.cuda.synchronize()
        moved = {k: v - before[k]
                 for k, v in cgemm_cuda.variant_launches.items()
                 if v != before[k]}
        assert moved == {want.name: 1}, (name, moved)
        scale = Ur.abs().max().item() + 1e-9
        for ours, ref in ((Zr, Ur), (Zi, Ui)):
            err = (ours - ref).abs().max().item() / scale
            assert err <= 2e-5, (name, shape, err)


def test_tune_on_the_card_round_trips(cuda, tmp_path, monkeypatch):
    """``tune`` on the card returns a measured winner (CUDA-event
    medians), writes it to its own file, and a reload from that file
    returns the same winner without measuring; a tuned plan takes it."""
    from repro_torch.conv import autotune, autotune_info
    cache = tmp_path / "tune.json"
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(cache))
    monkeypatch.delenv("REPRO_TORCH_AUTOTUNE", raising=False)
    monkeypatch.delenv("REPRO_TORCH_AUTOTUNE_BUDGET_MS", raising=False)
    monkeypatch.delenv("REPRO_TORCH_AUTOTUNE_REPS", raising=False)
    x_shape, k_shape = (4, 64, 56, 56), (64, 64, 3, 3)
    autotune.reset()
    try:
        w = autotune.tune(x_shape, k_shape, padding=1)
        assert w.source == "measured" and w.us_per_call > 0
        assert autotune_info().measured == 1
        raw = cache.read_text()
        assert torch.cuda.get_device_name(cuda) in raw
        autotune.reset()
        assert autotune.tune(x_shape, k_shape, padding=1) == w
        assert tuple(autotune_info()) == (1, 0, 0, 0)
        plan = plan_conv(x_shape, k_shape, padding=1, backend="tuned",
                         cache=False)
        assert (plan.backend, plan.spectrum, plan.bm) == (
            w.backend, w.spectrum, w.bm)
    finally:
        autotune.reset()


# --------------------------------------------------------------------------
# The sharded schedules on a one-rank NCCL mesh
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def nccl_mesh():
    """A (1, 1) mesh on a one-rank NCCL group (NCCL takes one rank per
    GPU), for the module."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from repro_torch.launch import mesh as tmesh
    tmesh.start_process_group("nccl", device_id=torch.device("cuda", 0))
    try:
        yield tmesh.make_mesh((1, 1), ("data", "model"))
    finally:
        tmesh.destroy_process_group()


SHARDED_WRAPPERS = (tile_rfft_cuda, cgemm_cuda, tile_irfft_epilogue_cuda)


@pytest.mark.parametrize("schedule", ["nfft", "wfft"])
@pytest.mark.parametrize("overlap", ["off", "slab:2"])
def test_sharded_fft_cuda_matches_fft_torch_and_local(nccl_mesh, schedule,
                                                      overlap):
    torch.backends.cuda.matmul.allow_tf32 = False
    cuda = torch.device("cuda")
    x, k, bias = (_rand((4, 16, 30, 30), 30).to(cuda),
                  _rand((24, 16, 3, 3), 31).to(cuda),
                  _rand((24,), 32).to(cuda))
    ep = Epilogue(bias=True, activation="relu")
    kw = dict(padding=1, epilogue=ep, mesh=nccl_mesh, schedule=schedule,
              overlap=overlap)
    plan = plan_conv(x.shape, k.shape, backend="fft-cuda", **kw)
    twin = plan_conv(x.shape, k.shape, backend="fft-torch", **kw)
    local = plan_conv(x.shape, k.shape, padding=1, backend="fft-cuda",
                      epilogue=ep)
    slabs = plan.num_slabs
    before = [w.launches for w in SHARDED_WRAPPERS]
    prepared = plan.prepare(k)
    with stages.stage_trace() as trace:
        y = prepared(x, bias=bias).full_tensor()
    torch.cuda.synchronize()
    assert [w.launches - b for w, b in zip(SHARDED_WRAPPERS, before)] == [
        1 + slabs, slabs, slabs]
    kind, other = (("all_to_all", "all_reduce") if schedule == "nfft"
                   else ("all_reduce", "all_to_all"))
    assert trace[("collective", kind)] == (2 if schedule == "nfft"
                                           else 1) * slabs
    assert trace[("collective", other)] == 0
    for y0 in (twin(x, k, bias=bias).full_tensor(),
               local.prepare(k)(x, bias=bias)):
        assert (y - y0).abs().max().item() \
            <= 1e-5 * y0.abs().max().item()


@pytest.mark.parametrize("replicate", [False, True])
def test_sharded_one_shot_on_the_card(nccl_mesh, replicate):
    cuda = torch.device("cuda")
    x, k = _rand((4, 16, 30, 30), 33).to(cuda), \
        _rand((24, 16, 3, 3), 34).to(cuda)
    plan = plan_conv(x.shape, k.shape, padding=1, backend="fft-cuda",
                     mesh=nccl_mesh, schedule="nfft",
                     replicate_kernel_transform=replicate)
    before = [w.launches for w in SHARDED_WRAPPERS]
    with stages.stage_trace() as trace:
        y = plan(x, k).full_tensor()
    torch.cuda.synchronize()
    # no epilogue to fuse: stage 4 is the plain inverse
    assert [w.launches - b for w, b in zip(SHARDED_WRAPPERS, before)] == [
        2, 1, 0]
    assert trace[("collective", "all_to_all")] == 3 - replicate
    assert trace[("collective", "all_reduce")] == 0
    y0 = plan_conv(x.shape, k.shape, padding=1, backend="fft-cuda")(x, k)
    assert (y - y0).abs().max().item() <= 1e-5 * y0.abs().max().item()


@pytest.mark.parametrize("schedule,overlap", [("nfft", "off"),
                                              ("wfft", "slab:2")])
def test_engine_on_a_nccl_mesh_replays_its_graphs(nccl_mesh, schedule,
                                                  overlap):
    """The serving engine on the one-rank NCCL mesh: one CUDA graph per
    bucket, captured over every layer's collectives and the output
    gather, so the collectives are counted at warm-up and capture only;
    replays launch no kernel, count no collective, and give plain tensors
    within ``GRAPH_TOL`` of the eager sharded forward of their bucket.
    On one rank every collective is the identity: the test across cards
    below shows that a replay runs them."""
    cuda = torch.device("cuda")
    kernels, biases = _graph_params(cuda)
    with stages.stage_trace() as trace:
        eng = ServeEngine(_graph_layers, kernels,
                          policy=BucketPolicy(max_batch=4),
                          forward=_graph_forward(biases), backend="fft-cuda",
                          device=cuda, mesh=nccl_mesh, schedule=schedule,
                          overlap=overlap)
    passes = WARMUP_PASSES + 1
    slabs = sum(p.num_slabs for net in eng.nets.values()
                for p in net.plans.values())
    kind, other = (("all_to_all", "all_reduce") if schedule == "nfft"
                   else ("all_reduce", "all_to_all"))
    assert trace[("collective", kind)] == passes * slabs * (
        2 if schedule == "nfft" else 1)
    assert trace[("collective", other)] == 0
    assert trace[("collective", "output_gather")] == passes * len(eng.nets)
    xs = [_rand((b, 8, 32, 32), 80 + i).to(cuda)
          for i, b in enumerate((3, 4, 1, 2))]
    before = [w.launches for w in GRAPH_WRAPPERS]
    with stages.stage_trace() as trace:
        rids = []
        for x in xs:
            rids.append(eng.submit(x))
            eng.drain(force=True)
    assert [w.launches for w in GRAPH_WRAPPERS] == before
    assert not [k for k, n in trace.items()
                if isinstance(k, tuple) and k[0] == "collective" and n]
    for rid, x in zip(rids, xs):
        y = eng.results[rid]
        assert type(y) is torch.Tensor
        label, _, off = eng.placements[rid]
        bucket = int(label[1:])
        prepared = eng.nets[(bucket, None)].prepare(kernels)
        xpad = torch.zeros((bucket,) + tuple(x.shape[1:]), device=cuda)
        xpad[off:off + x.shape[0]] = x
        with torch.inference_mode():
            y0 = _graph_forward(biases)(prepared, xpad).full_tensor()
        _assert_rows(y, y0[off:off + x.shape[0]])
    rep = eng.report()
    assert rep["executor"] == "cuda-graph"
    assert sum(map(sum, rep["graph_replays"].values())) == len(xs)
    assert rep["plan_cache_misses_after_warmup"] == 0
    assert rep["mesh"] == {"data": 1, "model": 1}


# A rank of the engine across cards; BACKEND=gloo rehearses it on host
# ranks (CPU, the eager executor, no profile).
_CARDS_RANK = r'''
import json, os, sys
import torch
sys.path.insert(0, os.environ["TESTS"])
import test_torch_cuda as T
from repro_torch.conv import stages
from repro_torch.launch import mesh as M
from repro_torch.launch.batcher import (
    WARMUP_PASSES, BucketPolicy, ServeEngine)

rank, world = int(os.environ["RANK"]), int(os.environ["WORLD"])
host = os.environ["BACKEND"] == "gloo"
dev = torch.device("cpu") if host else torch.device("cuda", rank)
if not host:
    torch.cuda.set_device(dev)
M.start_process_group(os.environ["BACKEND"], rank=rank, world_size=world,
                      store_path=os.environ["STORE"],
                      device_id=None if host else dev)
passes = 1 if host else WARMUP_PASSES + 1    # eager warm-up, or + capture
kernels, biases = T._graph_params(dev)
xs = [T._rand((b, 8, 32, 32), 80 + i).to(dev)
      for i, b in enumerate((3, 4, 1, 2))]


def serve(**kw):
    with stages.stage_trace() as at_start:
        eng = ServeEngine(T._graph_layers, kernels,
                          policy=BucketPolicy(max_batch=4),
                          forward=T._graph_forward(biases),
                          backend="fft-cuda", device=dev, **kw)
    ys = []
    with stages.stage_trace() as serving:
        for x in xs:
            rid = eng.submit(x)
            eng.drain(force=True)
            ys.append(eng.results[rid])
    return eng, ys, at_start, serving


def collectives(trace):
    return {k[1]: n for k, n in trace.items()
            if isinstance(k, tuple) and k[0] == "collective" and n}


def nccl_kernels(fn):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events()
               if "nccl" in e.name.lower() and not e.is_user_annotation)


_, local, _, _ = serve()
out = {}
for shape in json.loads(os.environ["SHAPES"]):
    mesh = (M.make_host_mesh(*shape) if host else
            M.make_mesh(shape, ("data", "model")))
    for schedule, overlap in (("nfft", "off"), ("wfft", "off"),
                              ("wfft", "slab:2")):
        eng, ys, at_start, serving = serve(
            mesh=mesh, schedule=schedule, overlap=overlap)
        slabs = sum(p.num_slabs for net in eng.nets.values()
                    for p in net.plans.values())
        rep = eng.report()
        out[f"{shape} {schedule} {overlap}"] = dict(
            plain=all(type(y) is torch.Tensor for y in ys),
            err=max(((y - y0).abs().max() / y0.abs().max()).item()
                    for y, y0 in zip(ys, local)),
            at_start=collectives(at_start),
            want_at_start={
                ("all_to_all" if schedule == "nfft" else "all_reduce"):
                passes * slabs * (2 if schedule == "nfft" else 1),
                "output_gather": passes * len(eng.nets)},
            serving=collectives(serving),
            replays=sum(map(sum, rep["graph_replays"].values())),
            replay_nccl_kernels=None if host else nccl_kernels(
                eng._executor((4, None), 0).graph.replay))
        del eng
with open(os.path.join(os.environ["OUT"], f"out{rank}.json"), "w") as fh:
    json.dump(out, fh)
M.destroy_process_group()
'''


def _cards_world(tmp, backend, world):
    """Run ``_CARDS_RANK`` on ``world`` spawned ranks; every rank's
    output, by rank.  The meshes have a model dim of 2 or more, so that
    nfft's all-to-alls and wfft's all-reduces cross ranks."""
    shapes = [(1, world)] + ([(2, world // 2)] if world >= 4 else [])
    base = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                TESTS=os.path.dirname(os.path.abspath(__file__)),
                OUT=str(tmp), STORE=str(tmp / "store"),
                SHAPES=json.dumps(shapes), BACKEND=backend,
                WORLD=str(world), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _CARDS_RANK], env=dict(base, RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    try:
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    failed = [log[-3000:] for p, log in zip(procs, logs) if p.returncode]
    assert not failed, "\n\n".join(failed)
    return [json.loads((tmp / f"out{r}.json").read_text())
            for r in range(world)]


def test_engine_across_cards_replays_its_collectives(tmp_path):
    """The serving engine on a mesh of two or four cards (NCCL), nfft
    ``off``, wfft ``off`` and ``slab:2``: collectives counted at warm-up
    and capture only; each replay of the batch-4 graph runs NCCL
    kernels; every rank's plain results within ``GRAPH_TOL`` of a local
    engine's.  A graph that lost a collective would give other rows:
    on one rank, where every collective is the identity, it could not
    show."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 2:
        pytest.skip("needs two or more NVIDIA GPUs: NCCL takes one rank "
                    "per card")
    from repro_torch.kernels import _build
    _build.build()                      # once, before the ranks load it
    world = 4 if n >= 4 else 2
    ranks = _cards_world(tmp_path, "nccl", world)
    for r, out in enumerate(ranks):
        for config, got in out.items():
            what = f"rank {r} {config}"
            print(what, json.dumps(got))
            assert got["plain"], what
            assert got["err"] <= GRAPH_TOL, what
            assert got["at_start"] == got["want_at_start"], what
            assert got["serving"] == {}, what
            assert got["replays"] == 4, what
            assert got["replay_nccl_kernels"] > 0, what
    assert all(sorted(out) == sorted(ranks[0]) for out in ranks)
    assert len(ranks[0]) == 3 * (1 + (world >= 4))

