"""The inverse tile DFT's two kernel forms, on the CPU: the form chooser,
the host table the specialised form takes by value, and the specialised
form's arithmetic written out in numpy, held to the plain versions and to
the JAX package's Pallas kernels in interpret mode.

The kernel itself runs only on the card (``tests/test_torch_cuda.py``).
Here its algorithm is mirrored step by step: the compile-time compact
scatter (rows 9-15 of columns 0 and 8 read through their mirror row), the
lane that holds columns 0 and 8 together, the (h, 16 - h) pairs of stage
A, the (w, 16 - w) pairs of stage B and the tail, so that a fault in the
decomposition shows on the CPU.  Tolerance: scaled atol 2e-5 (max error
over max |plain|), the forward kernels' tolerance and 5x tighter than the
card's ``INVERSE_TOL`` (float32 sums over 16 terms in another order than
the plain version's matmuls, and table entries below 3.4e-16 dropped).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

import jax.numpy as jnp

from repro.core import dft as jdft
from repro.kernels.dft_tile import (
    tile_ifft_epilogue_pallas, tile_ifft_pallas, tile_irfft_epilogue_pallas,
    tile_irfft_pallas)
from repro_torch.core.dft import compact_layout, dft_mats, num_freq_real
from repro_torch.kernels.dft_tile import (
    ops, tile_ifft_epilogue_ref, tile_ifft_ref, tile_irfft_epilogue_ref,
    tile_irfft_ref)

TOL = 2e-5
D, DH = 16, 9
P_COMPACT = 130
f32 = np.float32

# form -> (compact layout, fused tail)
FORMS = {"irfft": (True, False), "irfft_epilogue": (True, True),
         "ifft": (False, False), "ifft_epilogue": (False, True)}


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(f32)


@pytest.mark.parametrize("delta", range(1, 33))
def test_choose_inverse_form(delta):
    """Specialised only at delta 16, with every pointer 16-byte aligned
    and an even row stride (130 and 136 compact, 144 rect); generic
    everywhere else."""
    want = ops.SPECIALISED if delta == 16 else ops.GENERIC
    for ld in (130, 136, 144):
        for ptrs in ((0, 16, 32), (0x7F0000001000, 0x7F0000001230, 0x10)):
            assert ops.choose_inverse_form(delta, ptrs, ld) == want
        for bad in (4, 8, 12):            # any one pointer off 16 bytes
            for k in range(3):
                ptrs = [0x7F0000001000] * 3
                ptrs[k] += bad
                assert ops.choose_inverse_form(delta, ptrs,
                                               ld) == ops.GENERIC
    for ld in (131, 137):                 # an odd row stride
        assert ops.choose_inverse_form(delta, (0, 16, 32),
                                       ld) == ops.GENERIC


@pytest.mark.parametrize("delta", [5, 8, 15, 16, 32])
def test_inverse_tables_are_dft_mats(delta):
    """The host table is Finv's and W's rows 0..delta//2, real then
    imaginary, bit for bit the values of dft_mats (and of the JAX
    package's tables)."""
    dh = delta // 2 + 1
    t = ops.inverse_tables(delta)
    assert t.dtype == np.float32 and t.ndim == 1
    assert t.size == 2 * dh * delta + 2 * dh * dh
    *_, Fvr, Fvi, Wr, Wi = dft_mats(delta)
    *_, jFvr, jFvi, jWr, jWi = jdft._dft_mats_np(delta)
    at = 0
    for mats in ((Fvr, jFvr), (Fvi, jFvi), (Wr, jWr), (Wi, jWi)):
        part = mats[1][:dh]
        got = t[at:at + part.size].reshape(part.shape)
        at += part.size
        assert np.array_equal(got, mats[0].numpy()[:dh])
        assert np.array_equal(got, part)
    assert at == t.size
    assert ops.inverse_tables(delta) is t          # cached


def _tables16():
    """The specialised form's struct InvTables16, from the host table."""
    t = ops.inverse_tables(D)
    fr, fi = t[:144].reshape(DH, D), t[144:288].reshape(DH, D)
    wr, wi = t[288:369].reshape(DH, DH), t[369:].reshape(DH, DH)
    return fr, fi, wr, wi


def test_table_facts_the_design_leans_on():
    """Finv[16-h] = conj(Finv[h]) and W[16-w] = conj(W[w]) (so rows 0-8
    suffice); Finv[0] and W's column 0 and row 0 are real, and the
    imaginary parts the kernel drops (Finv[8], W's column 8 and row 8)
    are below 3.4e-16."""
    *_, Fvr, Fvi, Wr, Wi = (m.numpy().astype(np.float64)
                            for m in dft_mats(D))
    for h in range(1, 8):
        assert np.abs(Fvr[D - h] - Fvr[h]).max() <= 1e-15
        assert np.abs(Fvi[D - h] + Fvi[h]).max() <= 1e-15
        assert np.abs(Wr[D - h] - Wr[h]).max() <= 1e-15
        assert np.abs(Wi[D - h] + Wi[h]).max() <= 1e-15
    assert not Fvi[0].any() and not Wi[:, 0].any() and not Wi[0].any()
    assert np.abs(Fvi[8]).max() <= 3.4e-16
    assert np.abs(Wi[:, 8]).max() <= 3.4e-16
    assert np.abs(Wi[8]).max() <= 3.4e-16


def _compact_point(u, v):
    """Where the specialised kernel reads rect point (u, v) in a compact
    row, and the sign of its imaginary part: csrc/dft_tile.cu:compact16
    for a stored point, row 16 - u negated for rows 9-15 of columns 0
    and 8."""
    if u <= 8:
        return u * DH + v, 1.0
    if v in (0, 8):
        return (D - u) * DH + v, -1.0
    return 81 + (u - 9) * 7 + (v - 1), 1.0


def test_compact_scatter_is_the_layout_map():
    """The compile-time scatter reads every rect point where the compact
    layout's src/sgn tables say."""
    _, src, sgn = (t.numpy() for t in compact_layout(D))
    for u in range(D):
        for v in range(DH):
            r = u * DH + v
            assert _compact_point(u, v) == (src[r], sgn[r]), (u, v)


_ACT = {"none": lambda y: y, "relu": lambda y: np.maximum(y, f32(0)),
        "gelu": lambda y: f32(0.5) * y * (f32(1) + np.tanh(
            f32(0.7978845608028654) * (y + f32(0.044715) * y * y * y))),
        "silu": lambda y: y / (f32(1) + np.exp(-y))}


def specialised_inverse(zr, zi, compact, bias=None, activation="none"):
    """The specialised kernel's arithmetic in float32: planes (n, ld >=
    130) compact or (n, 144) rect -> tiles (n, 16, 16), with the tail
    when ``bias`` is given."""
    fr, fi, wr, wi = _tables16()
    n = zr.shape[0]

    def point(u, v):
        p, s = _compact_point(u, v) if compact else (u * DH + v, 1.0)
        return zr[:, p], f32(s) * zi[:, p]

    # stage A's operands, per lane c: column c as (a, b) = (Re, Im) and
    # (c, d) = (Im, Re); lane 0 holds column 0 and column 8 as (Re, -Im)
    a, b, c, d = (np.empty((n, 8, D), f32) for _ in range(4))
    for col in range(8):
        for u in range(D):
            re, im = point(u, col)
            a[:, col, u], b[:, col, u] = re, im
            if col == 0:
                re8, im8 = point(u, 8)
                c[:, col, u], d[:, col, u] = re8, -im8
            else:
                c[:, col, u], d[:, col, u] = im, re
    # stage A, by columns: unit H gives Y[H] and Y[16 - H] from 4 sums;
    # row h of Y packs (Re Y[h][0], Re Y[h][8]) then (Re, Im) Y[h][1..7]
    Y = np.empty((n, D, D), f32)
    for H in (0, 8, 1, 2, 3, 4, 5, 6, 7):
        s1 = np.einsum("u,ncu->nc", fr[H], a, dtype=f32)
        s3 = np.einsum("u,ncu->nc", fr[H], c, dtype=f32)
        if H in (0, 8):
            Y[:, H, 0::2], Y[:, H, 1::2] = s1, s3
            continue
        s2 = np.einsum("u,ncu->nc", fi[H], b, dtype=f32)
        s4 = np.einsum("u,ncu->nc", fi[H], d, dtype=f32)
        Y[:, H, 0::2], Y[:, H, 1::2] = s1 - s2, s3 + s4
        Y[:, D - H, 0::2], Y[:, D - H, 1::2] = s1 + s2, s3 - s4
    # stage B, by rows: the pair (w, 16 - w) from two sums
    yr = np.concatenate([Y[..., :1], Y[..., 2::2], Y[..., 1:2]], axis=2)
    yi = Y[..., 3::2]                                    # v = 1..7
    out = np.empty((n, D, D), f32)
    for w in range(DH):
        p1 = np.einsum("v,nhv->nh", wr[w], yr, dtype=f32)
        if w in (0, 8):
            out[..., w] = p1
            continue
        p2 = np.einsum("v,nhv->nh", wi[w, 1:8], yi, dtype=f32)
        out[..., w], out[..., D - w] = p1 - p2, p1 + p2
    if bias is not None:
        out = _ACT[activation](out + bias[:, None, None])
    return out


def _plain_and_pallas(form, zr, zi, bias, activation):
    """The form's plain version (on the first 130 points of a compact
    row) and its Pallas kernel in interpret mode."""
    compact, tail = FORMS[form]
    n = zr.shape[0]
    if compact:
        t = (torch.from_numpy(zr[:, :P_COMPACT].copy()),
             torch.from_numpy(zi[:, :P_COMPACT].copy()))
        j = (jnp.asarray(zr), jnp.asarray(zi))
    else:
        t = (torch.from_numpy(zr.reshape(n, D, DH)),
             torch.from_numpy(zi.reshape(n, D, DH)))
        j = (jnp.asarray(zr.reshape(n, D, DH)),
             jnp.asarray(zi.reshape(n, D, DH)))
    if tail:
        plain = (tile_irfft_epilogue_ref if compact
                 else tile_ifft_epilogue_ref)(*t, torch.from_numpy(bias),
                                              activation=activation, delta=D)
        pallas = (tile_irfft_epilogue_pallas if compact
                  else tile_ifft_epilogue_pallas)(
            *j, jnp.asarray(bias), activation=activation, delta=D)
    else:
        plain = (tile_irfft_ref if compact else tile_ifft_ref)(*t, D)
        pallas = (tile_irfft_pallas if compact else tile_ifft_pallas)(
            *j, delta=D)
    return plain.numpy(), np.asarray(pallas)


def _check(form, zr, zi, activation="none", seed=0):
    compact, tail = FORMS[form]
    bias = _rand((zr.shape[0],), seed + 1) if tail else None
    ours = specialised_inverse(zr, zi, compact, bias, activation)
    plain, pallas = _plain_and_pallas(form, zr, zi, bias, activation)
    assert ours.shape == plain.shape == pallas.shape
    scale = np.abs(plain).max()
    assert np.abs(ours - plain).max() / scale <= TOL
    assert np.abs(ours - pallas).max() / scale <= TOL


def _hermitian_planes(n, compact, seed):
    """The spectra of real tiles: rfft2, compact-packed or rect."""
    Z = np.fft.rfft2(_rand((n, D, D), seed).astype(np.float64))
    Z = Z.reshape(n, D * DH)
    if compact:
        Z = Z[:, compact_layout(D)[0].numpy()]
    return Z.real.astype(f32), Z.imag.astype(f32)


@pytest.mark.parametrize("kind", ["random", "hermitian"])
@pytest.mark.parametrize("n", [1, 7, 300])
@pytest.mark.parametrize("form", list(FORMS))
def test_specialised_arithmetic_matches_plain_and_pallas(form, n, kind):
    compact = FORMS[form][0]
    P = P_COMPACT if compact else D * DH
    seed = 600 + 10 * n + len(form)
    if kind == "random":
        zr, zi = _rand((n, P), seed), _rand((n, P), seed + 5)
    else:
        zr, zi = _hermitian_planes(n, compact, seed)
    _check(form, zr, zi, seed=seed)


@pytest.mark.parametrize("activation", ["none", "relu", "gelu", "silu"])
@pytest.mark.parametrize("form", ["irfft_epilogue", "ifft_epilogue"])
def test_specialised_tail_under_every_activation(form, activation):
    P = P_COMPACT if FORMS[form][0] else D * DH
    zr, zi = _rand((7, P), 31), _rand((7, P), 32)
    _check(form, zr, zi, activation, seed=33)


@pytest.mark.parametrize("form", list(FORMS))
def test_specialised_arithmetic_on_impulses(form):
    """One tile per stored point and per plane, holding 1 there: columns
    0 and 8 (the shared lane), rows 9-15 (the compact mirror) and every
    other point, where a swapped column, a wrong mirror row or a wrong
    sign shows at full size."""
    P = P_COMPACT if FORMS[form][0] else D * DH
    zr, zi = np.zeros((2 * P, P), f32), np.zeros((2 * P, P), f32)
    zr[np.arange(P), np.arange(P)] = 1.0
    zi[P + np.arange(P), np.arange(P)] = 1.0
    _check(form, zr, zi, seed=40)


@pytest.mark.parametrize("form", ["irfft", "irfft_epilogue"])
def test_specialised_arithmetic_reads_no_trailing_point(form):
    """Compact rows of stride 136 with NaN past point 130, as the card's
    smoke check passes them: none of them is read."""
    zr, zi = _rand((7, 136), 50), _rand((7, 136), 51)
    zr[:, P_COMPACT:] = zi[:, P_COMPACT:] = np.nan
    assert num_freq_real(D) == P_COMPACT
    _check(form, zr, zi, seed=52)
