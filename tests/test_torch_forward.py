"""The forward tile DFT's two kernel forms, on the CPU: the form chooser,
the host table the specialised form takes by value, and the specialised
form's arithmetic written out in numpy, held to the plain versions and to
the JAX package's Pallas kernels in interpret mode.

The kernel itself runs only on the card (``tests/test_torch_cuda.py``).
Here its algorithm is mirrored step by step (rows of B, the packed real
column, the (u, 16 - u) pairs, the compile-time compact index), so that a
fault in the decomposition shows on the CPU.  Tolerance: scaled atol 2e-5,
the forward kernels' tolerance on the card (float32 sums over 16 terms in
another order than the plain version's matmuls).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

import jax.numpy as jnp

from repro.core import dft as jdft
from repro.kernels.dft_tile import tile_fft_pallas, tile_rfft_pallas
from repro_torch.core.dft import compact_layout, dft_mats, num_freq_real
from repro_torch.kernels.dft_tile import ops, tile_fft_ref, tile_rfft_ref

TOL = 2e-5
D = 16


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("delta", range(1, 33))
def test_choose_form(delta):
    """Specialised only at delta 16 on a 16-byte-aligned pointer; generic
    everywhere else, a 4-, 8- or 12-byte offset included."""
    for ptr in (0, 16, 0x7F0000001000, 0x7F0000001230):
        want = ops.SPECIALISED if delta == 16 else ops.GENERIC
        assert ops.choose_form(delta, ptr) == want
    for ptr in (4, 8, 12, 0x7F0000001004, 0x7F000000100C):
        assert ops.choose_form(delta, ptr) == ops.GENERIC
    assert ops.SPECIALISED.code != ops.GENERIC.code


@pytest.mark.parametrize("delta", [5, 8, 15, 16, 32])
def test_forward_tables_are_dft_mats(delta):
    """The host table is F_half real and imaginary, bit for bit the values
    of dft_mats (and of the JAX package's tables); F_half is F's first
    delta//2 + 1 rows, so stage 2 reads F from the same table."""
    dh = delta // 2 + 1
    t = ops.forward_tables(delta)
    assert t.dtype == np.float32 and t.shape == (2, dh, delta)
    assert t.flags["C_CONTIGUOUS"]
    Fr, Fi, Fhr, Fhi, *_ = dft_mats(delta)
    jFr, jFi, jFhr, jFhi, *_ = jdft._dft_mats_np(delta)
    for got, *want in ((t[0], Fhr.numpy(), jFhr, Fr.numpy()[:dh], jFr[:dh]),
                       (t[1], Fhi.numpy(), jFhi, Fi.numpy()[:dh], jFi[:dh])):
        for w in want:
            assert np.array_equal(got, w)
    assert ops.forward_tables(delta) is t          # cached


def _compact16(u, v):
    """csrc/dft_tile.cu:compact16, the compile-time compact index."""
    return u * 9 + v if u <= 8 else 81 + (u - 9) * 7 + (v - 1)


def test_compact16_index_is_the_store_map():
    store = compact_layout(D)[0].numpy()
    for p, r in enumerate(store):
        assert _compact16(r // 9, r % 9) == p


def specialised_forward(x, tables, gather):
    """The specialised kernel's arithmetic in float32: tiles (n, 16, 16)
    -> two (n, 130) planes (``gather``) or two (n, 16, 9) planes."""
    re, im = tables[0], tables[1]                 # F_half = F[0:9]
    n = x.shape[0]
    f32 = np.float32
    # stage 1, by rows: B[h][v] real for v = 0..8, imaginary for v = 1..7
    br = np.einsum("nhw,vw->nhv", x, re, dtype=f32)
    bi = np.einsum("nhw,vw->nhv", x, im, dtype=f32)
    # the transpose: 8 complex columns, column 0 packs B[:,0] + i B[:,8]
    zr = np.concatenate([br[:, :, :1], br[:, :, 1:8]], axis=2)   # (n, h, c)
    zi = np.concatenate([br[:, :, 8:9], bi[:, :, 1:8]], axis=2)
    P = num_freq_real(D) if gather else D * 9
    outr = np.zeros((n, P), f32)
    outi = np.zeros((n, P), f32)

    def put(u, v, a, b):
        p = _compact16(u, v) if gather else u * 9 + v
        outr[:, p], outi[:, p] = a, b

    # stage 2, by columns: unit U gives Z[U] and Z[16 - U] from 4 sums
    for U in (0, 8, 1, 2, 3, 4, 5, 6, 7):
        single = U in (0, 8)
        a = re[U]
        b = np.zeros_like(a) if single else im[U]
        s1 = np.einsum("h,nhc->nc", a, zr, dtype=f32)
        s3 = np.einsum("h,nhc->nc", a, zi, dtype=f32)
        s2 = np.einsum("h,nhc->nc", b, zi, dtype=f32)
        s4 = np.einsum("h,nhc->nc", b, zr, dtype=f32)
        mirror = (D - U) % D
        # column 0: the two real columns' transforms, from the same sums
        put(U, 0, s1[:, 0], s4[:, 0])
        put(U, 8, s3[:, 0], s2[:, 0])
        if not gather and not single:
            put(mirror, 0, s1[:, 0], -s4[:, 0])
            put(mirror, 8, s3[:, 0], -s2[:, 0])
        for c in range(1, 8):
            put(U, c, s1[:, c] - s2[:, c], s3[:, c] + s4[:, c])
            if not single:
                put(mirror, c, s1[:, c] + s2[:, c], s3[:, c] - s4[:, c])
    if gather:
        return outr, outi
    return outr.reshape(n, D, 9), outi.reshape(n, D, 9)


def _scaled_err(ours, ref):
    ref = [np.asarray(r) for r in ref]
    scale = max(np.abs(r).max() for r in ref)
    return max(np.abs(o - r).max() for o, r in zip(ours, ref)) / scale


@pytest.mark.parametrize("gather", [True, False], ids=["compact", "rect"])
@pytest.mark.parametrize("n", [1, 7, 300])
def test_specialised_arithmetic_matches_plain_and_pallas(gather, n):
    x = _rand((n, D, D), 500 + n)
    ours = specialised_forward(x, ops.forward_tables(D), gather)
    plain = (tile_rfft_ref if gather else tile_fft_ref)(torch.from_numpy(x),
                                                        D)
    pallas = (tile_rfft_pallas if gather else tile_fft_pallas)(
        jnp.asarray(x), delta=D)
    assert ours[0].shape == tuple(plain[0].shape)
    assert _scaled_err(ours, [t.numpy() for t in plain]) <= TOL
    assert _scaled_err(ours, pallas) <= TOL


def test_specialised_arithmetic_on_structured_tiles():
    """Tiles whose spectrum sits in one column or one row (a constant, a
    +-1 checkerboard, single points), where a swapped column 0/8 or a
    wrong mirror row would show at full size."""
    x = np.zeros((6, D, D), np.float32)
    x[0] = 1.0
    x[1] = np.where((np.add.outer(np.arange(D), np.arange(D)) % 2) == 0,
                    1.0, -1.0)
    x[2, 3, 5] = 1.0
    x[3, 0, 8] = 2.0
    x[4, :, 0] = np.arange(D)
    x[5, 7, :] = np.arange(D)[::-1]
    for gather, ref in ((True, tile_rfft_ref), (False, tile_fft_ref)):
        ours = specialised_forward(x, ops.forward_tables(D), gather)
        plain = [t.numpy() for t in ref(torch.from_numpy(x), D)]
        assert _scaled_err(ours, plain) <= TOL


def test_specialised_real_columns_keep_their_own_accuracy():
    """Tiles whose rows carry large offsets that vary down the tile (as
    ReLU outputs with smooth structure do): the DC column is far larger
    than the Nyquist column at u != 0, and each must be as accurate, next
    to a float64 rfft2, as the plain version's, column by column.
    (Unpacking both from one complex transform would give the Nyquist
    column an error of the DC column's size.)"""
    rows = 50.0 + 50.0 * np.cos(2 * np.pi * np.arange(D) / D)
    x = (rows[None, :, None] + _rand((200, D, D), 7)).astype(np.float32)
    exact = np.fft.rfft2(x.astype(np.float64))
    ours = specialised_forward(x, ops.forward_tables(D), False)
    plain = [t.numpy() for t in tile_fft_ref(torch.from_numpy(x), D)]
    for v in (0, 8):
        def col_err(planes):
            return np.abs(planes[0][..., v] + 1j * planes[1][..., v]
                          - exact[..., v]).max()
        assert col_err(ours) <= 2 * col_err(plain) + 1e-12, v
