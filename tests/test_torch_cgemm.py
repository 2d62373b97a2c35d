"""The CGEMM's variant chooser, and its wrapper on the CPU.

``choose_variant`` is pure Python, so the kernel form it gives every
Table-I layer is held here: for the forward plan and the dx plan (C and N
swapped) of all 17 layers, at P = 130 (compact spectrum) and 144 (rect),
batch 4, 32 and 128, in float32 and bfloat16:

- the small-M form iff M <= 32, with a row tile that covers all of M;
- the masked scalar-load form iff a row of D or G is not a multiple of 16
  bytes (C = 3 at Vconv1.1) or an operand pointer is not 16-byte aligned;
- a launch the card takes: dynamic shared memory <= 232,448 bytes, at
  most 1024 threads, grid.y and grid.z <= 65535.

A pinned tile row (``shape=``, ``shape_for_blocks``) runs any M and keeps
the load form the operands allow.

On the CPU the wrapper runs the plain version whatever the variant would
be, pinned or not, counts no launch, and agrees with the JAX package's Pallas CGEMM
(interpret mode) at the card tests' ragged and offset shapes: scaled atol
2e-5 in float32.  tests/test_torch_cuda.py holds the kernel itself, every
variant, to the plain version on the card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

import jax.numpy as jnp

from repro.kernels.cgemm import cgemm_pallas
from repro_torch.configs.paper_convs import TABLE1
from repro_torch.conv import plan_conv
from repro_torch.conv.autodiff import _transposed_plan
from repro_torch.kernels.cgemm import (
    cgemm_cuda, cgemm_ref, choose_variant, operand_variant)
from repro_torch.kernels.cgemm.ops import (
    LARGE, SHAPES, shape_for_blocks, shape_smem_bytes, variant_name)

SMEM_MAX = 232_448                      # bytes a block may use on an H100
DTYPES = [torch.float32, torch.bfloat16]


def _specs(layer, plan, batch):
    fwd = plan_conv((batch, layer.C, layer.H, layer.W),
                    (layer.Cout, layer.C, layer.kh, layer.kw),
                    padding=layer.pad, backend="fft-cuda")
    return (fwd if plan == "forward" else _transposed_plan(fwd)).spec


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("plan", ["forward", "dx"])
@pytest.mark.parametrize("layer", TABLE1, ids=[l.name for l in TABLE1])
def test_choose_variant_on_table1(layer, plan, dtype):
    size = torch.tensor([], dtype=dtype).element_size()
    for batch in (4, 32, 128):
        spec = _specs(layer, plan, batch)
        M, C, N = spec.M, spec.C, spec.Cout
        if plan == "dx":
            assert (C, N) == (layer.Cout, layer.C)
        for P in (130, 144):
            v = choose_variant(P, M, C, N, dtype)
            assert (v.form == "small") == (M <= 32), (batch, P, v)
            if v.form == "small":
                assert v.bm >= M and v.grid[1] == 1   # G read once
            assert v.scalar == ((C * size) % 16 != 0
                                or (N * size) % 16 != 0), (C, N, v)
            assert v.smem_bytes <= SMEM_MAX and v.threads <= 1024
            assert v.grid == (-(-N // v.bn), -(-M // v.bm), P)
            assert v.grid[1] <= 65535 and v.grid[2] <= 65535
            shape = SHAPES[v.code % len(SHAPES)]
            assert (shape[0], shape[1], shape[2], shape[5]) == (
                v.bm, v.bn, v.bk, v.stages)
            assert v.code // len(SHAPES) == int(v.scalar)
            # a pointer off 16 bytes takes the scalar form of the same tile
            u = choose_variant(P, M, C, N, dtype, aligned=False)
            assert u.scalar and (u.form, u.bm, u.bn) == (v.form, v.bm, v.bn)


def test_choose_variant_on_the_served_trunk():
    """The nine layers of the served VGG trunk (224x224, batch 4, P = 130):
    only Vconv1.1 (C = 3) takes scalar loads; the large tile wastes no row
    at M = 64 and no column at N = 64; Vconv5 computes 4 rows, not 16."""
    want = {"Vconv1.1": "large-64x64-scalar", "Vconv1.2": "large-64x64",
            "Vconv2.1": "large-64x64", "Vconv2.2": "large-64x64",
            "Vconv3.1": "large-64x64", "Vconv3.2": "large-64x64",
            "Vconv4.1": "small-16x128", "Vconv4.2": "small-16x128",
            "Vconv5": "small-4x128"}
    for layer in TABLE1:
        if layer.name in want:
            spec = _specs(layer, "forward", 4)
            for dtype in DTYPES:
                v = choose_variant(130, spec.M, spec.C, spec.Cout, dtype)
                assert v.name == want[layer.name], (layer.name, dtype)


@pytest.mark.parametrize("M,bm", [(1, 4), (4, 4), (5, 8), (8, 8), (9, 16),
                                  (16, 16), (17, 32), (32, 32)])
def test_small_form_takes_the_least_tile_that_covers_m(M, bm):
    v = choose_variant(130, M, 512, 512, torch.float32)
    assert (v.form, v.bm, v.grid[1]) == ("small", bm, 1)


@pytest.mark.parametrize("M,N", [(33, 64), (64, 256), (65, 128), (129, 64),
                                 (1024, 64), (2048, 512), (190, 3)])
def test_large_form_above_the_cut(M, N):
    v = choose_variant(130, M, 64, N, torch.float32)
    assert (v.form, v.bm, v.bn, v.threads) == ("large", 64, 64, 128)
    assert v.grid == (-(-N // 64), -(-M // 64), 130)


def test_shared_memory_of_each_shape():
    """The ring of raw D (rows padded by 16 bytes) and G slices, D
    K-major in float32, bf16 G widened; the card test holds this table
    to the compiled kernel's."""
    # 64x64, BK 16, 3 slots, float32: 3 * 2 * (64 * 20 + 16 * 64) * 4
    # + 2 * 16 * 64 * 4
    assert shape_smem_bytes(0, 4) == 55296 + 8192
    # bfloat16 adds the widened G planes: 3 * 2 * (64 * 24 + 16 * 64) * 2
    # + 4 * (2 * 16 * 64 + 2 * 16 * 64)
    assert shape_smem_bytes(0, 2) == 30720 + 16384
    for i in range(len(SHAPES)):
        for size in (2, 4):
            assert shape_smem_bytes(i, size) <= SMEM_MAX


def test_choose_variant_refuses_other_dtypes():
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        choose_variant(130, 16, 64, 64, torch.float64)


def _offset(a, dtype, offset):
    """A contiguous tensor holding ``a`` whose data pointer lies one
    element past an allocation, as a 4-byte-offset view does."""
    t = torch.from_numpy(a).to(dtype)
    if not offset:
        return t
    u = torch.empty(t.numel() + 1, dtype=dtype)[1:].view(t.shape)
    return u.copy_(t)


# the card tests' ragged shapes, and an offset view on each
RAGGED = [(3, 1, 1, 1), (2, 15, 17, 65), (2, 17, 5, 3), (1, 33, 513, 64),
          (2, 65, 3, 1), (3, 4, 64, 512)]


@pytest.mark.parametrize("offset", [False, True], ids=["aligned", "offset"])
@pytest.mark.parametrize("P,M,C,N", RAGGED)
def test_cpu_wrapper_runs_the_plain_version(P, M, C, N, offset):
    rng = np.random.default_rng(P * 7 + M + C + N)
    ops = [rng.standard_normal(s).astype(np.float32)
           for s in ((P, M, C), (P, M, C), (P, C, N), (P, C, N))]
    ts = [_offset(a, torch.float32, offset) for a in ops]
    assert (ts[0].data_ptr() % 16 != 0) == offset
    v = operand_variant(*ts)
    assert v.scalar == (offset or (C * 4) % 16 != 0 or (N * 4) % 16 != 0)
    before = cgemm_cuda.launches
    Zr, Zi = cgemm_cuda(*ts, three_m=True)
    assert cgemm_cuda.launches == before          # CPU: no launch
    Rr, Ri = cgemm_ref(*ts, three_m=True)
    assert torch.equal(Zr, Rr) and torch.equal(Zi, Ri)
    Jr, Ji = cgemm_pallas(*map(jnp.asarray, ops), three_m=True)
    scale = float(np.abs(np.asarray(Jr)).max()) + 1e-9
    for ours, theirs in ((Zr, Jr), (Zi, Ji)):
        np.testing.assert_allclose(ours.numpy() / scale,
                                   np.asarray(theirs) / scale, atol=2e-5)


def test_cpu_wrapper_bf16_offset_view():
    rng = np.random.default_rng(3)
    ops = [rng.standard_normal(s).astype(np.float32)
           for s in ((2, 9, 24), (2, 9, 24), (2, 24, 40), (2, 24, 40))]
    ts = [_offset(a, torch.bfloat16, True) for a in ops]
    assert operand_variant(*ts).scalar
    before = cgemm_cuda.launches
    Zr, Zi = cgemm_cuda(*ts, three_m=False)
    assert cgemm_cuda.launches == before and Zr.dtype == torch.bfloat16
    Rr, Ri = cgemm_ref(*ts, three_m=False)
    assert torch.equal(Zr, Rr) and torch.equal(Zi, Ri)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", range(len(SHAPES)))
def test_a_pinned_row_runs_any_m(shape, dtype):
    """A pin overrides the M-based pick; the grid still covers M, and the
    load form still follows the operands (C = 3 takes scalar loads)."""
    size = torch.tensor([], dtype=dtype).element_size()
    for M in (1, 4, 17, 33, 1024, 4096):
        for C, N in ((64, 64), (3, 64), (512, 512)):
            v = choose_variant(130, M, C, N, dtype, True, shape)
            assert v.code % len(SHAPES) == shape
            assert v.scalar == ((C * size) % 16 != 0
                                or (N * size) % 16 != 0)
            assert (v.bm, v.bn, v.bk, v.stages) == (
                SHAPES[shape][0], SHAPES[shape][1], SHAPES[shape][2],
                SHAPES[shape][5])
            assert v.grid == (-(-N // v.bn), -(-M // v.bm), 130)
            assert v.grid[1] <= 65535
            assert v.name == variant_name(v.code)
            assert choose_variant(130, M, C, N, dtype, False, shape).scalar


def test_shape_for_blocks_names_one_row():
    assert shape_for_blocks() is None
    for i, (bm, bn, bk, *_) in enumerate(SHAPES):
        assert shape_for_blocks(bm) == i
        assert shape_for_blocks(bm, bn, bk) == i
        assert shape_for_blocks(bm=bm, bk=bk) == i
    assert shape_for_blocks(bn=64) == LARGE
    for bad in (dict(bk=16), dict(bn=128), dict(bm=12), dict(bm=4, bn=64),
                dict(bm=64, bk=32), dict(bm=64.0), dict(bm=True)):
        with pytest.raises(ValueError, match="0: \\(bm=64, bn=64, bk=16\\)"):
            shape_for_blocks(**bad)


def test_variant_launches_count_every_variant_by_name():
    assert set(cgemm_cuda.variant_launches) == {
        variant_name(code) for code in range(2 * len(SHAPES))}
    assert "small-32x128-scalar" in cgemm_cuda.variant_launches


@pytest.mark.parametrize("shape", [None] + list(range(len(SHAPES))))
def test_cpu_wrapper_takes_a_pin(shape):
    """On the CPU a pinned call runs the plain version and counts no
    launch, like an unpinned one; a row outside the table is refused."""
    rng = np.random.default_rng(5)
    ts = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
          for s in ((2, 9, 24), (2, 9, 24), (2, 24, 40), (2, 24, 40))]
    before = (cgemm_cuda.launches, dict(cgemm_cuda.variant_launches))
    Zr, Zi = cgemm_cuda(*ts, shape=shape)
    assert (cgemm_cuda.launches, cgemm_cuda.variant_launches) == before
    Rr, Ri = cgemm_ref(*ts)
    assert torch.equal(Zr, Rr) and torch.equal(Zi, Ri)
    want = 3 if shape is None else shape       # M = 9: small-16 unpinned
    assert operand_variant(*ts, shape=shape).code % len(SHAPES) == want


@pytest.mark.parametrize("shape", [-1, len(SHAPES), 1.0, True])
def test_a_pin_outside_the_table_is_refused(shape):
    ts = [torch.zeros(s) for s in ((1, 4, 4), (1, 4, 4), (1, 4, 4),
                                   (1, 4, 4))]
    with pytest.raises(ValueError, match="row of SHAPES"):
        cgemm_cuda(*ts, shape=shape)
    choose_variant(1, 4, 4, 4, torch.float32, True, 1)   # a cached row 1
    with pytest.raises(ValueError, match="row of SHAPES"):
        choose_variant(1, 4, 4, 4, torch.float32, True, shape)
