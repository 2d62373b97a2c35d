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

On the CPU the wrapper runs the plain version whatever the variant would
be, counts no launch, and agrees with the JAX package's Pallas CGEMM
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
from repro_torch.kernels.cgemm.ops import SHAPES, shape_smem_bytes

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
