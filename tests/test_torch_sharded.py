"""The sharded schedules of repro_torch (``nfft``/``wfft`` over
``torch.distributed``) against the JAX package's, on the same numpy
inputs (seeded ``default_rng``).

(a) In process, on a one-rank gloo group and a (1, 1) mesh: twins of the
    parametrized tests of ``tests/test_conv_overlap.py`` (overlapped =
    sequential = oracle, prepared = one-shot, the overlap knob's
    validation, normalization and auto resolution, overlap and mesh in the
    plan-cache key, one CGEMM row across slabs) over ``fft-torch`` /
    ``fft-cuda`` (its kernels' plain versions on the CPU), and against JAX
    ``fft-xla`` at a (1, 1) mesh: outputs, ``stage_trace`` counts, the
    collectives each schedule issues and the bytes they move; the mesh
    knobs' refusals.
(b) Spawned gloo groups over a ``FileStore``, at meshes (1, 2), (2, 2)
    and (1, 4), against JAX processes with four emulated host devices
    (as ``tests/test_distributed.py`` runs them) that write their outputs
    to ``.npz`` files.

Tolerances: float32 within 1e-5 of max|y| against JAX and 1e-4 against
the direct oracle; bf16 operands within 5e-2 scaled (as the bf16 CGEMM
is held in ``tests/test_torch_cgemm.py``)."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

import jax
import jax.numpy as jnp

import repro.conv as jconv
from repro.compat import make_mesh as jmake_mesh
from repro.conv import stages as jstages
import repro_torch.conv as tconv
from repro_torch.conv import plan as tplan
from repro_torch.conv import registry as tregistry
from repro_torch.core.fftconv import conv2d_direct
from repro_torch.kernels.cgemm.ops import SHAPES, default_shape
from repro_torch.launch import mesh as tmesh

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
BACKENDS = ["fft-torch", "fft-cuda"]
SCHEDULES = ["nfft", "wfft"]
F32_TOL, ORACLE_TOL, BF16_TOL = 1e-5, 1e-4, 5e-2


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _t(a):
    return torch.from_numpy(a)


def _scaled(y, ref):
    y, ref = np.asarray(y, np.float64), np.asarray(ref, np.float64)
    return np.abs(y - ref).max() / np.abs(ref).max()


@pytest.fixture(scope="module")
def mesh():
    """A (1, 1) mesh on a one-rank gloo group, for the whole module."""
    tmesh.start_process_group("gloo")
    try:
        yield tmesh.make_host_mesh(1, 1)
    finally:
        tmesh.destroy_process_group()


@pytest.fixture(scope="module")
def jmesh():
    return jmake_mesh((1, 1), ("data", "model"))


def _counts(c):
    """The stage-op counts a JAX trace has too (the collective keys are
    the port's own)."""
    return {k: v for k, v in c.items()
            if not (isinstance(k, tuple) and k[0].startswith("collective"))}


# --------------------------------------------------------------------------
# (a) In process: one rank, mesh (1, 1)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("spectrum", ["real", "complex"])
@pytest.mark.parametrize("batch", [4, 5])   # 5: odd remainder, slabs 3+2
def test_overlap_matches_sequential_and_oracle(mesh, jmesh, backend,
                                               schedule, spectrum, batch):
    x, k = _rand((batch, 3, 12, 12), 1), _rand((4, 3, 3, 3), 2)
    kw = dict(padding=1, backend=backend, schedule=schedule, mesh=mesh,
              spectrum=spectrum)
    seq = tconv.plan_conv(x.shape, k.shape, overlap="off", **kw)
    ovl = tconv.plan_conv(x.shape, k.shape, overlap="slab:2", **kw)
    assert seq.num_slabs == 1 and ovl.num_slabs == 2
    y_seq = seq(_t(x), _t(k)).full_tensor().numpy()
    y_ovl = ovl(_t(x), _t(k)).full_tensor().numpy()
    np.testing.assert_allclose(y_ovl, y_seq, rtol=1e-5, atol=1e-5)
    y0 = conv2d_direct(_t(x), _t(k), padding=1).numpy()
    assert _scaled(y_ovl, y0) <= ORACLE_TOL
    jplan = jconv.plan_conv(x.shape, k.shape, padding=1, backend="fft-xla",
                            schedule=schedule, mesh=jmesh,
                            spectrum=spectrum, overlap="slab:2")
    yj = np.asarray(jax.jit(jplan)(jnp.asarray(x), jnp.asarray(k)))
    assert _scaled(y_ovl, yj) <= F32_TOL


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("schedule", SCHEDULES)
def test_overlap_prepared_matches_one_shot(mesh, backend, schedule):
    x, k = _rand((5, 3, 12, 12), 3), _rand((4, 3, 3, 3), 4)
    plan = tconv.plan_conv(x.shape, k.shape, padding=1, backend=backend,
                           schedule=schedule, mesh=mesh, overlap="slab:2")
    prepared = plan.prepare(_t(k))
    np.testing.assert_allclose(prepared(_t(x)).full_tensor().numpy(),
                               plan(_t(x), _t(k)).full_tensor().numpy(),
                               rtol=1e-6, atol=1e-6)


def test_overlap_validation_and_normalization(mesh):
    shp = ((4, 3, 12, 12), (4, 3, 3, 3))
    for bad in ("slabs:2", "slab:x"):
        with pytest.raises(ValueError, match="unknown overlap"):
            tconv.plan_conv(*shp, padding=1, schedule="nfft", mesh=mesh,
                            overlap=bad)
    # local schedules have no boundary collective to overlap
    for backend in ("fft-torch", "direct"):
        with pytest.raises(ValueError, match="sharded stage-pipeline"):
            tconv.plan_conv(*shp, padding=1, backend=backend,
                            overlap="slab:2")
    p = tconv.plan_conv(*shp, padding=1, backend="fft-torch",
                        overlap="off")
    assert p.overlap == "off" and p.num_slabs == 1
    # an oversize slab count clamps once to the per-rank batch
    p = tconv.plan_conv(*shp, padding=1, schedule="nfft", mesh=mesh,
                        overlap="slab:8")
    assert p.overlap == "slab:4" and p.num_slabs == 4


def test_overlap_auto_resolution(mesh, monkeypatch):
    kw = dict(padding=1, schedule="nfft", mesh=mesh, overlap="auto")
    assert tconv.plan_conv((4, 3, 12, 12), (4, 3, 3, 3),
                           **kw).overlap == "slab:2"
    assert tconv.plan_conv((2, 3, 12, 12), (4, 3, 3, 3),
                           **kw).overlap == "off"
    assert tconv.plan_conv((4, 3, 12, 12), (4, 3, 3, 3), padding=1,
                           backend="fft-torch",
                           overlap="auto").overlap == "off"
    # an opaque backend on a sharded schedule has no stage pipeline to
    # slab: "auto" is "off" there, as in the reference
    monkeypatch.setitem(tregistry._BACKENDS, "opaque-nfft",
                        tregistry.BackendInfo(
                            name="opaque-nfft", schedules=("nfft",),
                            execute=lambda plan, x, k: x))
    assert tconv.plan_conv((4, 3, 12, 12), (4, 3, 3, 3),
                           backend="opaque-nfft", **kw).overlap == "off"


def test_overlap_and_mesh_are_part_of_the_plan_cache_key(mesh):
    shp = ((4, 3, 12, 12), (4, 3, 3, 3))
    kw = dict(padding=1, schedule="nfft", mesh=mesh)
    seq = tconv.plan_conv(*shp, overlap="off", **kw)
    ovl = tconv.plan_conv(*shp, overlap="slab:2", **kw)
    assert seq is not ovl
    assert seq is tconv.plan_conv(*shp, overlap="off", **kw)
    assert ovl is tconv.plan_conv(*shp, overlap="slab:2", **kw)
    assert f"overlap={ovl.overlap}" in ovl.describe()
    assert "mesh axes: data=1 x model=1" in ovl.describe()
    # meshes key by value: an equal mesh object shares the entry, a
    # mesh with other dim names does not
    same = tmesh.make_host_mesh(1, 1)
    assert same is not mesh
    assert tconv.plan_conv(*shp, overlap="off", padding=1, schedule="nfft",
                           mesh=same) is seq
    other = tmesh.make_mesh((1, 1), ("dp", "mp"), device_type="cpu")
    p = tconv.plan_conv(*shp, padding=1, schedule="nfft", mesh=other,
                        data_axis="dp", model_axis="mp")
    assert p is not seq and "mesh axes: dp=1 x mp=1" in p.describe()
    assert tplan._mesh_cache_key(mesh) == (("data", "model"), (1, 1), (0,),
                                           "cpu")


@pytest.mark.parametrize("batch", [4, 5])
@pytest.mark.parametrize("schedule", SCHEDULES)
def test_overlap_cuda_row_pinned_at_plan_time(mesh, monkeypatch, schedule,
                                              batch):
    """fft-cuda overlap plans pin one CGEMM row, for the smallest slab's
    M, and every slab launches it."""
    from repro_torch.kernels import cgemm
    x, k = _rand((batch, 3, 40, 40), 5), _rand((4, 3, 3, 3), 6)
    plan = tconv.plan_conv(x.shape, k.shape, padding=1, backend="fft-cuda",
                           schedule=schedule, mesh=mesh, overlap="slab:2")
    m_min = (batch // 2) * plan.spec.n_tiles
    row = default_shape(m_min)
    assert (plan.bm, plan.bn, plan.bk) == SHAPES[row][:3]
    seen, real = [], cgemm.cgemm_cuda

    def spy(*args, **kwargs):
        seen.append((args[0].shape[1], kwargs.get("shape")))
        return real(*args, **kwargs)
    monkeypatch.setattr(cgemm, "cgemm_cuda", spy)
    plan.prepare(_t(k))(_t(x))
    sizes = [-(-batch // 2), batch // 2]
    assert seen == [(b * plan.spec.n_tiles, row) for b in sizes]
    # an explicit pin names the row of every slab
    pinned = tconv.plan_conv(x.shape, k.shape, padding=1,
                             backend="fft-cuda", schedule=schedule,
                             mesh=mesh, overlap="slab:2", bm=32)
    assert pinned.bm == 32


def _jax_counts(plan, x, k, prepared):
    run = plan.prepare(jnp.asarray(k)) if prepared else None
    with jstages.stage_trace() as c:
        if prepared:
            jax.make_jaxpr(run)(jnp.asarray(x))
        else:
            jax.make_jaxpr(lambda a, b: plan(a, b))(jnp.asarray(x),
                                                    jnp.asarray(k))
    return dict(c)


@pytest.mark.parametrize("schedule,replicate", [
    ("nfft", False), ("nfft", True), ("wfft", False)])
@pytest.mark.parametrize("overlap", ["off", "slab:2"])
@pytest.mark.parametrize("prepared", [False, True])
def test_stage_counts_match_jax(mesh, jmesh, schedule, replicate, overlap,
                                prepared):
    x, k = _rand((5, 3, 12, 12), 7), _rand((4, 3, 3, 3), 8)
    kw = dict(padding=1, schedule=schedule, overlap=overlap,
              replicate_kernel_transform=replicate)
    plan = tconv.plan_conv(x.shape, k.shape, backend="fft-cuda", mesh=mesh,
                           **kw)
    jplan = jconv.plan_conv(x.shape, k.shape, backend="fft-xla",
                            mesh=jmesh, **kw)
    with tconv.stage_trace() as c:
        if prepared:
            G = plan.prepare(_t(k))
    if prepared:
        assert dict(c) == {"kernel_transform": 1}      # no collective
    with tconv.stage_trace() as c:
        (G(_t(x)) if prepared else plan(_t(x), _t(k)))
    assert _counts(c) == _jax_counts(jplan, x, k, prepared)
    n_slabs = plan.num_slabs
    if schedule == "nfft":
        # prepared: no kernel transform and no a2a #2; one-shot: a2a #2
        # unless the kernel transform is replicated
        a2a = 2 * n_slabs + (not prepared and not replicate)
        assert c["boundary_a2a"] == c[("collective", "all_to_all")] == a2a
        assert c.get("kernel_transform", 0) == (0 if prepared else 1)
        assert ("collective", "all_reduce") not in c      # hot stage free
    else:
        assert c[("collective", "all_reduce")] == n_slabs
        assert "boundary_a2a" not in c
        assert ("collective", "all_to_all") not in c


def _bytes(mesh, schedule, prepared, **kw):
    x, k = _rand((4, 8, 20, 20), 9), _rand((8, 8, 3, 3), 10)
    plan = tconv.plan_conv(x.shape, k.shape, padding=1, schedule=schedule,
                           mesh=mesh, **kw)
    run = plan.prepare(_t(k)) if prepared else None
    with tconv.stage_trace() as c:
        run(_t(x)) if prepared else plan(_t(x), _t(k))
    kind = "all_to_all" if schedule == "nfft" else "all_reduce"
    return c[("collective_bytes", kind)]


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("prepared", [False, True])
def test_compact_spectrum_moves_about_half_the_bytes(mesh, schedule,
                                                     prepared):
    real = _bytes(mesh, schedule, prepared, spectrum="real")
    full = _bytes(mesh, schedule, prepared, spectrum="complex")
    assert real <= 0.55 * full


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_bf16_halves_the_collective_bytes(mesh, schedule):
    """The cast to ``compute_dtype`` happens before the hot-path
    collectives (nfft a2a #1 and #3, the wfft all-reduce)."""
    f32 = _bytes(mesh, schedule, True)
    bf16 = _bytes(mesh, schedule, True, compute_dtype=torch.bfloat16)
    assert 2 * bf16 == f32


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("schedule", SCHEDULES)
def test_epilogue_and_dtensor_input_match_jax(mesh, jmesh, backend,
                                              schedule):
    """Bias + ReLU + residual fused on the rank's slab, the input given as
    the DTensor a previous layer returns, against JAX fft-xla."""
    from torch.distributed.tensor import DTensor, Shard
    x, k = _rand((3, 5, 14, 14), 11), _rand((6, 5, 3, 3), 12)
    b, r = _rand((6,), 13), _rand((3, 6, 14, 14), 14)
    ep = dict(bias=True, activation="relu", residual=True)
    plan = tconv.plan_conv(x.shape, k.shape, padding=1, backend=backend,
                           schedule=schedule, mesh=mesh,
                           epilogue=tconv.Epilogue(**ep))
    xd = DTensor.from_local(_t(x), mesh, (Shard(0), Shard(1)))
    y = plan.prepare(_t(k))(xd, bias=_t(b), residual=_t(r))
    assert isinstance(y, DTensor) and tuple(y.shape) == (3, 6, 14, 14)
    assert tuple(y.placements) == (Shard(0), Shard(1))
    jplan = jconv.plan_conv(x.shape, k.shape, padding=1, backend="fft-xla",
                            schedule=schedule, mesh=jmesh,
                            epilogue=jconv.Epilogue(**ep))
    yj = np.asarray(jax.jit(jplan)(jnp.asarray(x), jnp.asarray(k),
                                   bias=jnp.asarray(b),
                                   residual=jnp.asarray(r)))
    assert _scaled(y.full_tensor().numpy(), yj) <= F32_TOL
    with pytest.raises(ValueError, match="placed"):
        plan(DTensor.from_local(_t(x), mesh, (Shard(1), Shard(0))), _t(k),
             bias=_t(b), residual=_t(r))


def test_network_chains_dtensors_through_pools(mesh):
    """plan_network on a mesh: each layer's DTensor output feeds the next
    layer (and the pool) as it is; the result equals the local trunk."""
    from torch.distributed.tensor import DTensor
    from repro_torch.models.layers import maxpool2x2
    shapes = [((2, 3, 16, 16), (4, 3, 3, 3)), ((2, 4, 8, 8), (6, 4, 3, 3))]
    layers = [tconv.NetworkConv(f"l{i}", xs, ks, padding=1,
                                epilogue=tconv.Epilogue(bias=True,
                                                        activation="relu"))
              for i, (xs, ks) in enumerate(shapes)]
    params = {f"l{i}": _t(_rand(ks, 20 + i))
              for i, (_, ks) in enumerate(shapes)}
    biases = {f"l{i}": _t(_rand(ks[:1], 30 + i))
              for i, (_, ks) in enumerate(shapes)}
    x = _t(_rand(shapes[0][0], 40))
    outs = []
    for kw in (dict(mesh=mesh, schedule="nfft"), {}):
        net = tconv.plan_network(layers, backend="fft-cuda", **kw)
        prepared = net.prepare(params)
        h = x
        for name in net:
            h = maxpool2x2(prepared[name](h, bias=biases[name]))
        outs.append(h)
    assert isinstance(outs[0], DTensor) and "mesh data=1 x model=1 (cpu)" \
        in tconv.plan_network(layers, mesh=mesh).describe()
    assert tuple(outs[0].shape) == (2, 6, 4, 4)
    np.testing.assert_allclose(outs[0].full_tensor().numpy(),
                               outs[1].numpy(), rtol=1e-5, atol=1e-5)


def test_mesh_knobs_are_checked_as_the_reference_checks_them(mesh, jmesh):
    shp = ((2, 3, 12, 12), (4, 3, 3, 3))
    pairs = [(dict(schedule="nfft"), {}),
             (dict(schedule="local", mesh=mesh),
              dict(schedule="local", mesh=jmesh)),
             (dict(mesh=mesh, model_axis="tp"),
              dict(mesh=jmesh, model_axis="tp"))]
    for ours, theirs in pairs:
        with pytest.raises(ValueError) as t:
            tconv.plan_conv(*shp, padding=1, **ours)
        with pytest.raises(ValueError) as j:
            jconv.plan_conv(*shp, padding=1, **(theirs or ours))
        assert str(t.value) == str(j.value)
    with pytest.raises(TypeError, match="DeviceMesh"):
        tconv.plan_conv(*shp, padding=1, mesh=object())
    with pytest.raises(ValueError, match="does not support schedule"):
        tconv.plan_conv(*shp, padding=1, backend="direct", mesh=mesh)
    # auto resolves to the sharded pipeline twin of fft-xla on a mesh
    p = tconv.plan_conv(*shp, padding=1, mesh=mesh)
    assert (p.backend, p.schedule) == ("fft-torch", "nfft")
    jp = jconv.plan_conv(*shp, padding=1, mesh=jmesh)
    assert (jp.backend, jp.schedule) == ("fft-xla", "nfft")


def test_former_later_slice_paths_run(mesh):
    """What once waited for later slices, and raised, runs now: grads
    through the sharded schedules, and the serving engine on a mesh."""
    from repro_torch.launch.batcher import BucketPolicy, ServeEngine
    x, k = _rand((2, 3, 12, 12), 15), _rand((4, 3, 3, 3), 16)
    plan = tconv.plan_conv(x.shape, k.shape, padding=1, schedule="wfft",
                           mesh=mesh)
    # grads through the sharded schedules are ported: they run
    assert plan.differentiable
    xg = _t(x).requires_grad_()
    plan(xg, _t(k)).full_tensor().sum().backward()
    plan.prepare(_t(k))(xg).full_tensor().sum().backward()
    assert type(xg.grad) is torch.Tensor and xg.grad.shape == x.shape
    with torch.no_grad():
        plan(xg, _t(k))                  # no grad asked: runs
    # the serving engine on the mesh builds and serves a plain tensor
    eng = ServeEngine(
        lambda b: [tconv.NetworkConv("c", (b,) + x.shape[1:], k.shape,
                                     padding=1)],
        {"c": _t(k)}, policy=BucketPolicy(max_batch=2), device="cpu",
        mesh=mesh, schedule="wfft")
    rid = eng.submit(_t(x))
    eng.drain(force=True)
    y = eng.results[rid]
    assert type(y) is torch.Tensor and y.shape == (2, 4, 12, 12)
    y0 = conv2d_direct(_t(x), _t(k), padding=1).numpy()
    assert _scaled(y.numpy(), y0) <= ORACLE_TOL


def test_tuned_plan_on_a_mesh_runs(mesh, tmp_path, monkeypatch):
    """The tuner over the sharded schedules: ``plan_conv(backend="tuned",
    mesh=)`` measures nfft and wfft (on the CPU when asked) and plans the
    winner, which matches the fft-torch plan of the same schedule; the
    schedule alone (``candidates(schedule="nfft")``) is a space of its
    own."""
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path / "t.json"))
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_REPS", "1")
    tconv.autotune.reset()
    x, k = _rand((2, 3, 12, 12), 15), _rand((4, 3, 3, 3), 16)
    try:
        with tconv.autotune.measure_on("cpu"):
            plan = tconv.plan_conv(x.shape, k.shape, padding=1,
                                   backend="tuned", mesh=mesh)
        assert plan.schedule in SCHEDULES and plan.backend in BACKENDS
        assert tconv.autotune_info().measured == 1
        ref = tconv.plan_conv(x.shape, k.shape, padding=1,
                              backend="fft-torch", schedule=plan.schedule,
                              mesh=mesh)
        np.testing.assert_allclose(
            plan(_t(x), _t(k)).full_tensor().numpy(),
            ref(_t(x), _t(k)).full_tensor().numpy(), rtol=1e-5, atol=1e-5)
        nfft = tconv.autotune.candidates(plan.spec, schedule="nfft",
                                         mesh=mesh)
        assert {c.schedule for c in nfft} == {"nfft"}
    finally:
        tconv.autotune.reset()


def test_make_mesh_checks_ranks_and_device(mesh, monkeypatch):
    with pytest.raises(RuntimeError, match=r"needs 2 ranks, found 1"):
        tmesh.make_host_mesh(1, 2)
    # a cuda mesh refuses a gloo group: its collectives would go through
    # the host
    with pytest.raises(RuntimeError, match="needs an NCCL process group"):
        tmesh.make_mesh((1, 1), ("data", "model"), device_type="cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device_type='cpu'"):
        tmesh.make_mesh((1, 1), ("data", "model"))
    # the default backend is NCCL, which needs a GPU
    with pytest.raises(RuntimeError, match="backend='gloo'"):
        tmesh.start_process_group()
    assert tmesh.dp_axes(mesh) == ("data",)
    with pytest.raises(ValueError, match="shared store"):
        tmesh.start_process_group("gloo", world_size=2)


# --------------------------------------------------------------------------
# (b) Spawned gloo groups at meshes (1, 2), (2, 2), (1, 4) vs JAX
# --------------------------------------------------------------------------

_LAYER = ((4, 8, 28, 28), (8, 8, 3, 3))     # tests/test_distributed.py
_NET = [[(4, 3, 16, 16), (4, 3, 3, 3), True],
        [(4, 4, 8, 8), (6, 4, 3, 3), True],
        [(4, 6, 4, 4), (5, 6, 3, 3), False]]
_KINDS = {
    "layer": dict(x=_LAYER[0], k=_LAYER[1]),
    # odd channels: C=3 and C'=5 padded to model-axis multiples (at
    # (1, 4) one input channel a rank), B=3 to data-axis multiples
    "odd": dict(x=(3, 3, 12, 12), k=(5, 3, 3, 3)),
    "slab2": dict(x=(5, 4, 12, 12), k=(4, 4, 3, 3), overlap="slab:2"),
    "epilogue": dict(x=(3, 5, 12, 12), k=(6, 5, 3, 3), bias=True,
                     act="relu", residual=True),
    "prepared": dict(x=(5, 4, 12, 12), k=(6, 4, 3, 3), prepared=True,
                     bias=True, act="relu", overlap="slab:2"),
    "bf16": dict(x=(4, 4, 12, 12), k=(4, 4, 3, 3), bf16=True),
    "net": dict(x=None, k=None, net=_NET),
}
# every kind at (1, 2); at (2, 2) and (1, 4) the kinds a data split or one
# channel a rank changes; the replicated kernel transform at each mesh
_MESHES = {(1, 2): tuple(_KINDS), (2, 2): ("odd", "slab2", "net"),
           (1, 4): ("layer", "odd", "prepared")}
CASES = []
for _m, _kinds in _MESHES.items():
    _tag = "x".join(map(str, _m))
    for _s in SCHEDULES:
        CASES += [dict(name=f"{_tag}-{_s}-{kind}", mesh=list(_m),
                       schedule=_s, seed=i, **_KINDS[kind])
                  for i, kind in enumerate(_kinds)]
    CASES.append(dict(name=f"{_tag}-nfft-replicate", mesh=list(_m),
                      schedule="nfft", seed=7, x=_LAYER[0], k=_LAYER[1],
                      replicate=True))

# Runs one case through a package's plan API; ``L`` holds the package's
# plan_conv, plan_network, NetworkConv, Epilogue, maxpool2x2, array(),
# bf16 and jit (JAX's, or none).  ``mesh=None`` plans locally: with
# backend "direct", the oracle.
_RUNNER = r'''
import numpy as np

def inputs(c):
    rng = np.random.default_rng(c["seed"])
    layers = c.get("net") or [[c["x"], c["k"], False]]
    x = rng.standard_normal(layers[0][0]).astype(np.float32)
    ks = [rng.standard_normal(l[1]).astype(np.float32) for l in layers]
    bs = [rng.standard_normal(l[1][:1]).astype(np.float32) for l in layers]
    r = rng.standard_normal(
        (layers[0][0][0], layers[0][1][0]) + tuple(layers[0][0][2:])
    ).astype(np.float32)
    return layers, x, ks, bs, r

def run(L, c, mesh, backend):
    layers, x, ks, bs, r = inputs(c)
    kw = dict(backend=backend)
    if mesh is not None:
        kw.update(mesh=mesh, schedule=c["schedule"],
                  overlap=c.get("overlap", "off"))
    if c.get("bf16"):
        kw["compute_dtype"] = L.bf16
    if c.get("net"):
        net = L.plan_network(
            [L.NetworkConv(f"l{i}", tuple(l[0]), tuple(l[1]), padding=1,
                           epilogue=L.Epilogue(bias=True,
                                               activation="relu"))
             for i, l in enumerate(layers)], **kw)
        prepared = net.prepare({f"l{i}": L.array(k)
                                for i, k in enumerate(ks)})

        def forward(h, *b):
            for i, l in enumerate(layers):
                h = prepared[f"l{i}"](h, bias=b[i])
                if l[2]:
                    h = L.maxpool2x2(h)
            return h
        return L.jit(forward)(L.array(x), *map(L.array, bs))
    if mesh is not None:
        kw["replicate_kernel_transform"] = c.get("replicate", False)
    ep = L.Epilogue(bias=c.get("bias", False),
                    activation=c.get("act", "none"),
                    residual=c.get("residual", False))
    plan = L.plan_conv(tuple(x.shape), tuple(ks[0].shape), padding=1,
                       epilogue=ep, **kw)
    names = ["bias"] * ep.bias + ["residual"] * ep.residual
    ops = [L.array(a) for a in [bs[0]] * ep.bias + [r] * ep.residual]
    if c.get("prepared"):
        prepared = plan.prepare(L.array(ks[0]))
        return L.jit(lambda x, *o: prepared(x, **dict(zip(names, o))))(
            L.array(x), *ops)
    return L.jit(lambda x, k, *o: plan(x, k, **dict(zip(names, o))))(
        L.array(x), L.array(ks[0]), *ops)
'''

_TORCH_LIB = r'''
import types, torch
import repro_torch.conv as C
from repro_torch.models.layers import maxpool2x2
L = types.SimpleNamespace(
    plan_conv=C.plan_conv, plan_network=C.plan_network,
    NetworkConv=C.NetworkConv, Epilogue=C.Epilogue, maxpool2x2=maxpool2x2,
    array=torch.from_numpy, bf16=torch.bfloat16, jit=lambda f: f)
'''

_TORCH_RANK = _TORCH_LIB + _RUNNER + r'''
import json, math, os, sys
from repro_torch.launch import mesh as M
rank, world = int(os.environ["RANK"]), int(os.environ["WORLD"])
M.start_process_group("gloo", rank=rank, world_size=world,
                      store_path=os.environ["STORE"])
out, counts, meshes = {}, {}, {}
for c in json.load(open(os.environ["CASES"])):
    if math.prod(c["mesh"]) != world:
        continue
    key = tuple(c["mesh"])
    if key not in meshes:
        meshes[key] = M.make_host_mesh(*key)
    with C.stage_trace() as n:
        y = run(L, c, meshes[key], c["backend"])
    out[c["name"]] = y.full_tensor().float().numpy()
    counts[c["name"]] = {"all_to_all": n[("collective", "all_to_all")],
                         "all_reduce": n[("collective", "all_reduce")]}
if rank == 0:
    np.savez(os.environ["OUT"], counts=json.dumps(counts), **out)
M.destroy_process_group()
'''

_JAX = r'''
import json, os, sys
from repro.launch import env
env.apply(4)
import jax, jax.numpy as jnp
import repro.conv as C
from repro.compat import make_mesh
from repro.models.layers import maxpool2x2
import types
L = types.SimpleNamespace(
    plan_conv=C.plan_conv, plan_network=C.plan_network,
    NetworkConv=C.NetworkConv, Epilogue=C.Epilogue, maxpool2x2=maxpool2x2,
    array=jnp.asarray, bf16=jnp.bfloat16, jit=jax.jit)
''' + _RUNNER + r'''
meshes, out = {}, {}
for c in json.load(open(os.environ["CASES"])):
    key = tuple(c["mesh"])
    if (key == (1, 2)) != (os.environ["PART"] == "1x2"):
        continue
    if key not in meshes:
        meshes[key] = make_mesh(key, ("data", "model"))
    out[c["name"]] = np.asarray(run(L, c, meshes[key], "fft-xla"),
                                np.float32)
np.savez(os.environ["OUT"], **out)
'''


def _oracle(c):
    """The direct oracle of a case (bf16 cases: the operands rounded to
    bf16, convolved in float32)."""
    scope = {}
    exec(_TORCH_LIB + _RUNNER, scope)
    with torch.no_grad():
        return scope["run"](scope["L"], c, None, "direct").numpy()


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """Run every case once: the port in a 2-rank and a 4-rank gloo world
    (fft-torch and fft-cuda on alternate cases), JAX fft-xla in two
    processes with four host devices each (the (1, 2) cases, the rest);
    all concurrently."""
    tmp = tmp_path_factory.mktemp("sharded")
    cases = [dict(c, backend=BACKENDS[i % 2]) for i, c in enumerate(CASES)]
    (tmp / "cases.json").write_text(json.dumps(cases))
    base = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                CASES=str(tmp / "cases.json"), OMP_NUM_THREADS="1")
    base.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen(
        [sys.executable, "-c", _JAX],
        env=dict(base, PART=part, OUT=str(tmp / f"jax{part}.npz")),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for part in ("1x2", "rest")]
    for world in (2, 4):
        for rank in range(world):
            procs.append(subprocess.Popen(
                [sys.executable, "-c", _TORCH_RANK],
                env=dict(base, RANK=str(rank), WORLD=str(world),
                         STORE=str(tmp / f"store{world}"),
                         OUT=str(tmp / f"torch{world}.npz")),
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
    try:
        logs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    failed = [log[-3000:] for p, log in zip(procs, logs) if p.returncode]
    assert not failed, "\n\n".join(failed)
    ours = {}
    counts = {}
    for world in (2, 4):
        with np.load(tmp / f"torch{world}.npz") as z:
            counts.update(json.loads(str(z["counts"])))
            ours.update({k: z[k] for k in z.files if k != "counts"})
    theirs = {}
    for part in ("1x2", "rest"):
        with np.load(tmp / f"jax{part}.npz") as z:
            theirs.update({k: z[k] for k in z.files})
    return {c["name"]: c for c in cases}, ours, theirs, counts


@pytest.mark.parametrize("name", [c["name"] for c in CASES])
def test_spawned_mesh_matches_jax_and_oracle(spawned, name):
    cases, ours, theirs, counts = spawned
    c = cases[name]
    y, yj, y0 = ours[name], theirs[name], _oracle(c)
    assert y.shape == yj.shape == y0.shape
    tol = BF16_TOL if c.get("bf16") else F32_TOL
    assert _scaled(y, yj) <= tol
    assert _scaled(y, y0) <= (BF16_TOL if c.get("bf16") else ORACLE_TOL)
    # nfft's hot stage is collective-free; wfft has no boundary
    assert counts[name]["all_reduce" if c["schedule"] == "nfft"
                        else "all_to_all"] == 0
