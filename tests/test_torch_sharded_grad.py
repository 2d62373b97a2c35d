"""Training through the sharded schedules of repro_torch (the plan-level
VJP of ``nfft``/``wfft`` over ``torch.distributed``) against ``jax.grad``
through the JAX package's, on the same numpy inputs (seeded
``default_rng``).  The port runs ``fft-torch`` and ``fft-cuda`` (its
kernels' plain versions on the CPU); JAX runs ``fft-xla`` and
``fft-pallas`` (interpret mode), jitted.

(a) In process, on a one-rank gloo group and a (1, 1) mesh: the twins of
    ``test_sharded_grads_match_oracle_1x1`` (``tests/test_conv_grad.py``)
    and ``test_overlap_grads_match_sequential_and_oracle``
    (``tests/test_conv_overlap.py``); the epilogue's grads (bias,
    activation, residual); prepared sharded plans, with the replicated
    kernel transform on ``nfft``; the kind of each grad (a plain operand's
    grad is a plain tensor, a ``DTensor`` operand's a ``DTensor`` placed
    like it); a cotangent placed otherwise; a chain of ``conv_block``s and
    a ``maxpool2x2`` trained on the mesh; the dx plan's mesh knobs; and
    the ``stage_trace`` counts of a forward and backward against the JAX
    package's trace-time counts, with the collectives of each schedule and
    of the dk and d_bias reductions.
(b) Spawned gloo groups of 2, 4 and 8 ranks over a ``FileStore``, at
    meshes (1, 2), (2, 2), (1, 4) and (2, 4), against JAX processes with
    eight emulated host devices: uneven shards, slab overlap, the epilogue
    with ``DTensor`` operands, prepared plans; every rank's dk and d_bias
    equal bit for bit.

Tolerances: in process, rtol = atol = 1e-4 against JAX and 3e-4 against
the direct oracle (as the JAX package holds its sharded grads); spawned,
1e-4 of max|g| against JAX and 5e-4 of max|g| against the oracle (as
``test_sharded_grads_multi_device`` holds them)."""
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
import repro.models.layers as jlayers
from repro.compat import make_mesh as jmake_mesh
from repro.conv import stages as jstages
import repro_torch.conv as tconv
from repro_torch.conv import autodiff, stages
from repro_torch.core.fftconv import conv2d_direct
from repro_torch.launch import mesh as tmesh
from repro_torch.models import layers as tlayers

from test_torch_sharded import _RUNNER, _TORCH_LIB, ROOT, _counts

TWINS = [("fft-torch", "fft-xla"), ("fft-cuda", "fft-pallas")]
SCHEDULES = ["nfft", "wfft"]
JAX_TOL = dict(rtol=1e-4, atol=1e-4)
ORACLE_TOL = dict(rtol=3e-4, atol=3e-4)
SPAWN_JAX_TOL, SPAWN_ORACLE_TOL = 1e-4, 5e-4       # scaled by max|g|


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


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


def _placed(mesh, t):
    from torch.distributed.tensor import Shard, distribute_tensor
    return distribute_tensor(t, mesh, (Shard(0), Shard(1)))


def _grads(f, arrays, mesh=None, placed=()):
    """Grads of sum(sin(f(*ts))) w.r.t. every operand, the operands at
    the indices ``placed`` given as ``DTensor``s placed like a sharded
    plan's output; returns the grads as tensors (a ``DTensor`` grad as
    it is)."""
    from torch.distributed.tensor import DTensor
    ts = [(_placed(mesh, torch.from_numpy(a)) if i in placed
           else torch.from_numpy(a)).requires_grad_()
          for i, a in enumerate(arrays)]
    y = f(*ts)
    if isinstance(y, DTensor):
        y = y.full_tensor()
    torch.sin(y).sum().backward()
    return [t.grad for t in ts]


def _np(gs):
    from torch.distributed.tensor import DTensor
    return [(g.full_tensor() if isinstance(g, DTensor) else g).numpy()
            for g in gs]


def _jgrads(f, arrays):
    g = jax.jit(jax.grad(lambda *a: jnp.sum(jnp.sin(f(*a))),
                         argnums=tuple(range(len(arrays)))))
    return [np.asarray(a) for a in g(*map(jnp.asarray, arrays))]


def _close(ours, theirs, names, tol):
    for a, b, name in zip(ours, theirs, names):
        np.testing.assert_allclose(a, b, err_msg=name, **tol)


def _oracle(ep, arrays):
    """Grads of the same loss through the direct conv and the epilogue
    applied outside it."""
    from repro_torch.conv.epilogue import apply_epilogue

    def f(x, k, *o):
        ops = dict(zip(["bias"] * ep.bias + ["residual"] * ep.residual, o))
        return apply_epilogue(conv2d_direct(x, k, padding=1), ep, **ops)
    return _np(_grads(f, arrays))


# --------------------------------------------------------------------------
# (a) In process: one rank, mesh (1, 1)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("backend,jax_backend", TWINS)
@pytest.mark.parametrize("schedule", SCHEDULES)
def test_sharded_grads_match_jax_and_oracle_1x1(mesh, jmesh, backend,
                                                jax_backend, schedule):
    x, k = _rand((2, 3, 14, 14), 3), _rand((4, 3, 3, 3), 4)
    plan = tconv.plan_conv(x.shape, k.shape, padding=1, backend=backend,
                           schedule=schedule, mesh=mesh)
    jplan = jconv.plan_conv(x.shape, k.shape, padding=1,
                            backend=jax_backend, schedule=schedule,
                            mesh=jmesh)
    assert plan.differentiable and jplan.differentiable
    g = _np(_grads(plan, (x, k)))
    _close(g, _jgrads(jplan, (x, k)), ("dx", "dk"), JAX_TOL)
    _close(g, _oracle(tconv.Epilogue(), (x, k)), ("dx", "dk"), ORACLE_TOL)


@pytest.mark.parametrize("backend,jax_backend", TWINS)
@pytest.mark.parametrize("schedule", SCHEDULES)
def test_overlap_grads_match_sequential_jax_and_oracle(
        mesh, jmesh, backend, jax_backend, schedule):
    """The dx plan takes the forward's slabs: training through an
    overlapped schedule matches the sequential twin."""
    x, k = _rand((5, 3, 12, 12), 5), _rand((4, 3, 3, 3), 6)
    kw = dict(padding=1, backend=backend, schedule=schedule, mesh=mesh)
    seq = tconv.plan_conv(x.shape, k.shape, overlap="off", **kw)
    ovl = tconv.plan_conv(x.shape, k.shape, overlap="slab:2", **kw)
    assert ovl.differentiable
    assert autodiff._transposed_plan(ovl).num_slabs == 2
    g = _np(_grads(ovl, (x, k)))
    _close(g, _np(_grads(seq, (x, k))), ("dx", "dk"), JAX_TOL)
    jplan = jconv.plan_conv(x.shape, k.shape, padding=1,
                            backend=jax_backend, schedule=schedule,
                            mesh=jmesh, overlap="slab:2")
    _close(g, _jgrads(jplan, (x, k)), ("dx", "dk"), JAX_TOL)
    _close(g, _oracle(tconv.Epilogue(), (x, k)), ("dx", "dk"), ORACLE_TOL)


@pytest.mark.parametrize("backend,jax_backend", TWINS)
@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("activation,overlap", [("relu", "off"),
                                                ("gelu", "slab:2")])
def test_epilogue_grads_match_jax_and_oracle(mesh, jmesh, backend,
                                             jax_backend, schedule,
                                             activation, overlap):
    """d(x, k, bias, residual) through a fused bias + residual +
    activation plan on the rank's slab."""
    x, k = _rand((3, 5, 12, 12), 7), _rand((6, 5, 3, 3), 8)
    b, r = _rand((6,), 9), _rand((3, 6, 12, 12), 10)
    ep = dict(bias=True, activation=activation, residual=True)
    plan = tconv.plan_conv(x.shape, k.shape, padding=1, backend=backend,
                           schedule=schedule, mesh=mesh, overlap=overlap,
                           epilogue=tconv.Epilogue(**ep))
    jplan = jconv.plan_conv(x.shape, k.shape, padding=1,
                            backend=jax_backend, schedule=schedule,
                            mesh=jmesh, overlap=overlap,
                            epilogue=jconv.Epilogue(**ep))
    names = ("dx", "dk", "d_bias", "d_residual")
    g = _np(_grads(lambda a, c, d, e: plan(a, c, bias=d, residual=e),
                   (x, k, b, r)))
    _close(g, _jgrads(lambda a, c, d, e: jplan(a, c, bias=d, residual=e),
                      (x, k, b, r)), names, JAX_TOL)
    _close(g, _oracle(tconv.Epilogue(**ep), (x, k, b, r)), names,
           ORACLE_TOL)


@pytest.mark.parametrize("backend,jax_backend", TWINS)
@pytest.mark.parametrize("schedule,replicate", [
    ("nfft", False), ("nfft", True), ("wfft", False)])
@pytest.mark.parametrize("overlap", ["off", "slab:2"])
def test_prepared_grads_match_jax_and_oracle(mesh, jmesh, backend,
                                             jax_backend, schedule,
                                             replicate, overlap):
    """dx, d_bias and d_residual of a prepared sharded plan: dx from the
    prepared plan's global kernel through the one-shot dx plan."""
    x, k = _rand((5, 4, 12, 12), 11), _rand((6, 4, 3, 3), 12)
    b, r = _rand((6,), 13), _rand((5, 6, 12, 12), 14)
    ep = dict(bias=True, activation="relu", residual=True)
    kw = dict(padding=1, schedule=schedule, overlap=overlap,
              replicate_kernel_transform=replicate)
    prepared = tconv.plan_conv(x.shape, k.shape, backend=backend,
                               mesh=mesh, epilogue=tconv.Epilogue(**ep),
                               **kw).prepare(torch.from_numpy(k))
    jprepared = jconv.plan_conv(x.shape, k.shape, backend=jax_backend,
                                mesh=jmesh, epilogue=jconv.Epilogue(**ep),
                                **kw).prepare(jnp.asarray(k))
    assert autodiff._transposed_plan(prepared.plan) \
        .replicate_kernel_transform == replicate
    names = ("dx", "d_bias", "d_residual")
    g = _np(_grads(lambda a, d, e: prepared(a, bias=d, residual=e),
                   (x, b, r)))
    _close(g, _jgrads(lambda a, d, e: jprepared(a, bias=d, residual=e),
                      (x, b, r)), names, JAX_TOL)
    oracle = _oracle(tconv.Epilogue(**ep), (x, k, b, r))
    _close(g, [oracle[0]] + oracle[2:], names, ORACLE_TOL)


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_grads_take_the_kind_of_their_operand(mesh, schedule):
    """A plain operand gets a plain global grad (autograd would store a
    DTensor as the grad of a plain tensor without complaint); a DTensor
    operand gets a DTensor placed like it.  Both give the same values."""
    from torch.distributed.tensor import DTensor, Shard
    x, k = _rand((3, 5, 12, 12), 15), _rand((6, 5, 3, 3), 16)
    b, r = _rand((6,), 17), _rand((3, 6, 12, 12), 18)
    plan = tconv.plan_conv(x.shape, k.shape, padding=1, backend="fft-cuda",
                           schedule=schedule, mesh=mesh,
                           epilogue=tconv.Epilogue(bias=True,
                                                   activation="relu",
                                                   residual=True))

    def f(a, c, d, e):
        return plan(a, c, bias=d, residual=e)
    with tconv.stage_trace() as c:
        plain = _grads(f, (x, k, b, r))
    assert all(type(g) is torch.Tensor for g in plain)
    # dx and d_residual gathered whole, each by one counted collective
    assert c[("collective", "grad_full")] == 2
    with tconv.stage_trace() as c:
        placed = _grads(f, (x, k, b, r), mesh, placed=(0, 3))
    assert ("collective", "grad_full") not in c
    for i in (0, 3):
        assert isinstance(placed[i], DTensor)
        assert tuple(placed[i].placements) == (Shard(0), Shard(1))
        assert placed[i].shape == plain[i].shape
    assert type(placed[1]) is torch.Tensor
    assert type(placed[2]) is torch.Tensor
    for a, c in zip(_np(placed), _np(plain)):
        np.testing.assert_array_equal(a, c)
    # prepared: the same kinds
    prepared = plan.prepare(torch.from_numpy(k))
    g = _grads(lambda a, d, e: prepared(a, bias=d, residual=e), (x, b, r),
               mesh, placed=(0,))
    assert isinstance(g[0], DTensor) and type(g[1]) is torch.Tensor \
        and type(g[2]) is torch.Tensor


def test_a_cotangent_placed_otherwise_is_redistributed(mesh):
    """A loss taken after a redistribute hands back a cotangent placed
    (Replicate, Replicate): the VJP redistributes it to the output's
    placements, and the grads are those of the usual loss."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    x, k = _rand((2, 3, 12, 12), 19), _rand((4, 3, 3, 3), 20)
    plan = tconv.plan_conv(x.shape, k.shape, padding=1, schedule="nfft",
                           mesh=mesh)
    seen = []
    real = stages.output_block

    def spy(plan, t, sh):
        seen.append(tuple(t.placements))
        return real(plan, t, sh)
    want = _np(_grads(plan, (x, k)))
    stages.output_block = spy
    try:
        got = _np(_grads(lambda a, c: plan(a, c).to_local(
            grad_placements=(Replicate(), Replicate())), (x, k)))
    finally:
        stages.output_block = real
    assert seen == [(Replicate(), Replicate())]
    for a, c in zip(got, want):
        np.testing.assert_array_equal(a, c)
    # a DTensor on another mesh is refused
    other = tmesh.make_mesh((1, 1), ("dp", "mp"), device_type="cpu")
    dy = DTensor.from_local(torch.zeros(plan.out_shape), other,
                            (Shard(0), Shard(1)))
    with pytest.raises(ValueError, match="placed"):
        stages.output_block(plan, dy, stages._shard(plan))


def test_transposed_plan_keeps_the_mesh_knobs(mesh):
    """The dx plan runs on the forward's mesh, axes and schedule, with
    the same slabs, replicated kernel transform and pinned CGEMM row."""
    plan = tconv.plan_conv((4, 3, 12, 12), (5, 3, 3, 3), padding=1,
                           backend="fft-cuda", schedule="nfft", mesh=mesh,
                           overlap="slab:2", replicate_kernel_transform=True)
    dx = autodiff._transposed_plan(plan)
    assert dx.mesh is plan.mesh and dx.schedule == "nfft"
    assert (dx.data_axis, dx.model_axis) == ("data", "model")
    assert dx.overlap == "slab:2" and dx.replicate_kernel_transform
    assert (dx.bm, dx.bn, dx.bk) == (plan.bm, plan.bn, plan.bk)
    assert (dx.x_shape, dx.k_shape) == ((4, 5, 12, 12), (3, 5, 3, 3))
    other = tmesh.make_mesh((1, 1), ("dp", "mp"), device_type="cpu")
    p = tconv.plan_conv((4, 3, 12, 12), (5, 3, 3, 3), padding=1,
                        schedule="wfft", mesh=other, data_axis="dp",
                        model_axis="mp")
    dx = autodiff._transposed_plan(p)
    assert (dx.mesh, dx.data_axis, dx.model_axis, dx.schedule) == (
        other, "dp", "mp", "wfft")


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_conv_block_chain_with_pool_trains_on_the_mesh(mesh, jmesh,
                                                       schedule):
    """Two fused conv_blocks and a maxpool2x2 on the mesh, the DTensor of
    each feeding the next: every grad against the port's local chain, and
    within 1e-4 of max|g| of the same chain in JAX on its (1, 1) mesh
    (scaled: the chain's grads sum many products, and their entries span
    orders of magnitude)."""
    x = _rand((2, 3, 16, 16), 21)
    k1, b1 = _rand((4, 3, 3, 3), 22), _rand((4,), 23)
    k2, b2 = _rand((6, 4, 3, 3), 24), _rand((6,), 25)

    def chain(L, **kw):
        def f(x, k1, b1, k2, b2):
            h = L.conv_block(x, k1, b1, activation="relu", **kw)
            h = L.maxpool2x2(h)
            return L.conv_block(h, k2, b2, activation="relu", **kw)
        return f
    arrays = (x, k1, b1, k2, b2)
    names = ("dx", "dk1", "d_bias1", "dk2", "d_bias2")
    g = _grads(chain(tlayers, backend="fft-cuda", schedule=schedule,
                     mesh=mesh), arrays)
    assert all(type(a) is torch.Tensor for a in g)
    g = _np(g)
    _close(g, _np(_grads(chain(tlayers, backend="fft-cuda"), arrays)),
           names, JAX_TOL)
    theirs = _jgrads(chain(jlayers, backend="fft-xla", schedule=schedule,
                           mesh=jmesh), arrays)
    for a, b, name in zip(g, theirs, names):
        assert _scaled(a, b) <= SPAWN_JAX_TOL, name


@pytest.mark.parametrize("prepared", [False, True])
def test_a_backward_in_another_thread_counts_in_the_forwards_trace(
        mesh, prepared):
    """Autograd runs the backward pass of CUDA tensors in a thread of its
    own: its stage ops and collectives count in the traces that were
    active at the forward and still are, and in no closed one."""
    import threading
    x, k = _rand((2, 3, 12, 12), 29), _rand((4, 3, 3, 3), 30)
    plan = tconv.plan_conv(x.shape, k.shape, padding=1, schedule="nfft",
                           mesh=mesh)
    run = plan.prepare(torch.from_numpy(k)) if prepared \
        else (lambda a: plan(a, torch.from_numpy(k)))

    def step(backward):
        xt = torch.from_numpy(x).requires_grad_()
        with tconv.stage_trace() as c:
            loss = run(xt).full_tensor().sum()
            n_forward = c["cgemm"]
            backward(loss)
        return c, n_forward
    same, _ = step(lambda loss: loss.backward())

    def in_thread(loss):
        t = threading.Thread(target=loss.backward)
        t.start()
        t.join()
    other, n_forward = step(in_thread)
    assert other == same and other["cgemm"] == 2 * n_forward
    assert other[("collective", "grad_all_gather")] == 0   # no dk, d_bias
    xt = torch.from_numpy(x).requires_grad_()
    with tconv.stage_trace() as closed:
        loss = run(xt).full_tensor().sum()
    before = dict(closed)
    in_thread(loss)
    assert dict(closed) == before


def _jax_grad_counts(f, arrays):
    with jstages.stage_trace() as c:
        jax.make_jaxpr(jax.grad(lambda *a: jnp.sum(jnp.sin(f(*a))),
                                argnums=tuple(range(len(arrays)))))(
            *map(jnp.asarray, arrays))
    return dict(c)


@pytest.mark.parametrize("schedule,replicate", [
    ("nfft", False), ("nfft", True), ("wfft", False)])
@pytest.mark.parametrize("overlap", ["off", "slab:2"])
@pytest.mark.parametrize("prepared", [False, True])
def test_forward_and_backward_stage_counts_match_jax(
        mesh, jmesh, schedule, replicate, overlap, prepared):
    """The stage ops of a forward and its backward against the JAX
    package's trace of ``jax.grad``; the pipelines' collectives (nfft:
    ``2k`` boundary all-to-alls a plan, one more for a one-shot kernel
    transform that is not replicated, never an all-reduce; wfft: ``k``
    all-reduces a plan, no all-to-all) and the dk and d_bias reductions
    under kinds of their own."""
    x, k = _rand((5, 3, 12, 12), 26), _rand((4, 3, 3, 3), 27)
    b = _rand((4,), 28)
    ep = dict(bias=True, activation="relu")
    kw = dict(padding=1, schedule=schedule, overlap=overlap,
              replicate_kernel_transform=replicate)
    plan = tconv.plan_conv(x.shape, k.shape, backend="fft-cuda", mesh=mesh,
                           epilogue=tconv.Epilogue(**ep), **kw)
    jplan = jconv.plan_conv(x.shape, k.shape, backend="fft-xla",
                            mesh=jmesh, epilogue=jconv.Epilogue(**ep), **kw)
    if prepared:
        run, jrun = plan.prepare(torch.from_numpy(k)), \
            jplan.prepare(jnp.asarray(k))
        f, jf = (lambda a, d: run(a, bias=d)), (lambda a, d: jrun(a, bias=d))
        arrays = (x, b)
    else:
        f = lambda a, c, d: plan(a, c, bias=d)          # noqa: E731
        jf = lambda a, c, d: jplan(a, c, bias=d)        # noqa: E731
        arrays = (x, k, b)
    with tconv.stage_trace() as c:
        _grads(f, arrays)
    assert _counts(c) == _jax_grad_counts(jf, arrays)
    slabs = plan.num_slabs
    if schedule == "nfft":
        # the forward's a2a #2 unless prepared or replicated; the dx
        # plan's, one-shot, unless replicated
        a2a = 4 * slabs + (not prepared and not replicate) + (not replicate)
        assert c["boundary_a2a"] == c[("collective", "all_to_all")] == a2a
        assert ("collective", "all_reduce") not in c
    else:
        assert c[("collective", "all_reduce")] == 2 * slabs
        assert ("collective", "all_to_all") not in c
    # d_bias: one all-reduce over data, one all-gather over model; dk (a
    # plain x: its batch block, nothing gathered) the same again; dx of
    # the plain x gathered whole once
    grads = 1 + (not prepared)
    assert c[("collective", "grad_all_reduce")] == grads
    assert c[("collective", "grad_all_gather")] == grads
    assert c[("collective_bytes", "grad_all_reduce")] == 4 * (
        4 + (0 if prepared else k.size))
    assert c[("collective", "grad_full")] == 1
    assert c[("collective_bytes", "grad_full")] == 4 * x.size


# --------------------------------------------------------------------------
# (b) Spawned gloo groups at meshes (1, 2), (2, 2), (1, 4), (2, 4) vs JAX
# --------------------------------------------------------------------------

_GKINDS = {
    # uneven shards: B=3, C=3, C'=5 padded to the mesh axes' multiples
    "odd": dict(x=(3, 3, 12, 12), k=(5, 3, 3, 3)),
    "slab2": dict(x=(5, 4, 12, 12), k=(4, 4, 3, 3), overlap="slab:2"),
    # DTensor x and residual; C > C', so at (1, 2) dk gathers dz over
    # model, at (1, 4) x
    "epilogue": dict(x=(3, 8, 12, 12), k=(5, 8, 3, 3), bias=True,
                     act="relu", residual=True, placed=["x", "residual"]),
    "prepared": dict(x=(5, 4, 12, 12), k=(6, 4, 3, 3), prepared=True,
                     bias=True, act="gelu", overlap="slab:2",
                     placed=["x"]),
}
_GMESHES = {(1, 2): tuple(_GKINDS), (2, 2): ("odd", "slab2", "epilogue"),
            (1, 4): ("odd", "epilogue", "prepared")}
GCASES = []
for _m, _kinds in _GMESHES.items():
    _tag = "x".join(map(str, _m))
    for _s in SCHEDULES:
        GCASES += [dict(name=f"{_tag}-{_s}-{kind}", mesh=list(_m),
                        schedule=_s, seed=i, **_GKINDS[kind])
                   for i, kind in enumerate(_kinds)]
GCASES.append(dict(name="1x2-nfft-odd-replicate", mesh=[1, 2],
                   schedule="nfft", seed=5, replicate=True,
                   **_GKINDS["odd"]))
# the twin of test_sharded_grads_multi_device: eight ranks
GCASES += [dict(name=f"2x4-{s}-layer", mesh=[2, 4], schedule=s, seed=0,
                x=(4, 8, 28, 28), k=(8, 8, 3, 3)) for s in SCHEDULES]

# Grads of sum(sin(y)) of one case, through ``L.grads``: operands in the
# order x, k (one-shot only), bias, residual; ``L.grads`` places the named
# ones as DTensors (the port on a mesh) and gives each grad and its kind.
_GRAD_RUNNER = _RUNNER + r'''

def run_grads(L, c, mesh, backend):
    _, x, ks, bs, r = inputs(c)
    kw = dict(backend=backend)
    if mesh is not None:
        kw.update(mesh=mesh, schedule=c["schedule"],
                  overlap=c.get("overlap", "off"),
                  replicate_kernel_transform=c.get("replicate", False))
    ep = L.Epilogue(bias=c.get("bias", False),
                    activation=c.get("act", "none"),
                    residual=c.get("residual", False))
    plan = L.plan_conv(tuple(x.shape), tuple(ks[0].shape), padding=1,
                       epilogue=ep, **kw)
    names = ["bias"] * ep.bias + ["residual"] * ep.residual
    ops = [bs[0]] * ep.bias + [r] * ep.residual
    if c.get("prepared"):
        prepared = plan.prepare(L.array(ks[0]))
        f = lambda x, *o: prepared(x, **dict(zip(names, o)))
        args, arrays = ["x"] + names, [x] + ops
    else:
        f = lambda x, k, *o: plan(x, k, **dict(zip(names, o)))
        args, arrays = ["x", "k"] + names, [x, ks[0]] + ops
    placed = [i for i, a in enumerate(args)
              if mesh is not None and a in c.get("placed", ())]
    return args, L.grads(f, arrays, mesh, placed)
'''

_TORCH_GRAD_LIB = _TORCH_LIB + r'''
from torch.distributed.tensor import DTensor, Shard, distribute_tensor

def _grads(f, arrays, mesh, placed):
    ts = [(distribute_tensor(torch.from_numpy(a), mesh, (Shard(0), Shard(1)))
           if i in placed else torch.from_numpy(a)).requires_grad_()
          for i, a in enumerate(arrays)]
    y = f(*ts)
    if isinstance(y, DTensor):
        y = y.full_tensor()
    torch.sin(y).sum().backward()
    out = []
    for t in ts:
        g = t.grad
        kind = ([f"Shard({p.dim})" if p.is_shard() else type(p).__name__
                 for p in g.placements] if isinstance(g, DTensor)
                else type(g).__name__)
        out.append(((g.full_tensor() if isinstance(g, DTensor) else g)
                    .numpy(), kind))
    return out
L.grads = _grads
'''

_TORCH_GRAD_RANK = _TORCH_GRAD_LIB + _GRAD_RUNNER + r'''
import json, math, os
from repro_torch.launch import mesh as M
rank, world = int(os.environ["RANK"]), int(os.environ["WORLD"])
M.start_process_group("gloo", rank=rank, world_size=world,
                      store_path=os.environ["STORE"])
out, meta, meshes = {}, {}, {}
for c in json.load(open(os.environ["CASES"])):
    if math.prod(c["mesh"]) != world:
        continue
    key = tuple(c["mesh"])
    if key not in meshes:
        meshes[key] = M.make_host_mesh(*key)
    with C.stage_trace() as n:
        args, grads = run_grads(L, c, meshes[key], c["backend"])
    for a, (g, _) in zip(args, grads):
        out[f"{c['name']}/{a}"] = g
    meta[c["name"]] = dict(
        kinds={a: kind for a, (_, kind) in zip(args, grads)},
        counts={k[1]: v for k, v in n.items()
                if isinstance(k, tuple) and k[0] == "collective"})
np.savez(os.environ["OUT"], meta=json.dumps(meta), **out)
M.destroy_process_group()
'''

_JAX_GRAD = r'''
import json, os
from repro.launch import env
env.apply(8)
import jax, jax.numpy as jnp
import repro.conv as C
from repro.compat import make_mesh
from repro.models.layers import maxpool2x2
import types

def _grads(f, arrays, mesh, placed):
    g = jax.jit(jax.grad(lambda *a: jnp.sum(jnp.sin(f(*a))),
                         argnums=tuple(range(len(arrays)))))
    return [(np.asarray(a, np.float32), "jax")
            for a in g(*map(jnp.asarray, arrays))]
L = types.SimpleNamespace(
    plan_conv=C.plan_conv, plan_network=C.plan_network,
    NetworkConv=C.NetworkConv, Epilogue=C.Epilogue, maxpool2x2=maxpool2x2,
    array=jnp.asarray, bf16=jnp.bfloat16, jit=jax.jit, grads=_grads)
''' + _GRAD_RUNNER + r'''
meshes, out = {}, {}
for c in json.load(open(os.environ["CASES"])):
    key = tuple(c["mesh"])
    if (key in ((1, 2), (2, 4))) != (os.environ["PART"] == "a"):
        continue
    if key not in meshes:
        meshes[key] = make_mesh(key, ("data", "model"))
    args, grads = run_grads(L, c, meshes[key], "fft-xla")
    out.update({f"{c['name']}/{a}": g for a, (g, _) in zip(args, grads)})
np.savez(os.environ["OUT"], **out)
'''

_WORLDS = (2, 4, 8)


def _grad_oracle(c):
    scope = {}
    exec(_TORCH_GRAD_LIB + _GRAD_RUNNER, scope)
    args, grads = scope["run_grads"](scope["L"], c, None, "direct")
    return {a: g for a, (g, _) in zip(args, grads)}


@pytest.fixture(scope="module")
def spawned_grads(tmp_path_factory):
    """Run every grad case once: the port in a 2-, a 4- and an 8-rank
    gloo world (fft-torch and fft-cuda on alternate cases), each rank
    writing its own grads; JAX fft-xla in two processes with eight host
    devices each ((1, 2) and (2, 4), the rest); all concurrently."""
    tmp = tmp_path_factory.mktemp("sharded_grad")
    cases = [dict(c, backend=TWINS[i % 2][0]) for i, c in enumerate(GCASES)]
    (tmp / "cases.json").write_text(json.dumps(cases))
    base = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                CASES=str(tmp / "cases.json"), OMP_NUM_THREADS="1")
    base.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen(
        [sys.executable, "-c", _JAX_GRAD],
        env=dict(base, PART=part, OUT=str(tmp / f"jax{part}.npz")),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for part in ("a", "b")]
    for world in _WORLDS:
        for rank in range(world):
            procs.append(subprocess.Popen(
                [sys.executable, "-c", _TORCH_GRAD_RANK],
                env=dict(base, RANK=str(rank), WORLD=str(world),
                         STORE=str(tmp / f"store{world}"),
                         OUT=str(tmp / f"torch{world}_{rank}.npz")),
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    failed = [log[-3000:] for p, log in zip(procs, logs) if p.returncode]
    assert not failed, "\n\n".join(failed)
    ranks, meta = {}, {}
    for world in _WORLDS:
        ranks[world] = []
        for rank in range(world):
            with np.load(tmp / f"torch{world}_{rank}.npz") as z:
                ranks[world].append({k: z[k] for k in z.files
                                     if k != "meta"})
                meta.setdefault(world, json.loads(str(z["meta"])))
    theirs = {}
    for part in ("a", "b"):
        with np.load(tmp / f"jax{part}.npz") as z:
            theirs.update({k: z[k] for k in z.files})
    return {c["name"]: c for c in cases}, ranks, meta, theirs


@pytest.mark.parametrize("name", [c["name"] for c in GCASES])
def test_spawned_mesh_grads_match_jax_and_oracle(spawned_grads, name):
    cases, ranks, meta, theirs = spawned_grads
    c = cases[name]
    world = int(np.prod(c["mesh"]))
    ours, info = ranks[world], meta[world][name]
    oracle = _grad_oracle(c)
    for a, g0 in oracle.items():
        g = ours[0][f"{name}/{a}"]
        assert g.shape == g0.shape, a
        assert _scaled(g, theirs[f"{name}/{a}"]) <= SPAWN_JAX_TOL, a
        assert _scaled(g, g0) <= SPAWN_ORACLE_TOL, a
        if a in ("k", "bias"):
            # one plain tensor, equal on every rank bit for bit
            for other in ours[1:]:
                np.testing.assert_array_equal(other[f"{name}/{a}"], g,
                                              err_msg=a)
        # a plain operand's grad is plain; a DTensor's is placed like it
        want = (["Shard(0)", "Shard(1)"]
                if a in c.get("placed", ()) else "Tensor")
        assert info["kinds"][a] == want, a
    counts = info["counts"]
    # nfft's pipelines issue no all-reduce, wfft's no all-to-all; the dk
    # and d_bias reductions come under their own kinds
    assert counts.get("all_reduce" if c["schedule"] == "nfft"
                      else "all_to_all", 0) == 0
    assert counts["grad_all_reduce"] == ("k" in oracle) + ("bias" in oracle)
    # dx and d_residual of a plain operand are gathered whole, counted
    assert counts.get("grad_full", 0) == sum(
        a in oracle and a not in c.get("placed", ())
        for a in ("x", "residual"))
