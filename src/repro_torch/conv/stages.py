"""Composable stage graph for the FFT-convolution engine.

The paper's pipeline is four stage *ops* —

  1. input transform    I (B,C,H,W)    -> D (P, M, C)
  2. kernel transform   K (C',C,kh,kw) -> G (P, C, C')
  3. CGEMM              Z[p] = D[p] @ G[p]            (hot stage)
  4. output inverse     Z (P, M, C')   -> O (B,C',Ho,Wo)

— and a *schedule* is a composition of those ops with data movement in
between: ``local`` runs them back-to-back on one device, ``nfft`` places an
all-to-all at each stage boundary (the paper's NUMA-aware tuple
partitioning), ``wfft`` leaves the contraction axis sharded and pays an
all-reduce inside stage 3.  This module defines the stage ops once (thin,
counted wrappers over ``repro_torch.core.fftconv``) plus one pipeline
class per schedule.  The sharded pipelines run SPMD over the ranks of a
``torch.distributed`` ``DeviceMesh`` (``repro_torch.launch.mesh``): each
rank computes its own block, and the collectives run on the mesh's
``model`` group.

Every pipeline accepts a plan-frozen ``Epilogue`` (bias add, activation,
residual add — see ``repro_torch.conv.epilogue``) executed *inside* stage 4,
in float32, before the cast to the output dtype; the sharded pipelines run
it on each rank's C'/N output slab with the operands taken in blocks
(zero extra collectives).  Backends may hand the pipeline tile kernels
for the compact ``real`` layout (the CUDA ``dft_tile`` kernels):
``tile_rfft`` for the tile transforms of stages 1 and 2, ``tile_irfft``
for an unfused stage 4, a fused ``inverse_fn`` that runs the bias and
activation inside the inverse transform, and ``image_rfft``, stage 1 in
one kernel pass from the image to the (P, M, C) spectra (no tile copy, no
permute; ``fftconv.input_transform`` says where it applies, and
``tile_rfft`` runs stage 1 elsewhere).  The stage ops also take the
``rect`` layout's kernels, ``tile_fft`` and ``tile_ifft``, for direct
callers of that layout (no plan uses it).

Every pipeline exposes the prepare/execute split:

  ``prepare(plan, k)``    run stage 2 once, returning the transformed kernel
                          ``G`` in the layout execution consumes — for
                          ``nfft`` the rank's post-boundary P/N slab, so
                          prepared execution runs stage 2 AND boundary
                          all-to-all #2 zero times;
  ``execute(plan, x, G)`` run stages 1/3/4 (+ the remaining collectives)
                          against a prepared ``G``;
  ``full(plan, x, k)``    the one-shot path: stage 2 inline.

Stage-op invocations are counted when they run, through the thread-local
context manager (``repro_torch.core.trace``, re-exported here)::

    with stage_trace() as counts:
        plan(x, k)
    assert counts["cgemm"] == 1

Each ``cgemm`` call also records dtype and shape facts as
``("cgemm_dtype", <dtype>)`` and ``("cgemm_shape", (M, N, K))`` tuple keys
beside the plain string op counts.  Each nfft boundary all-to-all counts
one ``boundary_a2a`` (the real and imaginary planes travel in one
buffer), and every collective records its kind and the bytes this rank
sends as ``("collective", kind)`` and ``("collective_bytes", kind)``,
``kind`` being ``"all_to_all"`` or ``"all_reduce"``.  The plan-level VJP
of the sharded schedules counts the collectives of its dk and d_bias
reductions under kinds of their own, ``"grad_all_reduce"`` and
``"grad_all_gather"`` (``grad_kernel``, ``grad_bias``), and the gather
of dx or d_residual into the global tensor for a plain operand as
``"grad_full"`` (``grad_full``); the serving engine's gather of a
network's output into a plain tensor counts as ``"output_gather"``
(``output_full``).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any

import torch
import torch.distributed as dist
import torch.nn.functional as TF

from repro_torch.core.conv_spec import ConvSpec
from repro_torch.core import fftconv as F
from repro_torch.core.cgemm import cgemm
from repro_torch.core.trace import (  # noqa: F401  (re-exported)
    _count, _tls, active_traces, counted_in, isolated_trace, span,
    stage_trace)
from repro_torch.conv.epilogue import Epilogue, apply_epilogue


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")        # "float32", "bfloat16"


# --------------------------------------------------------------------------
# Stage ops (counted)
# --------------------------------------------------------------------------

def stage_input_transform(x, spec: ConvSpec, spectrum: str = "rect",
                          tile_rfft=None, tile_fft=None, image_rfft=None):
    _count("input_transform")
    with span("stage/input"):
        return F.input_transform(x, spec, spectrum=spectrum,
                                 tile_rfft=tile_rfft, tile_fft=tile_fft,
                                 image_rfft=image_rfft)


def stage_kernel_transform(k, spec: ConvSpec, spectrum: str = "rect",
                           tile_rfft=None, tile_fft=None):
    _count("kernel_transform")
    with span("stage/kernel"):
        return F.kernel_transform(k, spec, spectrum=spectrum,
                                  tile_rfft=tile_rfft, tile_fft=tile_fft)


def stage_cgemm(Dr, Di, Gr, Gi, *, three_m: bool, cgemm_fn=None):
    _count("cgemm")
    # which dtype the hot stage actually consumed
    _count(("cgemm_dtype",
            _dtype_name(torch.promote_types(Dr.dtype, Gr.dtype))))
    # (M, N, K) of this invocation
    _count(("cgemm_shape",
            (int(Dr.shape[-2]), int(Gr.shape[-1]), int(Dr.shape[-1]))))
    mm = cgemm_fn if cgemm_fn is not None else functools.partial(
        cgemm, three_m=three_m)
    with span("stage/cgemm"):
        return mm(Dr, Di, Gr, Gi)


def stage_output_inverse(Zr, Zi, spec: ConvSpec, *, epilogue: Epilogue = None,
                         bias=None, residual=None, inverse_fn=None,
                         tile_irfft=None, tile_ifft=None,
                         spectrum: str = "rect"):
    """Stage 4 with the fused elementwise epilogue.

    The epilogue rides inside this single stage op (the counter increments
    once, fused or not).  ``inverse_fn`` is a backend-supplied fused
    inverse+epilogue kernel ``(Zr, Zi, spec, epilogue, bias) -> y`` matched
    to the plan's spectrum layout; it cannot fold a residual — the residual
    lives in output layout, not tile layout — so residual and no-op
    epilogues take the composed path: the inverse (through the
    ``tile_irfft`` or ``tile_ifft`` kernel when the caller gives one), then
    the epilogue.
    """
    _count("output_inverse")
    with span("stage/inverse"):
        if (inverse_fn is not None and epilogue is not None
                and not epilogue.is_noop and not epilogue.residual):
            return inverse_fn(Zr, Zi, spec, epilogue, bias)
        y = F.output_inverse(Zr, Zi, spec, spectrum=spectrum,
                             tile_irfft=tile_irfft, tile_ifft=tile_ifft)
        return apply_epilogue(y, epilogue, bias=bias, residual=residual)


def _maybe_cast(pair, dtype):
    if dtype is None:
        return pair
    return pair[0].to(dtype), pair[1].to(dtype)


# --------------------------------------------------------------------------
# local schedule
# --------------------------------------------------------------------------

class LocalPipeline:
    """Single device: stages back-to-back, no collectives.  The epilogue is
    fused into stage 4; ``inverse_fn`` (CUDA backend) fuses it into the
    tile-inverse kernel tail itself.  ``tile_rfft`` / ``tile_irfft``
    (CUDA backend) run the tile transforms of stages 1, 2 and the unfused
    stage 4, and ``image_rfft`` stage 1 in one pass where it applies."""

    def __init__(self, cgemm_fn=None, inverse_fn=None, tile_rfft=None,
                 tile_irfft=None, image_rfft=None):
        self.cgemm_fn = cgemm_fn
        self.inverse_fn = inverse_fn
        self.tile_rfft = tile_rfft
        self.tile_irfft = tile_irfft
        self.image_rfft = image_rfft

    def prepare(self, plan, k):
        return stage_kernel_transform(k, plan.spec, plan.spectrum,
                                      self.tile_rfft)

    def execute(self, plan, x, G, bias=None, residual=None):
        spec = plan.spec
        Dr, Di = stage_input_transform(x, spec, plan.spectrum,
                                       self.tile_rfft,
                                       image_rfft=self.image_rfft)
        Gr, Gi = G
        Dr, Di = _maybe_cast((Dr, Di), plan.compute_dtype)
        Gr, Gi = _maybe_cast((Gr, Gi), plan.compute_dtype)
        Zr, Zi = stage_cgemm(Dr, Di, Gr, Gi, three_m=plan.three_m,
                             cgemm_fn=self.cgemm_fn)
        Zr, Zi = Zr.float(), Zi.float()
        y = stage_output_inverse(Zr, Zi, spec, epilogue=plan.epilogue,
                                 bias=bias, residual=residual,
                                 inverse_fn=self.inverse_fn,
                                 tile_irfft=self.tile_irfft,
                                 spectrum=plan.spectrum)
        return y.to(x.dtype)

    def full(self, plan, x, k, bias=None, residual=None):
        return self.execute(plan, x, self.prepare(plan, k), bias=bias,
                            residual=residual)


# --------------------------------------------------------------------------
# Collectives (counted).  The real and imaginary planes travel stacked in
# one buffer; every collective is issued with ``async_op=True`` and waited
# for before its data is used, in the same order on every rank.
# --------------------------------------------------------------------------

def _record(kind: str, buf) -> None:
    _count(("collective", kind))
    _count(("collective_bytes", kind), buf.numel() * buf.element_size())


def _boundary_a2a(T, group, split: int, concat: int, n: int):
    """Issue one nfft stage-boundary all-to-all on the stacked planes
    ``T`` (2, a, b, c), counted once: axis ``split`` of a plane is cut
    into ``n`` blocks, block j going to rank j of ``group``, and
    ``_a2a_result`` concatenates the blocks received along axis
    ``concat`` in rank order (the twin of ``jax.lax.all_to_all(...,
    split, concat, tiled=True)``; ``all_to_all_single`` splits dim 0
    only, so the split axis is moved first).  Returns the pending
    collective."""
    _count("boundary_a2a")
    s = split + 1
    shape = list(T.shape)
    shape[s:s + 1] = [n, shape[s] // n]
    send = T.reshape(shape).movedim(s, 0).contiguous()   # (n, 2, ...)
    recv = torch.empty_like(send)
    _record("all_to_all", send)
    work = dist.all_to_all_single(recv, send, group=group, async_op=True)
    return work, recv, concat


def _a2a_result(pending):
    """Wait for an issued boundary all-to-all: the blocks received,
    concatenated in rank order, as stacked planes (2, ...)."""
    work, recv, concat = pending
    work.wait()
    c = concat + 1
    shape = list(recv.shape[1:])
    shape[c] *= recv.shape[0]
    # a view when the concat axis has one element: the kernels want it
    # contiguous
    return recv.movedim(0, c).reshape(shape).contiguous()


def _all_reduce(T, group):
    """Issue the wfft hot-stage all-reduce (sum) of the stacked planes
    ``T``, in place.  Returns the pending collective."""
    _record("all_reduce", T)
    return dist.all_reduce(T, group=group, async_op=True), T


# --------------------------------------------------------------------------
# Shared helpers of the sharded schedules
# --------------------------------------------------------------------------

def axis_size(mesh, name: str) -> int:
    """Size of the mesh dim called ``name``."""
    return mesh.size(mesh.mesh_dim_names.index(name))


def _pad_axis(x, axis, mult):
    rem = (-x.shape[axis]) % mult
    if rem == 0:
        return x
    return TF.pad(x, [0, 0] * (x.ndim - axis - 1) + [0, rem])


def _local_spec(spec: ConvSpec, b_loc: int, c_loc: int, co_loc: int):
    return ConvSpec(B=b_loc, C=c_loc, Cout=co_loc, H=spec.H, W=spec.W,
                    kh=spec.kh, kw=spec.kw, pad_h=spec.pad_h,
                    pad_w=spec.pad_w, delta=spec.delta)


def round_up(n: int, mult: int) -> int:
    """``n`` zero-padded up to a multiple of ``mult``."""
    return n + (-n) % mult


def padded_sharded_spec(plan) -> ConvSpec:
    """The ConvSpec of the mesh-padded problem the sharded pipelines see.

    Channel/batch axes are zero-padded up to mesh-axis multiples (e.g. VGG
    conv1.1's C=3); padded channels multiply zeros and are sliced away.
    """
    s = plan.spec
    n_data = axis_size(plan.mesh, plan.data_axis)
    n_model = axis_size(plan.mesh, plan.model_axis)
    return ConvSpec(
        B=round_up(s.B, n_data), C=round_up(s.C, n_model),
        Cout=round_up(s.Cout, n_model), H=s.H, W=s.W, kh=s.kh, kw=s.kw,
        pad_h=s.pad_h, pad_w=s.pad_w, delta=s.delta)


def _pack(pair, n: int, dtype=None):
    """The (re, im) pair as one buffer (2, P', ...) in ``dtype`` (cast
    BEFORE the collective, so a bf16 plan moves half the bytes), the
    leading axis zero-padded to a multiple of ``n``: the tiled all-to-all
    splits the frequency axis n ways, and the padded rows flow inertly
    through the CGEMM to stage 4, which drops them."""
    a, b = pair
    P = a.shape[0]
    with span("copy/pack"):
        out = a.new_empty((2, P + (-P) % n) + tuple(a.shape[1:]),
                          dtype=dtype or a.dtype)
        out[0, :P] = a
        out[1, :P] = b
        out[:, P:] = 0
    return out


def _slab_sizes(n: int, k: int) -> tuple:
    """Batch sub-slab sizes for overlapped execution: ``k`` slabs
    covering ``n`` rows, the remainder spread over the leading slabs so
    sizes differ by at most one (k is clamped to n — never an empty
    slab)."""
    k = max(1, min(int(k), int(n)))
    base, rem = divmod(int(n), k)
    return tuple(base + (1 if i < rem else 0) for i in range(k))


def _slab_splits(x, sizes, axis=0):
    """``x`` cut into sub-slabs of the given sizes along ``axis``
    (views); ``None`` stays ``None`` for every slab."""
    if x is None:
        return [None] * len(sizes)
    return list(torch.split(x, list(sizes), dim=axis))


@dataclasses.dataclass(frozen=True)
class _Shard:
    """This rank's place on a plan's mesh."""
    n_data: int
    n_model: int
    d: int                       # rank along the data axis
    m: int                       # rank along the model axis
    group: Any                   # the model axis' process group


def _shard(plan) -> _Shard:
    mesh = plan.mesh
    return _Shard(axis_size(mesh, plan.data_axis),
                  axis_size(mesh, plan.model_axis),
                  mesh.get_local_rank(plan.data_axis),
                  mesh.get_local_rank(plan.model_axis),
                  mesh.get_group(plan.model_axis))


def _block_cuts(sh: _Shard) -> tuple:
    """The ``_take`` cuts of this rank's (batch, channel) block of an
    input- or output-shaped operand."""
    return ((0, sh.n_data, sh.d), (1, sh.n_model, sh.m))


def _placements(plan) -> tuple:
    """The output's placements: B over the data axis, C' over the model
    axis, replicated over any other mesh dim."""
    from torch.distributed.tensor import Replicate, Shard
    return tuple(Shard(0) if a == plan.data_axis
                 else Shard(1) if a == plan.model_axis else Replicate()
                 for a in plan.mesh.mesh_dim_names)


def _take(t, cuts):
    """This rank's block of a global tensor: for each (dim, n, i) of
    ``cuts`` the dim zero-padded to a multiple of n and the i-th of n
    even slices taken (the reference's ``in_specs`` on the padded
    operand)."""
    for dim, n, i in cuts:
        t = _pad_axis(t, dim, n)
        b = t.shape[dim] // n
        t = t.narrow(dim, i * b, b)
    return t


def _local_block(plan, t, cuts):
    """``_take`` of a global tensor, or the local block of a ``DTensor``
    placed as the plan's output (its shards are ``torch.chunk``'s, which
    are the padded even blocks cut to the true size), padded back to the
    block size."""
    from torch.distributed.tensor import DTensor
    if not isinstance(t, DTensor):
        return _take(t, cuts)
    if t.device_mesh != plan.mesh or tuple(t.placements) \
            != _placements(plan):
        raise ValueError(
            f"a DTensor operand must lie on the plan's mesh placed "
            f"{_placements(plan)}, got {tuple(t.placements)} on "
            f"{t.device_mesh}")
    full = t.shape
    t = t.to_local()
    for dim, n, _ in cuts:
        rem = -(-full[dim] // n) - t.shape[dim]
        if rem:
            t = TF.pad(t, [0, 0] * (t.ndim - dim - 1) + [0, rem])
    return t


def _epilogue_operands(plan, sh: _Shard, bias, residual):
    """Each rank's blocks of the epilogue operands: the bias' C'/N block
    and the residual's block, laid out like the output — exactly what the
    rank's stage-4 slab needs, so the epilogue costs no collective."""
    if bias is not None:
        bias = _take(bias, ((0, sh.n_model, sh.m),))
    if residual is not None:
        residual = _local_block(plan, residual, _block_cuts(sh))
    return bias, residual


def _global_output(plan, y, sh: _Shard, dtype):
    """The rank's padded output block cut to the true size, as a
    ``DTensor`` of the unpadded global shape placed ``_placements``; its
    ``full_tensor()`` is the reference's ``y``."""
    from torch.distributed.tensor import DTensor
    s = plan.spec
    b, co = y.shape[:2]
    y = y[:max(0, min(b, s.B - sh.d * b)),
          :max(0, min(co, s.Cout - sh.m * co))]
    B, Co, Ho, Wo = plan.out_shape
    return DTensor.from_local(
        y.to(dtype).contiguous(), plan.mesh, _placements(plan),
        run_check=False, shape=torch.Size((B, Co, Ho, Wo)),
        stride=(Co * Ho * Wo, Ho * Wo, Wo, 1))


# --------------------------------------------------------------------------
# What the plan-level VJP of the sharded schedules needs: each rank's
# blocks of the output-shaped cotangents, and the counted reductions that
# turn each rank's share of dk and d_bias into one plain tensor, equal on
# every rank.  The reductions are blocking: each one's result is the next
# one's input.
# --------------------------------------------------------------------------

def output_block(plan, t, sh: _Shard):
    """This rank's block of an output-shaped operand (B over the data
    axis, C' over the model axis), zero-padded to the block size: a
    ``DTensor`` placed any other way on the plan's mesh (a loss taken
    after a ``redistribute`` hands back such a cotangent) is redistributed
    to the output's placements first; a plain global tensor is cut."""
    from torch.distributed.tensor import DTensor
    if isinstance(t, DTensor) and tuple(t.placements) != _placements(plan):
        t = t.redistribute(plan.mesh, _placements(plan))
    return _local_block(plan, t, _block_cuts(sh))


def on_local(fn, t):
    """``fn`` of a ``DTensor``'s local block, as a ``DTensor`` of the same
    global shape and placements (``fn`` keeps the shape: an elementwise
    op); ``fn(t)`` of a plain tensor."""
    from torch.distributed.tensor import DTensor
    if not isinstance(t, DTensor):
        return fn(t)
    return DTensor.from_local(fn(t.to_local()), t.device_mesh, t.placements,
                              run_check=False, shape=t.shape,
                              stride=t.stride())


def _grad_all_reduce(t, group):
    """Sum of ``t`` over ``group``, in place."""
    _record("grad_all_reduce", t)
    dist.all_reduce(t, group=group)
    return t


def _grad_all_gather(t, group, n: int, dim: int):
    """The ``n`` ranks' blocks ``t`` of ``group`` concatenated along
    ``dim`` in rank order."""
    t = t.contiguous()
    out = [torch.empty_like(t) for _ in range(n)]
    _record("grad_all_gather", t)
    dist.all_gather(out, t, group=group)
    return torch.cat(out, dim=dim)


def output_full(y):
    """The global tensor of a sharded network's ``DTensor`` output
    (``full_tensor()``: an all-gather over the mesh), as the serving
    engine hands it out; counted as ``output_gather`` with the bytes of
    this rank's block.  A plain tensor is returned as it is."""
    from torch.distributed.tensor import DTensor
    if not isinstance(y, DTensor):
        return y
    _record("output_gather", y.to_local())
    return y.full_tensor()


def grad_full(t):
    """The global tensor of the ``DTensor`` grad ``t`` (``full_tensor()``:
    an all-gather over the mesh), the grad of an operand that came in
    plain; counted with the bytes of this rank's block."""
    _record("grad_full", t.to_local())
    return t.full_tensor()


def grad_kernel(plan, x, dz, sh: _Shard, dtype):
    """dk of a sharded plan as one plain (C', C, kh, kw) tensor, equal on
    every rank, from this rank's padded block ``dz`` (B/n_data, C'/n_model)
    of the conv-output cotangent; no rank gathers the whole ``x`` or
    ``dz``.

    A plain global ``x`` gives its batch block with every channel, so the
    rank computes the rows of its C' block; a ``DTensor`` ``x`` gives its
    (B/n_data, C/n_model) block, and whichever of it and ``dz`` is smaller
    is gathered over ``model``: ``x`` for the rows of the rank's C' block,
    ``dz`` for the columns of its C block.  The share is then summed over
    ``data`` and gathered over ``model``.  Padded batch rows and channels
    hold zeros, so they contribute nothing; the padding is cut off."""
    from torch.distributed.tensor import DTensor
    s = plan.spec
    rows = True                          # the rank's C' rows of dk
    if isinstance(x, DTensor):
        xb = _local_block(plan, x, _block_cuts(sh))
        if xb.numel() <= dz.numel():
            xb = _grad_all_gather(xb, sh.group, sh.n_model, 1)[:, :s.C]
        else:
            dz = _grad_all_gather(dz, sh.group, sh.n_model, 1)
            rows = False
    else:
        xb = _take(x, ((0, sh.n_data, sh.d),))
    dk = torch.nn.grad.conv2d_weight(
        xb, (dz.shape[1], xb.shape[1], s.kh, s.kw), dz.to(xb.dtype),
        padding=plan.padding)
    dk = _grad_all_reduce(dk, plan.mesh.get_group(plan.data_axis))
    dk = _grad_all_gather(dk, sh.group, sh.n_model, 0 if rows else 1)
    return dk[:s.Cout, :s.C].to(dtype)


def grad_bias(plan, dz, sh: _Shard):
    """d_bias of a sharded plan as one plain (C',) tensor, equal on every
    rank: the rank's block ``dz`` summed over (B, H, W), then over
    ``data``, gathered over ``model`` and cut to C'."""
    db = _grad_all_reduce(dz.sum(dim=(0, 2, 3)),
                          plan.mesh.get_group(plan.data_axis))
    return _grad_all_gather(db, sh.group, sh.n_model, 0)[:plan.spec.Cout]


class _ShardedPipeline:
    """What the sharded schedules share: each rank's blocks of the
    operands, the batch sub-slabs, stage 4 on the rank's slab, and the
    ``DTensor`` result.  Every rank calls it SPMD with the same global
    operands (or the input as a ``DTensor`` placed like the output)."""

    def __init__(self, cgemm_fn=None, inverse_fn=None, tile_rfft=None,
                 tile_irfft=None, image_rfft=None):
        self.cgemm_fn = cgemm_fn
        self.inverse_fn = inverse_fn
        self.tile_rfft = tile_rfft
        self.tile_irfft = tile_irfft
        self.image_rfft = image_rfft

    def execute(self, plan, x, G, bias=None, residual=None):
        return self._run(plan, x, bias, residual, G=G)

    def full(self, plan, x, k, bias=None, residual=None):
        return self._run(plan, x, bias, residual, k=k)

    def _run(self, plan, x, bias, residual, G=None, k=None):
        sh, spec = _shard(plan), padded_sharded_spec(plan)
        xb = _local_block(plan, x, _block_cuts(sh))
        bias, residual = _epilogue_operands(plan, sh, bias, residual)
        if G is None:
            G = self._stage2(k, plan, spec, sh)
        Gr, Gi = _maybe_cast(G, plan.compute_dtype)
        sizes = _slab_sizes(xb.shape[0], plan.num_slabs)
        y = self._slabbed(_slab_splits(xb, sizes),
                          _slab_splits(residual, sizes), Gr, Gi, bias,
                          plan, spec, sh)
        return _global_output(plan, y, sh, x.dtype)

    def _stage4(self, Z, sp4, bias, residual, plan):
        """Stage 4 on the rank's slab with the fused epilogue, in
        float32."""
        return stage_output_inverse(
            Z[0].float(), Z[1].float(), sp4, epilogue=plan.epilogue,
            bias=bias, residual=residual, inverse_fn=self.inverse_fn,
            tile_irfft=self.tile_irfft, spectrum=plan.spectrum)


# --------------------------------------------------------------------------
# nfft schedule (the paper's NUMA-aware tuple partitioning)
# --------------------------------------------------------------------------

class NfftPipeline(_ShardedPipeline):
    """Transforms where the data lives; one all-to-all per stage boundary;
    collective-free hot CGEMM.  Prepared form: the rank's P/N slab of G in
    the post-boundary layout (P/N, C, C'), so prepared execution skips
    stage 2 and boundary a2a #2 entirely.  The epilogue runs on each
    rank's C'/N stage-4 slab."""

    def prepare(self, plan, k):
        """Stage 2 once, on the whole padded kernel, and this rank's P/N
        slab of it: no collective."""
        sh, spec = _shard(plan), padded_sharded_spec(plan)
        Gr, Gi = self._g_slab(k, plan, spec, sh)
        return Gr.clone(), Gi.clone()           # not a view of the whole

    def _g_slab(self, k, plan, spec, sh):
        n = sh.n_model
        kp = _pad_axis(_pad_axis(k, 0, n), 1, n)
        sp2 = _local_spec(spec, spec.B, kp.shape[1], kp.shape[0])
        Gr, Gi = stage_kernel_transform(kp, sp2, plan.spectrum,
                                        self.tile_rfft)
        return _take(Gr, ((0, n, sh.m),)), _take(Gi, ((0, n, sh.m),))

    def _stage2(self, k, plan, spec, sh):
        if plan.replicate_kernel_transform:
            # Stage 2': the full kernel transform on every rank, the local
            # P slab kept: no boundary a2a #2
            return self._g_slab(k, plan, spec, sh)
        # Stage 2: the rank's C'/N kernels -> G (P, C, C'/N), then
        # boundary a2a #2: (P, C, C'/N) -> (P/N, C, C')
        n = sh.n_model
        kb = _take(_pad_axis(k, 1, n), ((0, n, sh.m),))
        sp2 = _local_spec(spec, spec.B, kb.shape[1], kb.shape[0])
        G = stage_kernel_transform(kb, sp2, plan.spectrum, self.tile_rfft)
        G = _a2a_result(_boundary_a2a(_pack(G, n), sh.group, 0, 2, n))
        return G[0], G[1]

    def _slabbed(self, xs, rs, Gr, Gi, bias, plan, spec, sh):
        """Stages 1/3/4 against a boundary-layout G, slab by slab.

        With one slab (``overlap="off"``) this is the sequential path.
        With ``overlap="slab:k"`` slab i+1's stage 1 and boundary
        all-to-all #1 are issued *before* slab i's hot CGEMM, boundary
        all-to-all #3 and stage-4 tail, so the collective of one slab
        runs beside the compute of another (on the GPU, NCCL's stream
        beside the compute stream).  The kernel-side work (stage 2, a2a
        #2) is shared by all slabs; total collective bytes equal the
        sequential path's."""
        pending = self._stage1_and_boundary1(xs[0], plan, spec, sh)
        outs = []
        for i, xi in enumerate(xs):
            nxt = None
            if i + 1 < len(xs):
                nxt = self._stage1_and_boundary1(xs[i + 1], plan, spec, sh)
            D = _a2a_result(pending)
            outs.append(self._hot_and_tail(xi.shape[0], D, Gr, Gi, bias,
                                           rs[i], plan, spec, sh))
            pending = nxt
        return outs[0] if len(outs) == 1 else torch.cat(outs)

    def _stage1_and_boundary1(self, x, plan, spec, sh):
        sp1 = _local_spec(spec, x.shape[0], x.shape[1], spec.Cout)
        D = stage_input_transform(x, sp1, plan.spectrum, self.tile_rfft,
                                  image_rfft=self.image_rfft)
        # Boundary a2a #1 (tuple partitioning): (P, M, C/N) -> (P/N, M, C)
        return _boundary_a2a(_pack(D, sh.n_model, plan.compute_dtype),
                             sh.group, 0, 2, sh.n_model)

    def _hot_and_tail(self, b_loc, D, Gr, Gi, bias, residual, plan, spec,
                      sh):
        # Stage 3 (HOT): the local P/N-slab complex GEMM, no collective
        Zr, Zi = stage_cgemm(D[0], D[1], Gr, Gi, three_m=plan.three_m,
                             cgemm_fn=self.cgemm_fn)
        # Boundary a2a #3 (gather tuples for the inverse):
        # (P/N, M, C') -> (P, M, C'/N)
        n = sh.n_model
        Z = _a2a_result(_boundary_a2a(_pack((Zr, Zi), 1,
                                            plan.compute_dtype),
                                      sh.group, 2, 0, n))
        sp4 = _local_spec(spec, b_loc, spec.C, spec.Cout // n)
        return self._stage4(Z, sp4, bias, residual, plan)


# --------------------------------------------------------------------------
# wfft schedule (Wang et al. baseline)
# --------------------------------------------------------------------------

class WfftPipeline(_ShardedPipeline):
    """No tuple partitioning: the CGEMM contracts a channel axis spread
    over ``model``, so an all-reduce of the whole Z sits inside the hot
    stage.  Prepared form: the rank's C/N slab of G, (P, C/N, C').  The
    epilogue runs on each rank's C'/N stage-4 slab like nfft."""

    def prepare(self, plan, k):
        return self._stage2(k, plan, padded_sharded_spec(plan),
                            _shard(plan))

    def _stage2(self, k, plan, spec, sh):
        n = sh.n_model
        kb = _take(_pad_axis(k, 0, n), ((1, n, sh.m),))
        sp2 = _local_spec(spec, spec.B, kb.shape[1], kb.shape[0])
        return stage_kernel_transform(kb, sp2, plan.spectrum,
                                      self.tile_rfft)

    def _slabbed(self, xs, rs, Gr, Gi, bias, plan, spec, sh):
        """Slab by slab; with ``overlap="slab:k"`` the stage-1 transform
        and partial CGEMM of slab i+1 run while slab i's all-reduce is in
        flight (each all-reduce moves 1/k of the rows: total bytes equal
        the sequential path's)."""
        pending = self._partial_z(xs[0], Gr, Gi, plan, spec, sh)
        outs = []
        for i, xi in enumerate(xs):
            nxt = None
            if i + 1 < len(xs):
                nxt = self._partial_z(xs[i + 1], Gr, Gi, plan, spec, sh)
            outs.append(self._psum_and_tail(xi.shape[0], pending, bias,
                                            rs[i], plan, spec, sh))
            pending = nxt
        return outs[0] if len(outs) == 1 else torch.cat(outs)

    def _partial_z(self, x, Gr, Gi, plan, spec, sh):
        """Stage 1 + the partial (C-sharded contraction) CGEMM of one
        slab, and its all-reduce issued; G enters already cast."""
        sp1 = _local_spec(spec, x.shape[0], x.shape[1], spec.Cout)
        Dr, Di = stage_input_transform(                # (P, M, C/N)
            x, sp1, plan.spectrum, self.tile_rfft, image_rfft=self.image_rfft)
        Dr, Di = _maybe_cast((Dr, Di), plan.compute_dtype)
        Z = stage_cgemm(Dr, Di, Gr, Gi, three_m=plan.three_m,
                        cgemm_fn=self.cgemm_fn)       # partial sums
        # cast before the all-reduce, like nfft's boundary a2a
        return _all_reduce(_pack(Z, 1, plan.compute_dtype), sh.group)

    def _psum_and_tail(self, b_loc, pending, bias, residual, plan, spec,
                       sh):
        work, Z = pending
        work.wait()
        # each rank inverts its C'/N slice (no duplicate stage-4 work)
        co = spec.Cout // sh.n_model
        Z = Z[..., sh.m * co:(sh.m + 1) * co]
        sp4 = _local_spec(spec, b_loc, spec.C, co)
        return self._stage4(Z, sp4, bias, residual, plan)


PIPELINES = {"local": LocalPipeline, "nfft": NfftPipeline,
             "wfft": WfftPipeline}


def pipeline_for(schedule: str, cgemm_fn=None, inverse_fn=None,
                 tile_rfft=None, tile_irfft=None, image_rfft=None):
    return PIPELINES[schedule](cgemm_fn, inverse_fn, tile_rfft, tile_irfft,
                               image_rfft)
