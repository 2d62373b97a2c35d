"""Activation sharding over a mesh: the ``DTensor`` form of GSPMD's
``with_sharding_constraint`` at block boundaries.

The model code stays global.  Parameters, batches and caches are
``DTensor``s placed by the sharding rules (``launch/shardings.py``); inside
the context the model body runs on them, and ``constrain`` redistributes
an activation to its kind's placements:

    with activation_sharding(mesh):
        logits = lm_forward(placed_params, cfg, placed_tokens)

Model code calls ``constrain(x, kind)`` with kind one of:
    "seq"    (B, S, d)      -> P(dp, None, None)
    "logits" (B, S, V)      -> P(dp, None, "model")
    "heads"  (B, S, H, hd)  -> P(dp, None, "model"?, None)  (if H divides)
and ``current_mesh()`` where a layer has a sharded form (the expert-
parallel MoE).  Outside the context both are the identity, and
``constrain`` leaves a plain tensor as it is inside it too.

Inside the context the body runs under ``implicit_replication()``: the
constants it builds as plain tensors (RoPE tables, masks, ``arange``s,
fresh caches) count as replicated on the mesh.

``PartitionSpec`` is the reference's ``jax.sharding.PartitionSpec``: one
entry per tensor dimension (missing trailing entries are ``None``), each
``None``, a mesh axis name or a tuple of names, normalised as JAX does (a
tuple of one name is the name, an empty tuple ``None``).  ``placements``
turns it into ``DTensor`` placements: a dimension named by several mesh
axes is ``Shard`` on each of them, major to minor, as JAX lays it out.
"""
from __future__ import annotations

import contextlib
import threading

import torch

KINDS = ("seq", "logits", "heads")
DP_AXES = ("pod", "data")

_TLS = threading.local()
_REPLICATION = threading.Lock()
_replication_depth = 0
_replication_cm = None


class PartitionSpec(tuple):
    """One entry per tensor dimension: ``None``, a mesh axis name, or a
    tuple of names (major to minor)."""

    def __new__(cls, *entries):
        def norm(e):
            if isinstance(e, (tuple, list)):
                e = tuple(e)
                return None if not e else e[0] if len(e) == 1 else e
            return e
        return super().__new__(cls, (norm(e) for e in entries))

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


def axis_names(mesh) -> tuple:
    """The axis names of a ``DeviceMesh`` or of a shape-only mesh (any
    object with ``.shape``, a dict, and ``.axis_names``)."""
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def axis_sizes(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh`` or of a shape-only mesh."""
    if isinstance(mesh.shape, dict):
        return dict(mesh.shape)
    return dict(zip(axis_names(mesh), mesh.shape))


def dp_axes(mesh) -> tuple:
    """The data-parallel axes of a mesh (pod included when present)."""
    return tuple(a for a in axis_names(mesh) if a in DP_AXES)


def _entry_axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements(spec, mesh, ndim: int | None = None) -> tuple:
    """``DTensor`` placements on ``mesh`` of a tensor laid out as
    ``spec``: ``Shard(d)`` on every mesh dim that names tensor dim ``d``,
    ``Replicate()`` on the others.  A tensor dim named by several mesh
    axes is split over them major to minor, which DTensor does in
    mesh-dim order: the names must come in that order.  A mesh dim of
    size 1 splits nothing, and is ``Replicate()`` whatever names it: the
    same layout, and DTensor plans no redistribution for it."""
    from torch.distributed.tensor import Replicate, Shard
    names, sizes = axis_names(mesh), axis_sizes(mesh)
    spec = tuple(spec)
    if ndim is not None and len(spec) > ndim:
        raise ValueError(f"spec {spec} has more entries than the tensor's "
                         f"{ndim} dims")
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        axes = _entry_axes(entry)
        try:
            idx = [names.index(a) for a in axes]
        except ValueError:
            raise ValueError(f"spec {spec} names an axis that mesh "
                             f"{names} does not have") from None
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes {axes} of dim {d} are not "
                             f"in the mesh's order {names}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"spec {spec} uses mesh axis {names[i]!r} "
                                 "twice")
            out[i] = Shard(d)
    return tuple(Replicate() if sizes[n] == 1 else pl
                 for n, pl in zip(names, out))


def local_block(t, mesh, places):
    """This rank's block of the whole tensor ``t`` under ``places``: a
    view (narrowed on every sharded dim), made contiguous only where the
    view is not (a one-rank mesh's block is ``t`` itself)."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    shape, offset = compute_local_shape_and_global_offset(
        t.shape, mesh, places)
    block = t
    for d, (n, o) in enumerate(zip(shape, offset)):
        if n != t.shape[d]:
            block = block.narrow(d, o, n)
    return block.contiguous()


def local_of(t, mesh, spec, partial_over=()):
    """This rank's block of ``t`` laid out as ``spec``, for a per-rank
    body (differentiably): ``t`` is redistributed there (a plain tensor
    counts as replicated) and its local tensor taken.  Along the mesh
    dims of ``partial_over`` the ranks compute different parts of the
    body's output, so where the block is replicated along one its
    gradient is a partial sum over those ranks (``grad_placements``)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    places = placements(spec, mesh, t.ndim)
    if not is_dtensor(t):
        t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    names, sizes = axis_names(mesh), axis_sizes(mesh)
    grads = [Partial() if names[i] in partial_over and sizes[names[i]] > 1
             and isinstance(pl, Replicate) else pl
             for i, pl in enumerate(places)]
    return t.redistribute(mesh, places).to_local(grad_placements=grads)


def on_blocks(fn, x, dims):
    """``fn(x)`` for an op that has no ``DTensor`` strategy on some torch
    version, run on each rank's block (the per-rank body the reference's
    GSPMD would keep local): ``x`` is redistributed so that the ``dims``
    ``fn`` works along are whole on every rank, ``fn`` runs on the local
    tensor and keeps its shape, and the result takes that layout.  A
    plain tensor goes to ``fn`` as it is."""
    if not is_dtensor(x):
        return fn(x)
    from torch.distributed.tensor import DTensor, Replicate, Shard
    dims = {d % x.ndim for d in dims}
    places = [Replicate() if not isinstance(pl, (Shard, Replicate))
              or isinstance(pl, Shard) and pl.dim in dims else pl
              for pl in x.placements]
    x = x.redistribute(x.device_mesh, places)
    return DTensor.from_local(fn(x.to_local()), x.device_mesh, places,
                              run_check=False, shape=x.shape,
                              stride=x.stride())


# --------------------------------------------------------------------------
# the context
# --------------------------------------------------------------------------

@contextlib.contextmanager
def _implicit_replication():
    """``implicit_replication()`` held while any thread is inside a mesh
    context: its flag is one for the process, and its own exit clears it
    even when an outer use is still open."""
    global _replication_depth, _replication_cm
    from torch.distributed.tensor.experimental import implicit_replication
    with _REPLICATION:
        _replication_depth += 1
        if _replication_depth == 1:
            _replication_cm = implicit_replication()
            _replication_cm.__enter__()
    try:
        yield
    finally:
        with _REPLICATION:
            _replication_depth -= 1
            if _replication_depth == 0:
                _replication_cm.__exit__(None, None, None)
                _replication_cm = None


@contextlib.contextmanager
def activation_sharding(mesh, *, model_axis: str = "model"):
    """Within, ``current_mesh()`` is ``mesh`` and ``constrain`` places
    ``DTensor`` activations on it; contexts nest (the inner one wins) and
    are per thread.  On a ``DeviceMesh`` the body runs under implicit
    replication; a shape-only mesh sets the context alone."""
    prev = getattr(_TLS, "ctx", None)
    _TLS.ctx = (mesh, dp_axes(mesh), model_axis)
    try:
        if hasattr(mesh, "mesh_dim_names"):
            with _implicit_replication():
                yield
        else:
            yield
    finally:
        _TLS.ctx = prev


@contextlib.contextmanager
def _entered(ctx):
    if ctx is None:
        yield
    else:
        with activation_sharding(ctx[0], model_axis=ctx[2]):
            yield


def carried(fn):
    """``fn`` bound to the context active now, for code that runs it
    later in another thread or after the context has closed: a unit's
    recompute under ``torch.utils.checkpoint``, which autograd runs in the
    backward (on the GPU, in a device thread of its own)."""
    ctx = getattr(_TLS, "ctx", None)

    def run(*args, **kw):
        with _entered(ctx):
            return fn(*args, **kw)
    return run


def current_mesh():
    """Mesh of the active activation_sharding context (or None)."""
    ctx = getattr(_TLS, "ctx", None)
    return None if ctx is None else ctx[0]


def _spec(kind: str, x, mesh, dp, model_axis):
    sizes = axis_sizes(mesh)
    n_model = sizes[model_axis]
    dp_size = 1
    for a in dp:
        dp_size *= sizes[a]
    b_ok = x.shape[0] % dp_size == 0
    b = dp if b_ok else None
    if kind == "seq":
        return P(b, *(None,) * (x.ndim - 1))
    if kind == "logits":
        v = model_axis if x.shape[-1] % n_model == 0 else None
        return P(b, *(None,) * (x.ndim - 2), v)
    if kind == "heads":
        h = model_axis if x.shape[2] % n_model == 0 else None
        return P(b, None, h, *(None,) * (x.ndim - 3))
    raise ValueError(kind)


def constrain(x, kind: str):
    """``x`` redistributed to ``kind``'s placements when it is a
    ``DTensor`` inside a mesh context; otherwise ``x`` itself."""
    if kind not in KINDS:
        raise ValueError(kind)
    ctx = getattr(_TLS, "ctx", None)
    if ctx is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    mesh, dp, model_axis = ctx
    want = placements(_spec(kind, x, mesh, dp, model_axis), mesh, x.ndim)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh, want)


def is_dtensor(x) -> bool:
    """Whether ``x`` is a ``DTensor``."""
    if not isinstance(x, torch.Tensor):
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)
