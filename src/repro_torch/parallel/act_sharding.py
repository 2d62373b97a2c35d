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
import functools
import inspect
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
    gradient is a partial sum over those ranks, reduced in the backward
    (``_Block``)."""
    from torch.distributed.tensor import Partial, Replicate
    places = placements(spec, mesh, t.ndim)
    names, sizes = axis_names(mesh), axis_sizes(mesh)
    grads = [Partial() if names[i] in partial_over and sizes[names[i]] > 1
             and isinstance(pl, Replicate) else pl
             for i, pl in enumerate(places)]
    return _block(t, mesh, places, grads)


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


def _block(t, mesh, places, grads=None):
    """This rank's block of ``t`` (a plain tensor counts as replicated)
    laid out as ``places``, differentiably (``grads``: the placements of
    the block's gradient, the block's by default; see ``_Block``)."""
    from torch.distributed.tensor import DTensor, Replicate
    if not is_dtensor(t):
        t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    grads = tuple(places if grads is None else grads)
    if tuple(t.placements) == tuple(places) == grads:
        return t.to_local()
    return _Block.apply(t, tuple(places), grads)


def _grad_layout(places) -> tuple:
    """The layout of the gradient of a tensor laid out as ``places``: a
    partial placement taken as replicated, as ``DTensor``'s own backward
    takes it."""
    from torch.distributed.tensor import Replicate
    return tuple(Replicate() if pl.is_partial() else pl for pl in places)


def _laid_out(t, places):
    """The ``DTensor`` ``t`` redistributed to ``places`` where it is not
    laid out so."""
    if tuple(t.placements) == tuple(places):
        return t
    return t.redistribute(t.device_mesh, places)


class _Block(torch.autograd.Function):
    """The local block of the ``DTensor`` ``t`` laid out as ``places``.
    Its gradient, a block laid out as ``grads`` (a partial sum along a
    mesh dim whose ranks compute other parts of a per-rank body), is
    reduced in the backward, explicitly, to ``t``'s own layout.  So no
    partial sum leaves the body into ``DTensor``'s autograd, and no
    backward asks a split gradient to become a partial sum, which torch
    2.11's ``DTensor`` refuses (``redistribute from S(1) to P(sum) not
    supported yet``)."""

    @staticmethod
    def forward(ctx, t, places, grads):
        ctx.mesh, ctx.grads, ctx.shape = t.device_mesh, grads, t.shape
        ctx.target = _grad_layout(t.placements)
        return t.redistribute(t.device_mesh, places).to_local()

    @staticmethod
    def backward(ctx, grad):
        return _laid_out(_placed(grad, ctx.mesh, ctx.grads, ctx.shape),
                         ctx.target), None, None


def _placed(block, mesh, places, shape):
    """The ``DTensor`` of global ``shape`` whose block on this rank is
    ``block``, laid out as ``places``."""
    from torch.distributed.tensor import DTensor
    from torch._prims_common import make_contiguous_strides_for
    return DTensor.from_local(block.contiguous(), mesh, places,
                              run_check=False, shape=shape,
                              stride=make_contiguous_strides_for(shape))


def on_head_blocks(fn):
    """``fn(q, k, v, **kw)``, an attention over (batch, heads, seq, dim)
    in which every (batch, head) is computed apart, run on each rank's
    block when ``q`` is a ``DTensor``: q, k and v are laid out alike, split
    over the mesh dims that split q's batch or heads dim and whole on the
    others; a tensor keyword that has the batch dim first (positions,
    lengths) is cut to the rank's rows; the result takes q's layout.  The
    reference's GSPMD keeps such a body shard-local.  On ``DTensor`` the
    body's einsums would fold a batch and a heads dim split over two mesh
    dims into one, which torch 2.11's ``DTensor`` refuses.

    Keys split over a mesh dim (a decode step's cache, split on its
    sequence where the kv heads do not divide the model axis) stay split
    there when ``fn`` takes ``lse`` and no gradient is taken: each rank
    attends over its keys (``kv_positions`` cut alike) and the partial
    results merge by their log-sum-exps over that dim (flash-decoding:
    the query moves, not the cache)."""
    split_keys = "lse" in inspect.signature(fn).parameters

    @functools.wraps(fn)
    def run(q, k, v, **kw):
        if not is_dtensor(q):
            return fn(q, k, v, **kw)
        from torch.distributed.tensor import Partial, Replicate, Shard
        mesh = q.device_mesh
        seq = set()
        if split_keys and is_dtensor(k) and not torch.is_grad_enabled():
            seq = {i for i, pl in enumerate(k.placements)
                   if isinstance(pl, Shard) and pl.dim == 2}
        places = [Replicate() if i in seq or not (
            isinstance(pl, Shard) and pl.dim in (0, 1)) else pl
            for i, pl in enumerate(q.placements)]
        kv_places = [Shard(2) if i in seq else pl
                     for i, pl in enumerate(places)]
        rows = [pl if isinstance(pl, Shard) and pl.dim == 0 else Replicate()
                for pl in places]
        kv_rows = [Shard(1) if i in seq else pl for i, pl in enumerate(rows)]

        def local(t, places):
            return _block(t, mesh, places)

        def placed(t, places, shape):
            return _placed(t, mesh, places, shape)

        B = q.shape[0]
        kw = {n: local(t, kv_rows if n == "kv_positions" else rows)
              if isinstance(t, torch.Tensor) and t.ndim and t.shape[0] == B
              else t for n, t in kw.items()}
        q_, k_, v_ = local(q, places), local(k, kv_places), local(v, kv_places)
        shape = (*q.shape[:-1], v.shape[-1])
        if not seq:
            return placed(fn(q_, k_, v_, **kw), places, shape)
        out, lse = fn(q_, k_, v_, lse=True, **kw)
        stat = tuple(q.shape[:-1])
        partial = [Partial("max") if i in seq else pl
                   for i, pl in enumerate(places)]
        top = local(placed(lse, partial, stat), places)
        w = torch.exp(lse - top)
        partial = [Partial() if i in seq else pl for i, pl in enumerate(places)]
        num = local(placed(out * w[..., None], partial, shape), places)
        den = local(placed(w, partial, stat), places)
        return placed((num / den[..., None]).to(v.dtype), places, shape)
    return run


def reduced(x):
    """``x`` with every partial placement of a ``DTensor`` reduced (a
    partial max or sum made whole); a plain tensor as it is.  torch 2.11's
    ``DTensor`` cannot turn a partial max into a partial sum, as an op on
    a max over a split dim may ask."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Partial, Replicate
    places = [Replicate() if isinstance(pl, Partial) else pl
              for pl in x.placements]
    if places == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, places)


def grad_placed(t):
    """``t`` itself, whose gradient is laid out as ``t`` (a partial sum
    reduced, explicitly, to ``t``'s own layout) before it meets the
    gradients of ``t``'s other uses: where a weight is used twice (a tied
    embedding's lookup and logits), torch 2.11's ``DTensor`` would sum a
    split gradient with a partial one by making the split one partial,
    which it refuses.  A plain tensor is ``t``."""
    if not is_dtensor(t):
        return t
    return _Constrained.apply(t, _grad_layout(t.placements))


def take_rows(table, idx):
    """``table[idx]``: the rows of ``table`` (rows, ...) at the integer
    tensor ``idx``.  On a ``DTensor`` table each rank looks up its own
    block of rows (``_TakeRows``), as the reference's GSPMD does a gather
    from a row-split table: the table gathered only along the mesh dims
    that split its other dims (FSDP), ``idx`` whole along those that split
    its rows; a row a rank lacks reads 0 there, and the output, summed
    over those dims, is laid out as ``idx``.  No ``DTensor`` index op runs
    (torch 2.11's strategy for the backward's ``index_put`` raises, and
    its strategy for the forward gathers the whole table)."""
    if not is_dtensor(table):
        return table[idx]
    from torch.distributed.tensor import DTensor, Replicate
    if not is_dtensor(idx):
        idx = DTensor.from_local(idx, table.device_mesh,
                                 [Replicate()] * table.device_mesh.ndim,
                                 run_check=False)
    return _TakeRows.apply(table, idx)


class _TakeRows(torch.autograd.Function):
    """``take_rows`` on local blocks.  The backward adds each output row's
    gradient into the rank's block of rows (``index_add_``): a partial sum
    along the mesh dims that split ``idx`` (other ranks saw other
    indices), reduced explicitly to the table's own layout (a
    reduce-scatter where FSDP splits the table's other dims)."""

    @staticmethod
    def forward(ctx, table, idx):
        from torch.distributed.tensor import Partial, Replicate, Shard
        from torch.distributed.tensor._utils import \
            compute_local_shape_and_global_offset
        mesh = table.device_mesh
        rows = {i for i, pl in enumerate(table.placements)
                if isinstance(pl, Shard) and pl.dim == 0}
        t_places = tuple(pl if i in rows else Replicate()
                         for i, pl in enumerate(table.placements))
        out_places = tuple(pl if isinstance(pl, Shard) and i not in rows
                           else Replicate()
                           for i, pl in enumerate(idx.placements))
        block = table.redistribute(mesh, t_places).to_local()
        ids = idx.redistribute(mesh, out_places).to_local().long()
        (n, *_), (lo, *_) = compute_local_shape_and_global_offset(
            table.shape, mesh, t_places)
        hit = (ids >= lo) & (ids < lo + n)
        rel = torch.where(hit, ids - lo, 0)
        mask = hit.reshape(*hit.shape, *(1,) * (block.ndim - 1))
        out = torch.where(mask, block[rel], 0)
        shape = (*idx.shape, *table.shape[1:])
        out = _placed(out, mesh, tuple(Partial() if i in rows else pl
                                       for i, pl in enumerate(out_places)),
                      shape)
        out = _laid_out(out, out_places)
        ctx.save_for_backward(rel, mask)
        ctx.mesh, ctx.out_places, ctx.block_shape = mesh, out_places, \
            block.shape
        ctx.table_shape = table.shape
        ctx.grads = tuple(Partial() if isinstance(pl, Shard) else t_pl
                          for pl, t_pl in zip(out_places, t_places))
        ctx.target = _grad_layout(table.placements)
        return out

    @staticmethod
    def backward(ctx, grad):
        rel, mask = ctx.saved_tensors
        g = _laid_out(grad, ctx.out_places).to_local()
        g = torch.where(mask, g, 0).reshape(-1, *ctx.block_shape[1:])
        rows = torch.zeros(ctx.block_shape, dtype=g.dtype, device=g.device)
        rows.index_add_(0, rel.reshape(-1), g)
        return _laid_out(_placed(rows, ctx.mesh, ctx.grads, ctx.table_shape),
                         ctx.target), None


def on_local_blocks(fn, args, roles, out_roles):
    """``fn(*args)``, a body whose results are computed apart along some
    dims (each a role: a batch, heads, a head's channels), run on each
    rank's block when ``args[0]`` is a ``DTensor``.  ``roles[i]`` maps each
    role of ``args[i]`` to its dim (``None`` for an argument passed as it
    is).  A mesh dim that splits ``args[0]`` along one of its roles splits
    every argument along that role, or leaves it whole where it has none;
    every other dim is whole.  ``out_roles`` lays the results (a tuple)
    out alike.  The reference's GSPMD keeps such a body shard-local; on
    ``DTensor`` its einsums would fold dims split over two mesh dims into
    one, which torch 2.11's ``DTensor`` refuses."""
    lead = args[0]
    if not is_dtensor(lead):
        return fn(*args)
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = lead.device_mesh
    role_of = {d: role for role, d in roles[0].items()}
    split = [role_of.get(pl.dim) if isinstance(pl, Shard) else None
             for pl in lead.placements]
    sizes = {role: lead.shape[d] for role, d in roles[0].items()}

    def places(r):
        return [Shard(r[role]) if role in r else Replicate()
                for role in split]

    def local(t, r):
        # a block read whole by ranks that compute other blocks of a role
        # it lacks gets a partial-sum gradient over them (``local_of``)
        if r is None:
            return t
        grads = [Partial() if role is not None and role not in r else pl
                 for role, pl in zip(split, places(r))]
        return _block(t, mesh, places(r), grads)

    outs = fn(*(local(a, r) for a, r in zip(args, roles)))
    placed = []
    for o, r in zip(outs, out_roles):
        dim_role = {d: role for role, d in r.items()}
        shape = tuple(sizes[dim_role[d]] if d in dim_role else n
                      for d, n in enumerate(o.shape))
        placed.append(_placed(o, mesh, places(r), shape))
    return tuple(placed)


def whole_groups(y, groups: int, dim: int):
    """``y`` laid out so that every mesh dim that splits its dimension
    ``dim`` splits it into whole groups of ``groups`` (heads, say): a mesh
    dim whose size (times those before it) does not divide ``groups`` is
    gathered, so ``groups=1`` makes ``dim`` whole on every rank.  The
    parameters' rules split a heads dim only so (``launch/shardings.py``
    ``_leaf_spec``), but ``DTensor`` may split a product's heads, or its
    flat heads x k dim, unevenly over any mesh dim, or lay a gradient out
    so, and a view across an uneven split (or an unbind of a split dim)
    raises.  A plain tensor is ``y`` itself."""
    if not is_dtensor(y):
        return y
    from torch.distributed.tensor import Replicate, Shard
    split = 1
    places = []
    for i, pl in enumerate(y.placements):
        if isinstance(pl, Shard) and pl.dim == dim % y.ndim:
            if groups % (split * y.device_mesh.size(i)) == 0:
                split *= y.device_mesh.size(i)
            else:
                pl = Replicate()
        places.append(pl)
    if places == list(y.placements):
        return y
    return y.redistribute(y.device_mesh, places)


class _SplitHeads(torch.autograd.Function):
    """Dimension ``dim`` (of heads * k) viewed as (heads, k), whose
    backward merges the gradient's with ``merge_heads``: ``DTensor`` lays
    a gradient out as it sees fit, and a plain view's backward would view
    it whatever its layout."""

    @staticmethod
    def forward(ctx, y, heads, dim):
        ctx.dim = dim
        return y.unflatten(dim, (heads, -1))

    @staticmethod
    def backward(ctx, grad):
        return merge_heads(grad, ctx.dim), None, None


class _MergeHeads(torch.autograd.Function):
    """Dimensions (dim, dim + 1) of (heads, k) viewed as one, whose
    backward splits the gradient's with ``split_heads``."""

    @staticmethod
    def forward(ctx, y, dim):
        ctx.heads, ctx.dim = y.shape[dim], dim
        return y.flatten(dim, dim + 1)

    @staticmethod
    def backward(ctx, grad):
        return split_heads(grad, ctx.heads, ctx.dim), None


def split_heads(y, heads: int, dim: int = -1):
    """``y`` with dimension ``dim`` (of heads * k) viewed as (heads, k);
    on a ``DTensor``, laid out first by ``whole_groups``, and so is its
    gradient before the backward's view."""
    dim %= y.ndim
    if not is_dtensor(y):
        return y.unflatten(dim, (heads, -1))
    return _SplitHeads.apply(whole_groups(y, heads, dim), heads, dim)


def merge_heads(y, dim: int = -2):
    """``y`` with dimensions ``dim`` and ``dim + 1`` (heads, k) viewed as
    one of heads * k; on a ``DTensor``, laid out first by
    ``whole_groups`` with ``k`` whole (a weight's k may be split by FSDP,
    and torch 2.11's ``DTensor`` cannot flatten two split dims), and so is
    its gradient before the backward's view."""
    dim %= y.ndim
    if not is_dtensor(y):
        return y.flatten(dim, dim + 1)
    y = whole_groups(whole_groups(y, y.shape[dim], dim), 1, dim + 1)
    return _MergeHeads.apply(y, dim)


def repeat_heads(t, n: int, dim: int = 1):
    """Each head of dimension ``dim`` repeated ``n`` times in place
    (``torch.repeat_interleave``), the heads merged by ``merge_heads``."""
    shape = list(t.shape)
    shape.insert(dim + 1, n)
    return merge_heads(t.unsqueeze(dim + 1).expand(shape), dim)


def project_heads(x, w):
    """The ``"bsd,dhk->bshk"`` projection of ``x`` (..., d) by ``w``
    (d, heads, k): a flat product, its heads split by ``split_heads``."""
    return split_heads(x @ merge_heads(w), w.shape[-2])


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
    return _Constrained.apply(x, want)


class _Constrained(torch.autograd.Function):
    """``x`` laid out as ``places``, and so is its gradient: GSPMD's
    sharding constraint binds the cotangent too, so a gradient does not
    carry into the body before it a layout that ``DTensor`` chose after
    it (torch 2.11's ``DTensor`` cannot flatten two split dims, as an
    einsum's or a matmul's backward may ask of such a layout)."""

    @staticmethod
    def forward(ctx, x, places):
        ctx.places = places
        y = _laid_out(x, places)
        return y.view_as(y) if y is x else y

    @staticmethod
    def backward(ctx, grad):
        return _laid_out(grad, ctx.places), None


def is_dtensor(x) -> bool:
    """Whether ``x`` is a ``DTensor``."""
    if not isinstance(x, torch.Tensor):
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)
