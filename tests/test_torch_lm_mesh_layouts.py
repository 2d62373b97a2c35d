"""The layouts that torch 2.11's ``DTensor`` refused in a sharded train
step or made expensive in a decode step, held by mechanism on the host's
torch (which runs them all): small forms traced in process on a fake
process group (``launch.dryrun.build_cell``: ``meta`` stand-ins over a
``cuda``-typed mesh), their ``DTensor`` ops recorded by a dispatch mode.
Each test fails without its repair:

- the embedding lookup (``act_sharding.take_rows``): no ``DTensor`` index
  op, forward or backward (2.11's strategy for the backward's
  ``index_put`` raised, ``Shard dim -1 ... must be normalized``), and a
  tied table's two gradients meet in its own layout (``grad_placed``;
  2.11 made the split one a partial sum, which it refuses);
- a per-rank body's block (``act_sharding._Block``): its backward never
  asks a split gradient to become a partial sum (``redistribute from S(1)
  to P(sum) not supported yet``);
- no view flattens a split dim into the dim before it (``Attempted to
  flatten multiple dimensions``): whisper's stream and its gradient laid
  out by ``constrain``, ``merge_heads`` with the head dim whole, the
  expert-parallel MoE's output gradient;
- a decode step over a cache split on its sequence moves neither the
  table nor the cache (2.11 gathered the whole vocab-split table: qwen3-14b
  ``decode_32k`` moved 1.57 GB a rank a step)."""
import contextlib
import importlib.util
import math
import pathlib

import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.launch import dryrun
from repro_torch.launch import mesh as M
from repro_torch.models.common import ShapeCell
from repro_torch.parallel import act_sharding as AS

ROOT = pathlib.Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)

TRAIN = ShapeCell("t", 16, 4, "train")
INDEX_OPS = ("aten.index.Tensor", "aten.index_put.default",
             "aten.index_put_.default", "aten._index_put_impl_.default",
             "aten.embedding.default",
             "aten.embedding_dense_backward.default")
COLLECTIVES = ("all_gather_into_tensor", "all_reduce", "reduce_scatter_tensor",
               "all_to_all_single", "shard_dim_alltoall")
VIEW_OPS = (torch.ops.aten.view.default, torch.ops.aten._unsafe_view.default,
            torch.ops.aten.reshape.default)


def _merged(src, dst):
    """The runs of ``src`` dims that a view to ``dst`` merges into one
    dim (size-1 dims dropped)."""
    i = j = 0
    runs = []
    while i < len(src) and j < len(dst):
        if src[i] == dst[j]:
            i, j = i + 1, j + 1
        elif src[i] == 1:
            i += 1
        elif dst[j] == 1:
            j += 1
        elif src[i] < dst[j]:
            run, size = [i], src[i]
            i += 1
            while i < len(src) and size < dst[j]:
                size *= src[i]
                run.append(i)
                i += 1
            runs.append(run)
            j += 1
        else:
            size = dst[j]
            j += 1
            while j < len(dst) and size < src[i]:
                size *= dst[j]
                j += 1
            i += 1
    return runs


class DTensorOps(TorchDispatchMode):
    """Every op dispatched on a ``DTensor``, as (op, in the backward), and
    every view that flattens a split dim into a dim before it; the op is
    handed on to ``DTensor`` (``NotImplemented``), local ops run."""

    def __init__(self):
        super().__init__()
        self.ops = []
        self.split_flattens = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not any(isinstance(t, DTensor)
                   for t in tree_leaves((args, kwargs))):
            return func(*args, **kwargs)
        backward = torch._C._current_autograd_node() is not None
        self.ops.append((str(func), backward))
        if func in VIEW_OPS:
            x = args[0]
            split = {pl.dim for pl in x.placements if isinstance(pl, Shard)}
            for run in _merged(list(x.shape), list(args[1])):
                dims = [d for d in run if x.shape[d] != 1]
                if any(d in split for d in dims[1:]):
                    self.split_flattens.append(
                        (tuple(x.shape), str(x.placements), tuple(args[1]),
                         backward))
        return NotImplemented


@contextlib.contextmanager
def fake_mesh(shape):
    """A fake process group of ``shape``'s rank count, for in-process
    traces over a ``cuda``-typed mesh."""
    dryrun.start_fake_group(math.prod(shape))
    try:
        yield M.make_mesh(shape, ("data", "model"), device_type="cuda")
    finally:
        dist.destroy_process_group()


def traced(form, mesh_shape, cell=TRAIN):
    """Form ``form`` of phase 22 (``chip_smoke.mesh_form``) stepped once
    on a fake mesh of ``mesh_shape`` (a train cell with FSDP and flash
    attention, as the dry-run's) under ``DTensorOps``."""
    mode = DTensorOps()
    dryrun.start_fake_group(math.prod(mesh_shape))
    try:
        fn, args, meta = dryrun.build_cell(
            smoke.mesh_form(form), cell, mesh_shape=mesh_shape,
            grad_bf16=False)
        with AS.activation_sharding(meta["mesh"]), mode, \
                torch.set_grad_enabled(cell.kind == "train"):
            fn(*args)
    finally:
        dist.destroy_process_group()
    return mode


@pytest.mark.parametrize("form,mesh_shape", [("qwen3", (2, 2)),
                                             ("fsdp0", (2, 2))])
def test_embedding_lookup_dispatches_no_dtensor_index(form, mesh_shape):
    """The table split on its rows over "model" and on d_model over
    "data" (FSDP), untied (qwen3) and tied (mamba2's fsdp0)."""
    mode = traced(form, mesh_shape)
    assert [op for op in mode.ops if op[0] in INDEX_OPS] == []


def test_tied_table_gradients_meet_in_its_layout():
    """A tied table's lookup gradient and its logits gradient each reach
    the table in its own placements, so their sum needs no
    redistribution."""
    with fake_mesh((2, 2)) as mesh:
        table = DTensor.from_local(
            torch.randn(4, 8, device="meta"), mesh, [Shard(1), Shard(0)],
            run_check=False).requires_grad_(True)
        ids = DTensor.from_local(
            torch.zeros(2, 3, dtype=torch.int64, device="meta"), mesh,
            [Shard(0), Replicate()], run_check=False)
        with AS.activation_sharding(mesh):
            x = AS.take_rows(table, ids)
            logits = x.detach() @ AS.grad_placed(table).T
        grads = [torch.autograd.grad(y.sum(), table)[0]
                 for y in (x, logits)]
    assert [tuple(g.placements) for g in grads] == [
        tuple(table.placements)] * 2


def test_per_rank_body_asks_no_split_to_partial(monkeypatch):
    """A block of a ``DTensor`` that is a partial sum (a product's output
    before its reduction) is taken split, for a per-rank body that reads
    it partly on every rank; its gradient must not be asked back into the
    partial layout."""
    from torch.distributed.tensor import _redistribute
    asked = []
    sound = _redistribute._redistribute_backward

    def spy(grad_output, previous_spec, **kw):
        asked.extend((type(a).__name__, type(b).__name__) for a, b in zip(
            grad_output.placements, previous_spec.placements))
        return sound(grad_output, previous_spec, **kw)
    monkeypatch.setattr(_redistribute, "_redistribute_backward", spy)
    with fake_mesh((1, 4)) as mesh:
        t = DTensor.from_local(torch.randn(4, 8, 8, device="meta"), mesh,
                               [Replicate(), Partial()], run_check=False)
        t.requires_grad_(True)
        lead = DTensor.from_local(torch.randn(4, 8, 2, device="meta"), mesh,
                                  [Replicate(), Shard(2)], run_check=False)
        lead.requires_grad_(True)
        # t's block split like the lead's heads, and whole (its gradient a
        # partial sum over "model") through local_of
        (y,) = AS.on_local_blocks(lambda a, b: (a * b,), (lead, t),
                                  ({"h": 2}, {"h": 2}), ({"h": 2},))
        z = AS.local_of(t, mesh, AS.P(), partial_over=("model",))
        y.sum().backward()
        z.sum().backward()
    assert ("Shard", "Partial") not in asked
    assert not any(isinstance(pl, Partial) for pl in t.grad.placements)


@pytest.mark.parametrize("form,mesh_shape", [
    ("whisper", (2, 2)),          # whisper's stream and attention output
    ("kv2", (2, 2)),              # a weight's heads x head_dim, FSDP-split
    ("moe_ep", (1, 4)),           # the EP output split on its sequence
])
def test_no_view_flattens_a_split_dim(form, mesh_shape):
    assert traced(form, mesh_shape).split_flattens == []


def test_split_key_decode_moves_neither_table_nor_cache():
    """The kv2 form's decode step at (1, 4): its 2 kv heads do not divide
    the model axis, so the cache is split on its sequence; no collective
    reads the table's block or a cache block (a unit's or a layer's), and
    no index op runs on a ``DTensor``."""
    moved = []
    sound = dryrun._Tally.dispatched

    def spy(self, func, args, kwargs, out):
        if str(func).split(".")[1] in COLLECTIVES:
            moved.append(tuple(args[0].shape))
        return sound(self, func, args, kwargs, out)
    dryrun._Tally.dispatched = spy
    try:
        mode = DTensorOps()
        dryrun.start_fake_group(4)
        try:
            fn, args, meta = dryrun.build_cell(
                smoke.mesh_form("kv2"), ShapeCell("d", 32, 4, "decode"),
                mesh_shape=(1, 4))
            params, _, _, cache = args
            blocks = {tuple(params["embed"].to_local().shape)}
            for t in tree_leaves(cache):
                blocks |= {tuple(t.to_local().shape),
                           tuple(t.to_local().shape[1:])}
            with AS.activation_sharding(meta["mesh"]), torch.no_grad(), \
                    dryrun._Tally(args), mode:
                fn(*args)
        finally:
            dist.destroy_process_group()
    finally:
        dryrun._Tally.dispatched = sound
    assert moved and not blocks & set(moved), blocks & set(moved)
    assert [op for op in mode.ops if op[0] in INDEX_OPS] == []
