"""Meshes of ranks for the sharded schedules (``nfft`` / ``wfft``).

The twin of ``repro.launch.mesh`` (and of ``repro.compat.make_mesh``) over
``torch.distributed``: a mesh is a ``DeviceMesh`` with named dims, laid
over the ranks of a process group that the caller started.  Every rank
runs the same program (SPMD), builds the same mesh and calls the same
plans.  Functions, not module constants: importing this module starts
no process group and touches no device.

    start_process_group(device_id=torch.device("cuda", r), rank=r,
                        world_size=n, store_path=path)          # NCCL
    mesh = make_mesh(shape, ("data", "model"))                  # GPU
    ...
    destroy_process_group()

On the host, ``start_process_group("gloo", ...)`` and
``make_host_mesh(n_data, n_model)``.  NCCL takes one rank per GPU: one
card runs a one-rank mesh.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def start_process_group(backend: str | None = None, *, rank: int = 0,
                        world_size: int = 1, store_path=None,
                        device_id=None) -> None:
    """Start the default process group from an explicit store: an
    in-memory ``HashStore`` for one rank, or a ``FileStore`` at
    ``store_path`` that every rank of ``world_size`` opens.  No TCP port
    is taken, so concurrent test processes never contend for one.
    ``backend=None`` means ``"nccl"`` and raises without a GPU; pass
    ``"gloo"`` for host ranks.  ``device_id`` binds an NCCL group to its
    GPU at start."""
    if backend is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass backend='gloo' for a "
                "process group of host ranks")
        backend = "nccl"
    if store_path is None:
        if world_size != 1:
            raise ValueError(
                f"{world_size} ranks need a shared store: pass store_path "
                "(a FileStore path every rank opens)")
        store = dist.HashStore()
    else:
        store = dist.FileStore(str(store_path), world_size)
    kwargs = {} if device_id is None else {"device_id": device_id}
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world_size, **kwargs)


def destroy_process_group() -> None:
    """Destroy the default process group, and first drop every cached
    plan and prepared kernel: a cached sharded plan holds a mesh whose
    groups die with the process group."""
    from repro_torch.conv import clear_plan_cache, clear_prepared_cache
    clear_plan_cache()
    clear_prepared_cache()
    dist.destroy_process_group()


def make_mesh(shape, axis_names, device_type=None):
    """A ``DeviceMesh`` of ``shape`` with dims named ``axis_names`` over
    the first ranks of the started process group, in row-major order.
    ``device_type=None`` means ``cuda`` and raises without a GPU; a
    ``cuda`` mesh needs an NCCL group (gloo would stage every collective
    of card tensors through the host)."""
    from torch.distributed.device_mesh import DeviceMesh
    shape, axis_names = tuple(map(int, shape)), tuple(axis_names)
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} and axis names {axis_names} "
                         "differ in length")
    if device_type is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device_type='cpu' for "
                "a mesh of host ranks")
        device_type = "cuda"
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a started process group "
                           "(start_process_group)")
    if device_type == "cuda" and "nccl" not in dist.get_backend():
        raise RuntimeError(
            f"a cuda mesh needs an NCCL process group, found "
            f"{dist.get_backend()!r}: start_process_group() on the GPU, or "
            "device_type='cpu' for host ranks")
    n = 1
    for s in shape:
        n *= s
    world = dist.get_world_size()
    if world < n:
        raise RuntimeError(
            f"mesh {shape} needs {n} ranks, found {world}: start the "
            f"process group with world_size={n}")
    return DeviceMesh(device_type, torch.arange(n).reshape(shape),
                      mesh_dim_names=axis_names)


def make_host_mesh(n_data: int, n_model: int):
    """Small mesh over host (CPU, gloo) ranks for tests."""
    return make_mesh((n_data, n_model), ("data", "model"),
                     device_type="cpu")


def dp_axes(mesh) -> tuple:
    """Data-parallel axes of a mesh (pod included when present)."""
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))


class RankDecisions:
    """Decisions that every rank of a mesh must take alike (the tuner's
    sweep, the serving engine's batches): rank 0 of the mesh (all
    coordinates 0) decides, a broadcast along each mesh dim in turn
    carries its word to every rank, and an all-reduce ``MAX`` along each
    dim in turn gives every rank the slowest time and any rank's flag
    (``decide`` carries a word of ints and a check in that all-reduce
    alone).
    The mesh's own dim groups carry them (NCCL on a ``cuda`` mesh, then
    on the current CUDA device; gloo on a ``cpu`` mesh): no process group
    is opened.  Without a mesh there is one process, and each call
    returns what it was given.  ``what`` names the caller in errors;
    ``broadcasts`` counts the words carried."""

    def __init__(self, mesh, *, what: str):
        self.what = what
        self.groups = ([] if mesh is None else
                       [mesh.get_group(d) for d in range(mesh.ndim)])
        self.root = True
        self.broadcasts = 0
        self.device = torch.device("cpu")
        if mesh is not None:
            coord = mesh.get_coordinate()
            if coord is None:
                raise RuntimeError(
                    f"{what}: this rank is not in the mesh it runs on")
            self.root = not any(coord)
            if mesh.device_type == "cuda":
                self.device = torch.device("cuda",
                                           torch.cuda.current_device())

    def broadcast(self, obj):
        """Rank 0's ``obj`` on every rank (the others' is ignored)."""
        if self.groups:
            self.broadcasts += 1
        for group in self.groups:
            box = [obj]
            dist.broadcast_object_list(
                box, src=dist.get_global_rank(group, 0), group=group,
                device=self.device)
            obj = box[0]
        return obj

    def decide(self, word, length: int, *, check: int) -> tuple:
        """Rank 0's ``word`` (at most ``length`` ints >= 0; the others'
        is ignored) on every rank, and whether every rank gave the same
        ``check`` (an int in [0, 2**62)), in one fixed-size int64
        all-reduce ``MAX`` along each mesh dim: the other ranks send -1 in
        the word's place, and each rank its check beside its negation.
        Returns (the word padded with -1 to ``length``, agreed)."""
        pad = [-1] * (length - len(word))
        if not self.groups:
            return list(word) + pad, True
        self.broadcasts += 1
        mine = list(word) + pad if self.root else [-1] * length
        t = torch.tensor(mine + [check, -check],
                         dtype=torch.int64).to(self.device)
        for group in self.groups:
            dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
        *word, top, neg_bottom = t.tolist()
        return word, top == -neg_bottom

    def _max(self, values) -> list:
        t = torch.tensor(values, dtype=torch.float64, device=self.device)
        for group in self.groups:
            dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
        return t.tolist()

    def any(self, flag: bool) -> bool:
        """Whether ``flag`` is true on any rank."""
        return bool(self._max([float(flag)])[0]) if self.groups else flag

    def slowest(self, us: float) -> float:
        """The largest of the ranks' times; raises if a rank's
        measurement failed (``fail``)."""
        if not self.groups:
            return us
        us, failed = self._max([us, 0.0])
        if failed:
            raise RuntimeError(
                f"{self.what}: a candidate's measurement failed on another "
                "rank of the mesh")
        return us

    def fail(self) -> None:
        """Tell the other ranks, waiting in ``slowest``, that this rank's
        measurement failed."""
        if self.groups:
            self._max([0.0, 1.0])
