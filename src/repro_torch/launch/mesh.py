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
