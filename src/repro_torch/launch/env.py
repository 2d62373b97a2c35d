"""Process environment for a mesh of host ranks (the twin of
``repro.launch.env``).

The reference emulates the paper's NUMA mesh on one host by splitting the
CPU into N XLA host devices, through ``XLA_FLAGS`` that XLA reads once, at
backend start.  The port's mesh is one process a rank (gloo on the host,
NCCL on the GPUs), and what each rank's runtime reads once, at start, is
its environment:

  ``OMP_NUM_THREADS=<host cores // N>``
      Each rank's share of the host's cores: the emulated NUMA node.
      torch sizes its intra-op thread pool from it when the pool starts,
      so N ranks of the default size would each start one thread a core
      and oversubscribe the host N times (every spawned host rank of the
      port's tests runs with 1).
  ``GLOO_SOCKET_IFNAME=lo``
      gloo picks the network device its pairs use when a process group
      starts, from the host name unless told; the ranks of one host talk
      over the loopback device, which needs no network.

The rank count itself is the ``world_size`` the caller starts
(``launch.mesh.start_process_group``), not a variable, and the port's
communication overlap (``overlap="slab:<k>"``) is a plan option whose
collectives are issued with ``async_op=True``: neither needs one.

    # parent shell, before the ranks start
    export $(python -m repro_torch.launch.env --ndev 4 --print)

    # or at the top of a rank's entry point, before its process group
    from repro_torch.launch import env
    env.apply(ndev=4)

This module imports no torch, so the environment can be composed before
torch starts.  ``apply`` raises once a process group or CUDA has started
in this process, because the variables would be silently ignored.
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import Dict, Optional, Tuple


def _cores() -> int:
    try:
        return len(os.sched_getaffinity(0))
    except AttributeError:                   # not on Linux
        return os.cpu_count() or 1


def rank_env(ndev: int, *, cores: Optional[int] = None,
             extra: Tuple[Tuple[str, str], ...] = ()) -> Dict[str, str]:
    """The variables each rank of an ``ndev``-rank host mesh reads at
    start: its share of ``cores`` (default: this process's) and the
    loopback device.  ``extra`` appends caller (name, value) pairs, which
    win."""
    ndev = int(ndev)
    if ndev < 1:
        raise ValueError(f"ndev must be >= 1, got {ndev}")
    cores = _cores() if cores is None else int(cores)
    out = {"OMP_NUM_THREADS": str(max(1, cores // ndev)),
           "GLOO_SOCKET_IFNAME": "lo"}
    out.update(dict(extra))
    return out


def _started() -> Optional[str]:
    """What has started in this process that reads the variables once:
    a process group, CUDA, or None."""
    torch = sys.modules.get("torch")
    if torch is None:
        return None
    dist = getattr(torch, "distributed", None)
    if dist is not None and dist.is_available() and dist.is_initialized():
        return "a process group"
    if torch.cuda.is_initialized():
        return "CUDA"
    return None


def apply(ndev: int, *, cores: Optional[int] = None,
          extra: Tuple[Tuple[str, str], ...] = (),
          env: Optional[dict] = None) -> Dict[str, str]:
    """Install ``rank_env(ndev)`` into the process environment (or into
    ``env``).  Must run before this process starts its process group and
    CUDA: raises ``RuntimeError`` after either, as they read their
    variables once.  Where torch is imported already, its thread pool is
    sized too (``torch.set_num_threads``).  Returns the variables
    installed."""
    values = rank_env(ndev, cores=cores, extra=extra)
    if env is None:
        started = _started()
        if started:
            raise RuntimeError(
                f"repro_torch.launch.env.apply() called after {started} "
                "started: torch.distributed, gloo, NCCL and CUDA read "
                "their environment once, so these variables would be "
                "silently ignored.  Call apply() before "
                "start_process_group, or export them in the parent shell "
                "(`python -m repro_torch.launch.env --ndev N --print`).")
        env = os.environ
        torch = sys.modules.get("torch")
        if torch is not None:
            torch.set_num_threads(int(values["OMP_NUM_THREADS"]))
    env.update(values)
    return values


def mesh_shape(ndev: int, *, model: int = 1) -> Tuple[int, int]:
    """(data, model) mesh shape over ``ndev`` ranks: all parallelism on
    the data (batch) axis unless ``model`` divides it out (``ndev=8,
    model=2`` -> ``(4, 2)``)."""
    ndev, model = int(ndev), int(model)
    if model < 1 or ndev % model:
        raise ValueError(f"model={model} must divide ndev={ndev}")
    return (ndev // model, model)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="host-rank environment (see repro_torch.launch.env)")
    ap.add_argument("--ndev", type=int, default=4,
                    help="host rank count (default 4)")
    ap.add_argument("--print", action="store_true", dest="print_env",
                    help="print NAME=VALUE pairs and exit (for "
                         "`export $(... --print)`)")
    args = ap.parse_args(argv)
    values = rank_env(args.ndev)
    line = " ".join(f"{k}={v}" for k, v in values.items())
    if args.print_env:
        print(line)
        return 0
    # no --print: show what apply() would install, plus the mesh it implies
    print(line)
    print(f"mesh_shape(data, model) = {mesh_shape(args.ndev)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
