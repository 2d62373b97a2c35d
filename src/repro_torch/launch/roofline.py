"""Roofline terms of a traced step (the twin of ``repro.launch.roofline``).

Hardware model (NVIDIA H100 SXM at its 700 W limit, the card's published
peaks):
    peak bf16 dense compute   989 TFLOP/s per rank
    HBM3 bandwidth            3.35 TB/s per rank
    NVLink                    450 GB/s per rank, each way

Terms (seconds):
    compute    = FLOPs      / (ranks * peak_flops)
    memory     = HBM bytes  / (ranks * hbm_bw)
    collective = coll_bytes / (ranks * link_bw)

The FLOPs and bytes are global (``launch.analytic``) and divided by the
rank count before they come here, so each term is a per-rank value over a
per-rank rate.  The rates are arguments with the H100's as defaults: the
reference's TPU v5e rates (197e12, 819e9, 50e9) give the reference's
terms.

Collective bytes: the reference parses them out of compiled HLO text.  The
port has no compiled program, so ``CollectiveCounter`` (a
``TorchDispatchMode``) counts each collective that a trace dispatches, by
the HLO op kind it is (``all-gather``, ``all-reduce``, ``reduce-scatter``,
``all-to-all``, ``collective-permute``), and sums its per-rank result
bytes: the ``_c10d_functional`` ops that ``DTensor`` issues, ``DTensor``'s
``_dtensor.shard_dim_alltoall``, and the ``c10d`` ops of
``torch.distributed``'s calls (the expert-parallel MoE's
``all_to_all_single``).  The op table is plan-lint's
(``conv/analyze.py`` ``_COLLECTIVE_OPS``).
"""
from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.conv.analyze import _COLLECTIVE_OPS, _nbytes

# NVIDIA H100 SXM5 80GB at 700 W, published peaks
PEAK_FLOPS = 989e12        # dense bf16 FLOP/s per rank
HBM_BW = 3.35e12           # B/s per rank
LINK_BW = 450e9            # NVLink B/s per rank, each way

COLL_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
              "collective-permute")


def collective_kind(func):
    """(the HLO kind of op ``func``, the argument index that holds its
    result, or None when it returns it) if ``func`` is a collective of the
    table, else None."""
    ns, _, name = func._schema.name.partition("::")
    entry = _COLLECTIVE_OPS.get((ns, name))
    if entry is None or entry[2] is None:
        return None
    return entry[2], entry[3]


def _is_dtensor_type(t) -> bool:
    from torch.distributed.tensor import DTensor
    return issubclass(t, DTensor)


def shape_propagation(args, out) -> bool:
    """Whether an op runs on fake tensors: ``DTensor``'s sharding
    propagation runs each op once at its global shape under a
    ``FakeTensorMode`` to learn its output's metadata.  Such a run is not
    part of the step."""
    from torch._subclasses.fake_tensor import FakeTensor
    if torch._C._get_dispatch_mode(
            torch._C._TorchDispatchModeKey.FAKE) is not None:
        return True
    return any(isinstance(t, FakeTensor) for t in tree_flatten((args, out))[0])


class CollectiveCounter(TorchDispatchMode):
    """Counts the collectives dispatched while it is active, by HLO kind,
    with their per-rank result bytes.  An op on ``DTensor``s is handed on
    (``NotImplemented``), so that the mode sees the local ops and the
    collectives that ``DTensor`` runs for it, as one rank runs them;
    ``DTensor``'s fake shape propagation is not counted.  Subclasses
    extend ``dispatched``, which sees every local op and its output."""

    def __init__(self):
        super().__init__()
        self.bytes = dict.fromkeys(COLL_KINDS, 0)
        self.counts = dict.fromkeys(COLL_KINDS, 0)
        self.ops = {}                  # "ns.op" -> count, as dispatched

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(_is_dtensor_type(t) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not shape_propagation((args, kwargs), out):
            self.dispatched(func, args, kwargs, out)
        return out

    def dispatched(self, func, args, kwargs, out) -> None:
        found = collective_kind(func)
        if found is None:
            return
        kind, result = found
        self.counts[kind] += 1
        self.bytes[kind] += _nbytes(out if result is None else args[result])
        name = func._schema.name.replace("::", ".")
        self.ops[name] = self.ops.get(name, 0) + 1

    def result(self) -> dict:
        """The reference's ``parse_collectives`` record: ``{"bytes": {kind:
        ...}, "counts": {kind: ...}, "total_bytes": ...}``, per rank."""
        return {"bytes": dict(self.bytes), "counts": dict(self.counts),
                "total_bytes": sum(self.bytes.values())}


def roofline_terms(flops_per_dev: float, bytes_per_dev: float,
                   coll_bytes_per_dev: float, *, peak_flops=PEAK_FLOPS,
                   hbm_bw=HBM_BW, link_bw=LINK_BW) -> dict:
    comp = flops_per_dev / peak_flops
    mem = bytes_per_dev / hbm_bw
    coll = coll_bytes_per_dev / link_bw
    dom = max(("compute", comp), ("memory", mem), ("collective", coll),
              key=lambda kv: kv[1])
    total = max(comp, mem, coll)
    return {
        "compute_s": comp, "memory_s": mem, "collective_s": coll,
        "dominant": dom[0],
        # the least time the step can take on the dominant term
        "bound_s": total,
    }


def model_flops(n_params_active: int, tokens: int, *, train: bool) -> float:
    """MODEL_FLOPS = 6*N*D for training (fwd+bwd), 2*N*D for inference."""
    return (6.0 if train else 2.0) * n_params_active * tokens
