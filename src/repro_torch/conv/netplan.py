"""Whole-network convolution planning (``plan_network`` / ``NetworkPlan``).

FFT convolution pays off when evaluated *network-wide*, not per layer: the
planning, the kernel transforms and the fused elementwise tails all
amortize across the whole model.  This module resolves every conv layer of
a model in ONE pass against the shared plan cache:

    net = plan_network([
        NetworkConv("conv1", x_shape, k_shape, padding=1,
                    epilogue=Epilogue(bias=True, activation="relu")),
        ...
    ], backend="fft-cuda")          # or mesh=mesh, schedule="nfft"

    # serving: one invalidation sweep per weight update
    prepared = net.prepare(params, weights_version=step)
    y = prepared["conv1"](x, bias=params["conv1/bias"])

``NetworkPlan.prepare`` runs each layer's kernel transform exactly once
per ``weights_version`` (repeat calls under the same version hit the
prepared cache; a new version after a weight update re-transforms
everything in one sweep).  ``plan_network(make_layers, buckets=batches)``
plans one network per padded batch bucket (a ``BucketedNetworkPlan``
view): the startup sweep of the continuous-batching serve engine
(``repro_torch.launch.batcher``).  The older ``prepare_all`` /
``plan_network_buckets`` / ``prepare_network_buckets`` / ``bucket_report``
spellings remain as DeprecationWarning shims.

``NetworkPlan.analyze`` runs the plan-lint analyzer
(``repro_torch.conv.analyze``) over every layer, and ``NetworkPlan.report``
aggregates its stage-op and collective counts for one forward pass.  Not
ported yet (it raises ``NotImplementedError``): ``BucketedNetworkPlan.export``
(it needs the plan artifacts).
"""
from __future__ import annotations

import collections
import dataclasses
import warnings
from typing import Any, Callable, Mapping, Optional, Sequence, Union

from repro_torch.conv.epilogue import Epilogue
from repro_torch.conv.plan import (
    ConvPlan, PreparedConv, plan_conv)


@dataclasses.dataclass(frozen=True)
class NetworkConv:
    """One conv layer of a model, as the network planner sees it.

    Geometry + the layer's fused epilogue; everything else (backend,
    schedule, precision) is shared network-wide via ``plan_network``
    kwargs, with ``overrides`` as the per-layer escape hatch (e.g. a tiny
    first layer that wants ``backend="direct"``).
    """
    name: str
    x_shape: tuple
    k_shape: tuple
    padding: Any = 0
    epilogue: Epilogue = Epilogue()
    overrides: tuple = ()        # (("backend", "direct"), ...) — hashable

    def plan_kwargs(self, shared: dict) -> dict:
        kw = dict(shared)
        kw.update(dict(self.overrides))
        kw["padding"] = self.padding
        kw["epilogue"] = self.epilogue
        return kw


@dataclasses.dataclass(frozen=True, eq=False)
class PreparedNetwork:
    """All layers of a ``NetworkPlan`` bound to prepared kernels.

    Mapping-like: ``prepared["conv1"](x, bias=...)``.  Every layer shares
    one ``weights_version``; re-prepare the network (not a layer) after a
    weight update.
    """
    layers: "collections.OrderedDict[str, PreparedConv]"
    weights_version: Any = None

    def __getitem__(self, name: str) -> PreparedConv:
        return self.layers[name]

    def __iter__(self):
        return iter(self.layers)

    def __len__(self):
        return len(self.layers)

    def items(self):
        return self.layers.items()


@dataclasses.dataclass(frozen=True, eq=False)
class NetworkProfile:
    """Per-layer static-analysis profiles for a whole network, plus the
    aggregate collective/stage totals one forward pass pays.  Certify
    every layer against the invariant registry with ``check()``."""
    layers: "collections.OrderedDict"          # name -> PlanProfile
    total_collectives: dict
    total_stage_counts: dict
    total_collective_bytes: int
    peak_live_bytes: int                       # max over layers

    def check(self):
        """Evaluate the invariant registry for every layer; returns a
        list of ``(layer_name, Violation)`` (empty = certified)."""
        out = []
        for name, profile in self.layers.items():
            out.extend((name, v) for v in profile.check().violations)
        return out

    def raise_if_failed(self) -> "NetworkProfile":
        bad = self.check()
        if bad:
            detail = "\n  ".join(f"{n}: {v}" for n, v in bad)
            raise AssertionError(
                f"plan-lint: network violates {len(bad)} invariant(s):"
                f"\n  {detail}")
        return self

    def to_dict(self) -> dict:
        return {
            "layers": {n: p.to_dict() for n, p in self.layers.items()},
            "total_collectives": dict(self.total_collectives),
            "total_stage_counts": dict(self.total_stage_counts),
            "total_collective_bytes": self.total_collective_bytes,
            "peak_live_bytes": self.peak_live_bytes,
        }


def _same_tile(cfg, plan) -> bool:
    """Whether a tuned config's CGEMM tile is the plan's: the same row,
    or none where the planner pinned one (an overlapped ``fft-cuda`` plan
    pins the row of its smallest sub-slab when no tile is named)."""
    if (cfg.bm, cfg.bn, cfg.bk) == (plan.bm, plan.bn, plan.bk):
        return True
    return (cfg.bm, cfg.bn, cfg.bk) == (None, None, None) \
        and plan.backend == "fft-cuda" and plan.num_slabs > 1


@dataclasses.dataclass(frozen=True, eq=False)
class NetworkPlan:
    """Every conv layer of a model resolved to a ``ConvPlan`` in one pass.

    ``plans`` preserves layer order.  Same-geometry layers resolve to the
    *same* cached ``ConvPlan`` object (the shared plan cache deduplicates),
    so planning cost scales with distinct geometries, not layer count.
    """
    plans: "collections.OrderedDict[str, ConvPlan]"

    def __getitem__(self, name: str) -> ConvPlan:
        return self.plans[name]

    def __iter__(self):
        return iter(self.plans)

    def __len__(self):
        return len(self.plans)

    def items(self):
        return self.plans.items()

    @property
    def layer_names(self) -> tuple:
        return tuple(self.plans)

    def prepare(self, params: Mapping[str, Any], *,
                weights_version=None) -> PreparedNetwork:
        """Prepare every layer's kernel under one ``weights_version``.

        ``params`` maps layer name -> kernel tensor (extra keys — biases,
        dense weights — are ignored, so a model's full param dict works).
        The kernel transform runs exactly once per layer per version:
        repeat calls with the same version return memoized
        ``PreparedConv`` objects from the prepared cache; a new version is
        one invalidation sweep re-transforming the whole net.
        """
        missing = [n for n in self.plans if n not in params]
        if missing:
            raise ValueError(
                f"prepare: params missing kernels for layers {missing}")
        layers = collections.OrderedDict(
            (name, plan.prepare(params[name],
                                weights_version=weights_version))
            for name, plan in self.plans.items())
        return PreparedNetwork(layers=layers,
                               weights_version=weights_version)

    def prepare_all(self, params: Mapping[str, Any], *,
                    weights_version=None) -> PreparedNetwork:
        """Deprecated spelling of ``NetworkPlan.prepare``."""
        warnings.warn(
            "NetworkPlan.prepare_all is deprecated; use "
            "NetworkPlan.prepare(params, weights_version=...)",
            DeprecationWarning, stacklevel=2)
        return self.prepare(params, weights_version=weights_version)

    def tuning_report(self) -> dict:
        """Per-layer autotune winners after a ``backend="tuned"`` planning
        sweep: the resolved (backend, schedule, spectrum, tile, ``dft_bt``,
        overlap) of every layer, plus the measured timing and provenance
        when the tuning cache has an entry for the layer's geometry (and
        mesh) that describes this plan's config (``us_per_call`` is
        ``None`` for layers resolved by the cost model or planned with a
        non-tuned backend).  The cache is read for the measuring device
        (``autotune.measure_on``, else the GPU)."""
        from repro_torch.conv import autotune
        out = {}
        for name, plan in self.plans.items():
            cfg = None
            for sched_req in (plan.schedule, "auto"):
                for ov_req in (plan.overlap, "auto"):
                    c = autotune.lookup(
                        plan.x_shape, plan.k_shape, padding=plan.padding,
                        delta=plan.spec.delta, schedule=sched_req,
                        mesh=plan.mesh, three_m=plan.three_m,
                        compute_dtype=plan.compute_dtype,
                        data_axis=plan.data_axis,
                        model_axis=plan.model_axis,
                        replicate_kernel_transform=(
                            plan.replicate_kernel_transform),
                        overlap=ov_req)
                    # only attribute a timing that describes THIS plan's
                    # resolved config: the cache may hold a different
                    # request's winner for the same geometry
                    if c is not None and (
                            c.backend, c.schedule, c.dft_bt, c.overlap
                    ) == (plan.backend, plan.schedule, plan.dft_bt,
                          plan.overlap) and _same_tile(c, plan):
                        cfg = c
                        break
                if cfg is not None:
                    break
            out[name] = {
                "backend": plan.backend, "schedule": plan.schedule,
                "spectrum": plan.spectrum,
                "bm": plan.bm, "bn": plan.bn, "bk": plan.bk,
                "dft_bt": plan.dft_bt, "overlap": plan.overlap,
                "us_per_call": cfg.us_per_call if cfg else None,
                "source": cfg.source if cfg else "unmeasured",
            }
        return out

    def analyze(self, *, device=None) -> NetworkProfile:
        """Static analysis of every layer (``repro_torch.conv.analyze``,
        on fake tensors on ``device``): the per-layer ``PlanProfile`` plus
        network totals.  Same-geometry layers sharing one plan are
        profiled once each so the totals reflect one full forward pass."""
        from repro_torch.conv.analyze import analyze
        total_stages: collections.Counter = collections.Counter()
        total_coll: collections.Counter = collections.Counter()
        total_bytes = 0
        peak = 0
        profiles: "collections.OrderedDict" = collections.OrderedDict()
        for name, plan in self.plans.items():
            p = analyze(plan, device=device)
            profiles[name] = p
            total_stages.update(p.stage_counts)
            total_coll.update(p.collectives)
            total_bytes += p.collective_bytes
            peak = max(peak, p.peak_live_bytes)
        return NetworkProfile(
            layers=profiles, total_collectives=dict(total_coll),
            total_stage_counts=dict(total_stages),
            total_collective_bytes=total_bytes, peak_live_bytes=peak)

    def report(self) -> dict:
        """Aggregate stage-op and collective counts for one forward pass
        of the whole net (one-shot plans), plus cost-model FLOPs.  Counts
        come from the static analyzer running each layer on fake tensors
        and recording what it dispatches, so the numbers reflect what
        actually executes, schedule by schedule."""
        net = self.analyze()
        per_layer = {}
        total_flops = 0
        for name, plan in self.plans.items():
            p = net.layers[name]
            flops = plan.flops()
            per_layer[name] = {
                "backend": plan.backend, "schedule": plan.schedule,
                "epilogue": plan.epilogue.describe(),
                "stage_counts": dict(p.stage_counts),
                "collectives": dict(p.collectives),
                "flops": flops,
            }
            total_flops += flops
        return {
            "layers": per_layer,
            "total_stage_counts": dict(net.total_stage_counts),
            "total_collectives": dict(net.total_collectives),
            "total_flops": total_flops,
            "n_layers": len(self.plans),
            "n_distinct_plans": len({id(p) for p in self.plans.values()}),
        }

    def describe(self) -> str:
        rep = self.report()
        lines = [f"NetworkPlan: {rep['n_layers']} layers, "
                 f"{rep['n_distinct_plans']} distinct plans, "
                 f"{rep['total_flops']:.3e} FLOPs/pass"]
        meshes = dict.fromkeys(p.mesh for p in self.plans.values()
                               if p.mesh is not None)
        for mesh in meshes:
            axes = " x ".join(f"{a}={n}" for a, n in
                              zip(mesh.mesh_dim_names, mesh.shape))
            lines.append(f"  mesh {axes} ({mesh.device_type})")
        for name, r in rep["layers"].items():
            coll = ", ".join(f"{k}={v}" for k, v in r["collectives"].items()
                             if v) or "none"
            plan = self.plans[name]
            lines.append(
                f"  {name}: {r['backend']}/{r['schedule']} "
                f"overlap={plan.overlap} epilogue={r['epilogue']} "
                f"flops={r['flops']:.3e} collectives: {coll}")
        t = rep["total_collectives"]
        lines.append(f"  total collectives/pass: "
                     f"all_to_all={t.get('all_to_all', 0)} "
                     f"psum={t.get('psum', 0)}")
        return "\n".join(lines)


@dataclasses.dataclass(frozen=True, eq=False)
class BucketedNetworkPlan:
    """One ``NetworkPlan`` per padded batch-size bucket: the serve
    engine's startup sweep as a first-class view.  Mapping-like over
    ``bucket -> NetworkPlan``; ``prepare`` sweeps every bucket under ONE
    ``weights_version``."""
    nets: "collections.OrderedDict[int, NetworkPlan]"

    def __getitem__(self, bucket: int) -> NetworkPlan:
        return self.nets[bucket]

    def __iter__(self):
        return iter(self.nets)

    def __len__(self):
        return len(self.nets)

    def items(self):
        return self.nets.items()

    def keys(self):
        return self.nets.keys()

    def values(self):
        return self.nets.values()

    def prepare(self, params: Mapping[str, Any], *,
                weights_version=None) -> "collections.OrderedDict":
        """``NetworkPlan.prepare`` for every bucket under ONE
        ``weights_version``: each distinct (plan, kernel) pair
        transforms once (buckets sharing a geometry hit the prepared
        cache), and a weight update is one sweep re-preparing all
        buckets under the next version."""
        return collections.OrderedDict(
            (b, net.prepare(params, weights_version=weights_version))
            for b, net in self.nets.items())

    def report(self) -> dict:
        """Cross-bucket dedupe and cost summary: how many *distinct*
        frozen plans the bucket set resolves to (the shared-cache dedupe
        the serve engine relies on), plus per-bucket layer counts and
        FLOPs/pass."""
        return _bucket_report(self.nets)

    def export(self, path: str,
               params: Optional[Mapping[str, Any]] = None, *,
               weights_version=None) -> str:
        """AOT plan artifacts: not ported yet (ROADMAP Queue 1 item 7)."""
        raise NotImplementedError(
            "BucketedNetworkPlan.export is not yet ported to repro_torch: "
            "it needs the plan artifacts (ROADMAP Queue 1 item 7)")


def plan_network(layers: Union[Sequence[NetworkConv], Callable], *,
                 buckets: Optional[Sequence[int]] = None,
                 backend: str = "auto", schedule: str = "auto", mesh=None,
                 delta: int = 16, three_m: bool = True, compute_dtype=None,
                 data_axis: str = "data", model_axis: str = "model",
                 replicate_kernel_transform: bool = False,
                 spectrum: str = "auto", overlap: str = "off"):
    """Resolve every conv layer of a model in one planning pass.

    All layers share the network-wide knobs given here (backend, schedule,
    precision); a ``NetworkConv.overrides`` tuple adjusts individual
    layers.  Resolution goes through the shared ``plan_conv`` cache, so
    same-geometry layers (and repeat ``plan_network`` calls) share frozen
    ``ConvPlan`` objects.  ``mesh``, its axes, ``schedule``,
    ``replicate_kernel_transform`` and ``overlap`` pass through to
    ``plan_conv``: on a mesh every layer is sharded, its output is the
    ``DTensor`` (B over ``data_axis``, channels over ``model_axis``) that
    the next sharded layer takes as it is, with no gather in between.

    With ``buckets=batches``, ``layers`` must instead be a callable
    ``make_layers(batch)`` returning the ``NetworkConv`` sequence for one
    padded batch size; the result is a ``BucketedNetworkPlan`` (one
    ``NetworkPlan`` per bucket, shared-cache dedupe across buckets): the
    startup sweep of the continuous-batching serve engine.

    ``backend="tuned"`` measures each distinct layer geometry once (the
    tuning cache answers every repeat, across buckets too) on the device
    of ``autotune.measure_on``, all while planning: a serve engine's
    captures come after.  ``NetworkPlan.tuning_report`` lists the winners.
    """
    shared = dict(backend=backend, schedule=schedule, mesh=mesh, delta=delta,
                  three_m=three_m, compute_dtype=compute_dtype,
                  data_axis=data_axis, model_axis=model_axis,
                  replicate_kernel_transform=replicate_kernel_transform,
                  spectrum=spectrum, overlap=overlap)
    if buckets is not None:
        if not callable(layers):
            raise TypeError(
                "plan_network(..., buckets=...) needs a make_layers(batch) "
                "callable, not a layer sequence")
        dupes = [b for b, c in collections.Counter(buckets).items()
                 if c > 1]
        if dupes:
            raise ValueError(f"duplicate bucket batch sizes: {dupes}")
        nets = collections.OrderedDict(
            (int(b), plan_network(layers(int(b)), **shared))
            for b in buckets)
        return BucketedNetworkPlan(nets=nets)
    if callable(layers):
        raise TypeError(
            "plan_network got a callable layer factory; pass buckets= "
            "to plan per batch bucket, or the layer sequence itself")
    names = [l.name for l in layers]
    dupes = [n for n, c in collections.Counter(names).items() if c > 1]
    if dupes:
        raise ValueError(f"duplicate layer names: {dupes}")
    plans = collections.OrderedDict(
        (l.name, plan_conv(l.x_shape, l.k_shape, **l.plan_kwargs(shared)))
        for l in layers)
    return NetworkPlan(plans=plans)


def _bucket_report(nets: Mapping[Any, NetworkPlan]) -> dict:
    """Cross-bucket dedupe/cost summary over any label -> NetworkPlan
    mapping (shared by ``BucketedNetworkPlan.report`` and the serve
    engine's label-keyed view)."""
    distinct = {id(p) for net in nets.values()
                for p in net.plans.values()}
    per_bucket = {
        b: {"n_layers": len(net),
            "flops_per_pass": sum(p.flops() for p in net.plans.values())}
        for b, net in nets.items()}
    total_layers = sum(len(net) for net in nets.values())
    return {
        "n_buckets": len(nets),
        "n_layer_plans": total_layers,
        "n_distinct_plans": len(distinct),
        "dedupe_ratio": (len(distinct) / total_layers if total_layers
                         else 1.0),
        "buckets": per_bucket,
    }


# --------------------------------------------------------------------------
# Deprecated bucket-helper shims (pre-BucketedNetworkPlan spellings)
# --------------------------------------------------------------------------

def plan_network_buckets(make_layers, batches: Sequence[int],
                         **plan_kwargs) -> BucketedNetworkPlan:
    """Deprecated: use ``plan_network(make_layers, buckets=batches)``."""
    warnings.warn(
        "plan_network_buckets is deprecated; use "
        "plan_network(make_layers, buckets=batches)",
        DeprecationWarning, stacklevel=2)
    return plan_network(make_layers, buckets=batches, **plan_kwargs)


def prepare_network_buckets(nets: Mapping[int, NetworkPlan],
                            params: Mapping[str, Any], *,
                            weights_version=None
                            ) -> "collections.OrderedDict":
    """Deprecated: use ``BucketedNetworkPlan.prepare``."""
    warnings.warn(
        "prepare_network_buckets is deprecated; use "
        "BucketedNetworkPlan.prepare(params, weights_version=...)",
        DeprecationWarning, stacklevel=2)
    return collections.OrderedDict(
        (b, net.prepare(params, weights_version=weights_version))
        for b, net in nets.items())


def bucket_report(nets: Mapping[Any, NetworkPlan]) -> dict:
    """Deprecated: use ``BucketedNetworkPlan.report``."""
    warnings.warn(
        "bucket_report is deprecated; use BucketedNetworkPlan.report()",
        DeprecationWarning, stacklevel=2)
    return _bucket_report(nets)
