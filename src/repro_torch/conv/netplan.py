"""Whole-network convolution planning (``plan_network`` / ``NetworkPlan``).

FFT convolution pays off when evaluated *network-wide*, not per layer: the
planning, the kernel transforms and the fused elementwise tails all
amortize across the whole model.  This module resolves every conv layer of
a model in ONE pass against the shared plan cache:

    net = plan_network([
        NetworkConv("conv1", x_shape, k_shape, padding=1,
                    epilogue=Epilogue(bias=True, activation="relu")),
        ...
    ], backend="fft-cuda")

    # serving: one invalidation sweep per weight update
    prepared = net.prepare(params, weights_version=step)
    y = prepared["conv1"](x, bias=params["conv1/bias"])

``NetworkPlan.prepare`` runs each layer's kernel transform exactly once
per ``weights_version`` (repeat calls under the same version hit the
prepared cache; a new version after a weight update re-transforms
everything in one sweep).  Batch buckets (``buckets=``) come with the
continuous-batching engine and are not ported yet.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Any, Mapping, Sequence

from repro_torch.conv.epilogue import Epilogue
from repro_torch.conv.plan import ConvPlan, PreparedConv, plan_conv


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

    def describe(self) -> str:
        total = sum(p.flops() for p in self.plans.values())
        distinct = len({id(p) for p in self.plans.values()})
        lines = [f"NetworkPlan: {len(self.plans)} layers, {distinct} "
                 f"distinct plans, {total:.3e} FLOPs/pass"]
        for name, plan in self.plans.items():
            lines.append(
                f"  {name}: {plan.backend}/{plan.schedule} "
                f"epilogue={plan.epilogue.describe()} "
                f"flops={plan.flops():.3e}")
        return "\n".join(lines)


def plan_network(layers: Sequence[NetworkConv], *,
                 backend: str = "auto", schedule: str = "auto", mesh=None,
                 delta: int = 16, three_m: bool = True, compute_dtype=None,
                 spectrum: str = "auto", overlap: str = "off"):
    """Resolve every conv layer of a model in one planning pass.

    All layers share the network-wide knobs given here (backend, schedule,
    precision); a ``NetworkConv.overrides`` tuple adjusts individual
    layers.  Resolution goes through the shared ``plan_conv`` cache, so
    same-geometry layers (and repeat ``plan_network`` calls) share frozen
    ``ConvPlan`` objects.  ``mesh`` and ``overlap`` are passed through to
    ``plan_conv``, which rejects a mesh and a slab overlap until they are
    ported (``overlap="auto"`` resolves to ``"off"``) and ``fft-cuda``
    beyond its kernels' tile limit.
    """
    if callable(layers):
        raise TypeError(
            "plan_network got a callable layer factory: batch buckets are "
            "not yet ported to repro_torch; pass the layer sequence")
    shared = dict(backend=backend, schedule=schedule, mesh=mesh, delta=delta,
                  three_m=three_m, compute_dtype=compute_dtype,
                  spectrum=spectrum, overlap=overlap)
    names = [l.name for l in layers]
    dupes = [n for n, c in collections.Counter(names).items() if c > 1]
    if dupes:
        raise ValueError(f"duplicate layer names: {dupes}")
    plans = collections.OrderedDict(
        (l.name, plan_conv(l.x_shape, l.k_shape, **l.plan_kwargs(shared)))
        for l in layers)
    return NetworkPlan(plans=plans)
