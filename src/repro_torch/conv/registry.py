"""Backend / schedule registry for the plan-execute convolution engine.

A *backend* is a compute implementation (direct cuDNN conv, the PyTorch
FFT-conv stage graph, the same graph on the hand-written CUDA kernels,
...); a *schedule* is a data-movement strategy (single-device ``local``,
or the mesh-sharded ``nfft`` / ``wfft`` of the paper).  Backends declare
which schedules they support; ``plan_conv`` resolves a (backend,
schedule) pair and the plan dispatches through this registry at execute
time.

A backend is registered in one of two forms:

  * **stage-pipeline** — ``pipeline_factory(plan) -> StagePipeline`` (see
    ``repro_torch.conv.stages``).  Execution composes the stage graph and
    the plan gets ``prepare``/execute for free, and the backend is
    differentiable on every schedule it supports, sharded or not, through
    the plan-level VJP (``repro_torch.conv.autodiff``) — its
    ``differentiable`` set is derived, not declared.
  * **opaque execute** — ``execute(plan, x, k) -> y``.  Third-party
    backends register this way:

        register_backend("my-backend", execute=my_fn, schedules=("local",))

    Differentiability is whatever the callable supports: pass
    ``native_autodiff=True`` if autograd can differentiate straight through
    it (like the built-in ``direct``), or declare an explicit
    ``differentiable=(...)`` subset.  Likewise fused-``Epilogue`` support
    is derived for stage pipelines but declared for opaque backends
    (``supports_epilogue=True`` + an ``execute(plan, x, k, bias=...,
    residual=...)`` signature); plans with a non-noop epilogue refuse to
    resolve to a backend that can't fuse it.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional


@dataclasses.dataclass(frozen=True)
class BackendInfo:
    """A registered convolution backend."""
    name: str
    schedules: tuple           # schedule names this backend supports
    execute: Optional[Callable] = None          # (plan, x, k) -> y (opaque)
    pipeline_factory: Optional[Callable] = None  # (plan) -> StagePipeline
    native_autodiff: bool = False  # autograd differentiates execute
    declared_differentiable: tuple = ()          # opaque backends only
    declared_supports_epilogue: bool = False     # opaque backends only
    description: str = ""

    @property
    def differentiable(self) -> tuple:
        """Schedules with working reverse-mode grads — *derived*: every
        stage-pipeline backend gets the plan-level VJP on all its
        schedules, native-autodiff backends differentiate everywhere they
        execute, and only opaque backends fall back to their declaration."""
        if self.pipeline_factory is not None or self.native_autodiff:
            return self.schedules
        return self.declared_differentiable

    @property
    def epilogue_capable(self) -> bool:
        """Whether plans with a non-noop ``Epilogue`` may resolve to this
        backend — *derived* for stage pipelines (the stage graph fuses the
        epilogue into stage 4 on every schedule); opaque backends must
        declare ``supports_epilogue=True`` and accept
        ``execute(plan, x, k, bias=..., residual=...)``."""
        return self.pipeline_factory is not None \
            or self.declared_supports_epilogue

    def make_pipeline(self, plan):
        if self.pipeline_factory is None:
            raise ValueError(
                f"backend {self.name!r} is not a stage-pipeline backend")
        return self.pipeline_factory(plan)


@dataclasses.dataclass(frozen=True)
class ScheduleInfo:
    """A registered data-movement schedule."""
    name: str
    requires_mesh: bool
    description: str = ""


_BACKENDS: dict = {}
_SCHEDULES: dict = {}


def register_schedule(name: str, *, requires_mesh: bool,
                      description: str = "") -> ScheduleInfo:
    info = ScheduleInfo(name=name, requires_mesh=requires_mesh,
                        description=description)
    _SCHEDULES[name] = info
    return info


def register_backend(name: str, execute: Optional[Callable] = None, *,
                     schedules, pipeline_factory: Optional[Callable] = None,
                     native_autodiff: bool = False, differentiable=(),
                     supports_epilogue: bool = False,
                     description: str = "") -> BackendInfo:
    if (execute is None) == (pipeline_factory is None):
        raise ValueError(
            f"backend {name!r}: register exactly one of execute= or "
            "pipeline_factory=")
    schedules = tuple(schedules)
    for s in schedules:
        if s not in _SCHEDULES:
            raise ValueError(
                f"backend {name!r} declares unknown schedule {s!r}; "
                f"register_schedule it first (known: {available_schedules()})")
    info = BackendInfo(name=name, schedules=schedules, execute=execute,
                       pipeline_factory=pipeline_factory,
                       native_autodiff=native_autodiff,
                       declared_differentiable=tuple(differentiable),
                       declared_supports_epilogue=supports_epilogue,
                       description=description)
    _BACKENDS[name] = info
    return info


def get_backend(name: str) -> BackendInfo:
    try:
        return _BACKENDS[name]
    except KeyError:
        raise ValueError(
            f"unknown conv backend {name!r}; available: "
            f"{available_backends()}") from None


def get_schedule(name: str) -> ScheduleInfo:
    try:
        return _SCHEDULES[name]
    except KeyError:
        raise ValueError(
            f"unknown conv schedule {name!r}; available: "
            f"{available_schedules()}") from None


def available_backends() -> tuple:
    return tuple(sorted(_BACKENDS))


def available_schedules() -> tuple:
    return tuple(sorted(_SCHEDULES))


def backend_schedule_pairs() -> tuple:
    """Every registered (backend, schedule) combination, in registry
    order: the surface a sweep over every registered backend walks."""
    return tuple((b, s) for b in available_backends()
                 for s in _BACKENDS[b].schedules)
