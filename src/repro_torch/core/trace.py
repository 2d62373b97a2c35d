"""The port's instrumentation: stage-op counters and profiler spans.

Counters.  Stage-op invocations (and the collectives' kinds and bytes)
are counted when they run, through a thread-local context manager::

    with stage_trace() as counts:
        plan(x, k)
    assert counts["cgemm"] == 1

``repro_torch.conv.stages`` documents the keys it counts and re-exports
these names.  A model's forward counts its convs by backend with
``_count``: ``("backend", <backend>)`` and ``("conv", <backend>, <stride>,
<k>)`` once a conv call (``repro_torch.models.resnet``).

Spans.  ``span(name)`` marks a region of the program in a
``torch.profiler`` trace as ``rt:<name>``, on the thread that runs it and
on the profiler's clock, so the device operations launched inside it can
be named by the region that launched them.  While no profiler records it
is one check and hands back a shared no-op context; the program keeps no
clock of its own.  The names, by layer:

  ``stage/{input,kernel,cgemm,inverse}``  the four stage ops, inclusive;
  ``copy/tiles``     stage 1's pad and overlapping-tile copy;
  ``copy/spectra``   stage 1's permute of the spectra to (P, M, C);
  ``copy/kernel``    stage 2's pad and permute to (P, C, C');
  ``copy/planes``    stage 4's transposes to one row a tile, the tile bias;
  ``copy/assemble``  stage 4's overlap-save crop and reassembly;
  ``copy/pack``      the sharded schedules' packing of (re, im) pairs;
  ``vjp/{dx,dk,dbias,act}``  the plan-level VJP's parts, in the thread
                     that runs the backward pass;
  ``conv/direct``    the ``direct`` backend's conv (cuDNN), with a ReLU
                     tail where cuDNN's fused call takes it (the card, in
                     inference);
  ``epilogue/direct`` its unfused bias, residual and activation tail;
  ``resnet/block``   one bottleneck of an eager ResNet forward;
  ``resnet/fold``    folding batch norm into the convs at prepare;
  ``optim/adamw``    one optimizer step;
  ``serve/batch``    one turn of the serving engine's drain loop, from
                     forming a batch to its bookkeeping, holding
                     ``serve/{form,copy_in,replay,copy_out,sync}``; a turn
                     that forms no batch holds ``serve/form`` alone.

A leaf module: it imports nothing of the port, so ``core.fftconv`` and
``conv.stages`` can both use it.
"""
from __future__ import annotations

import collections
import contextlib
import threading

import torch


# --------------------------------------------------------------------------
# Stage-op counters (thread-safe, context-managed)
# --------------------------------------------------------------------------

_tls = threading.local()                 # per-thread stack of active traces
_open: set = set()                       # ids of the traces still active


def _count(name, n: int = 1) -> None:
    for counter in getattr(_tls, "stack", ()):
        counter[name] += n


@contextlib.contextmanager
def stage_trace():
    """Scoped, thread-local stage-op counter.

    Counts only the stage ops run by *this* thread while the context is
    active, so concurrent callers don't bleed into each other, and those
    of the backward pass of a plan whose forward ran inside it, in
    whatever thread autograd runs it (``counted_in``).  Nested traces each
    observe the ops run inside them.
    """
    counts: collections.Counter = collections.Counter()
    stack = _stack()
    stack.append(counts)
    _open.add(id(counts))
    try:
        yield counts
    finally:
        _open.discard(id(counts))
        _remove(stack, counts)


@contextlib.contextmanager
def isolated_trace():
    """A ``stage_trace`` that the traces already active in this thread do
    not see: the static analyzer counts what a plan would run without it
    counting as run."""
    outer = _stack()
    _tls.stack = []
    try:
        with stage_trace() as counts:
            yield counts
    finally:
        _tls.stack = outer


def _stack() -> list:
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    return stack


def _remove(stack, counts) -> None:
    # remove by IDENTITY: two traces may hold equal contents
    for i in range(len(stack) - 1, -1, -1):
        if stack[i] is counts:
            del stack[i]
            break


def active_traces() -> tuple:
    """The traces this thread's stage ops count in now."""
    return tuple(getattr(_tls, "stack", ()))


@contextlib.contextmanager
def counted_in(traces):
    """Within the block this thread's stage ops count in ``traces`` too,
    those of them still active and not counting here already.  Autograd
    runs the backward pass of CUDA tensors in a thread of its own: the
    plan-level VJP counts its ops in the traces that were active at the
    forward (``active_traces()``) and still are."""
    stack = _stack()
    extra = [c for c in traces
             if id(c) in _open and not any(c is t for t in stack)]
    stack.extend(extra)
    try:
        yield
    finally:
        for c in extra:
            _remove(stack, c)


# --------------------------------------------------------------------------
# Profiler spans
# --------------------------------------------------------------------------

SPAN_PREFIX = "rt:"
_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A range ``"rt:" + name`` while a profiler records, else a shared
    no-op context.  The range is PyTorch's fast record function (the one
    its compiled code marks kernels with): a ``cpu_op`` event in the
    trace, about a seventh of ``torch.profiler.record_function``'s cost
    with the profiler on (1.8 against 12.2 us a span on an H100 machine's
    host, torch 2.11; 0.5 us with it off)."""
    if not torch.autograd._profiler_enabled():
        return _NO_SPAN
    return torch._C._profiler._RecordFunctionFast(SPAN_PREFIX + name)
