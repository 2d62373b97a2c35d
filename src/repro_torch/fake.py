"""Fake tensors and the port's cached constants.

The static analyzer (``repro_torch.conv.analyze``) runs a plan on fake
tensors (``torch._subclasses.fake_tensor.FakeTensorMode``): tensors with a
shape, a dtype and a device but no data, so that no FLOP runs and no byte
is allocated.  Two things must hold for that:

- A cached constant (the DFT tables, the compact layout's index maps, a
  kernel's launch arguments) is always built as a real tensor, whatever
  mode is active at its first call (``constant_cache``): a fake one in the
  cache would turn every later real call fake.  Under a fake mode the
  public getters hand out fakes of the constants' shapes on the asked
  device instead (``fakes_like``), so the analysis takes no device memory
  and needs no GPU for a fake ``cuda`` tensor.
- A kernel wrapper given a fake operand checks its contract and returns
  fake outputs of the plain version's shapes and dtypes (``is_fake``): it
  launches nothing, builds nothing and counts no launch.
"""
from __future__ import annotations

import functools
import threading

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import _disable_current_modes


def fake_mode():
    """The active ``FakeTensorMode``, or ``None``."""
    return torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE)


def is_fake(t) -> bool:
    """Whether ``t`` is a fake tensor (shape, dtype and device, no data)."""
    return isinstance(t, FakeTensor)


def fakes_like(tensors, device) -> tuple:
    """Fakes of ``tensors``' shapes and dtypes on ``device``, made in the
    active fake mode (``torch.empty``: a fake ``cuda`` tensor needs no
    GPU, where a copy to the device would)."""
    return tuple(torch.empty(t.shape, dtype=t.dtype, device=device)
                 for t in tensors)


def constant_cache(fn):
    """Cache ``fn``'s result per arguments, built with every dispatch mode
    off, so that the cache holds real tensors even when the first call
    comes inside a ``FakeTensorMode`` or another mode.  A hit costs one
    dict lookup.  ``<fn>.cache`` is the cache itself."""
    cache: dict = {}
    lock = threading.Lock()

    @functools.wraps(fn)
    def get(*args):
        try:
            return cache[args]
        except KeyError:
            pass
        with lock, _disable_current_modes():
            if args not in cache:
                cache[args] = fn(*args)
            return cache[args]

    get.cache = cache
    return get
