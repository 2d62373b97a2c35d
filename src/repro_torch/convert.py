"""Carry parameters and prepared kernels over from the JAX package.

Both take plain arrays (numpy, or anything ``numpy.asarray`` reads), so
this module needs neither ``jax`` nor ``repro``:

    kernels, biases = params_from_jax(jax_kernels, jax_biases)
    Gr, Gi = prepared_from_jax(jax_prepared.state, plan)

The layouts are the same on both sides: OIHW kernels, (C',) biases and
(P, C, C') spectrum slabs as separate real/imag float32 planes.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.core.fftconv import freq_count
from repro_torch.device import resolve_device


def _float32(name: str, a) -> np.ndarray:
    a = np.asarray(a)
    if a.dtype != np.float32:
        raise TypeError(f"{name}: expected float32, got {a.dtype}")
    return a


def params_from_jax(kernels: Mapping, biases: Mapping, *, device=None):
    """JAX-side parameter dicts (layer name -> OIHW kernel, layer name ->
    (C',) bias) -> the port's ``(kernels, biases)`` tensor dicts on
    ``device`` (default: the GPU)."""
    device = resolve_device(device)
    if set(kernels) != set(biases):
        raise ValueError(f"kernel and bias layers differ: "
                         f"{sorted(set(kernels) ^ set(biases))}")
    out_k, out_b = {}, {}
    for name in kernels:
        k = _float32(f"kernel {name!r}", kernels[name])
        b = _float32(f"bias {name!r}", biases[name])
        if k.ndim != 4:
            raise ValueError(f"kernel {name!r}: expected OIHW, got shape "
                             f"{k.shape}")
        if b.shape != (k.shape[0],):
            raise ValueError(f"bias {name!r}: expected ({k.shape[0]},), "
                             f"got {b.shape}")
        out_k[name] = torch.tensor(k, device=device)     # copies
        out_b[name] = torch.tensor(b, device=device)
    return out_k, out_b


def prepared_from_jax(state, plan, *, device=None):
    """A JAX ``PreparedConv.state`` ``(Gr, Gi)`` -> the port's prepared
    slab for ``plan`` (an FFT plan of the same geometry and spectrum): a
    ``(Gr, Gi)`` pair of (P, C, C') tensors on ``device``, the ``state`` a
    ``PreparedConv`` executes against."""
    if plan.backend == "direct":
        raise ValueError("the direct backend has no prepared slab")
    device = resolve_device(device)
    s = plan.spec
    want = (freq_count(s, plan.spectrum), s.C, s.Cout)
    Gr, Gi = state
    out = []
    for part, g in (("Gr", Gr), ("Gi", Gi)):
        g = _float32(part, g)
        if g.shape != want:
            raise ValueError(f"{part}: expected {want} for this plan, got "
                             f"{g.shape}")
        out.append(torch.tensor(g, device=device))       # copies
    return tuple(out)
