"""Carry parameters and prepared kernels over from the JAX package.

All take plain arrays (numpy, or anything ``numpy.asarray`` reads), so
this module needs neither ``jax`` nor ``repro``:

    kernels, biases = params_from_jax(jax_kernels, jax_biases)
    Gr, Gi = prepared_from_jax(jax_prepared.state, plan)
    params = tree_from_jax(jax_params, like=ours)
    lm = lm_params_from_jax(jax_lm_params, like=init_lm_params(cfg, gen))

The layouts are the same on both sides: OIHW kernels, (C',) biases, (in,
out) dense weights and (P, C, C') spectrum slabs as separate real/imag
float32 planes.  An LM's tree (nested dicts, lists of stacked units,
float32 leaves of any rank) is the same tree on both sides, leaf for leaf.
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


def tree_from_jax(params: Mapping, *, like: Mapping = None, device=None):
    """A flat JAX parameter dict (conv kernels, biases, dense ``w``/``b``:
    name -> float32 array) -> the same dict of tensors on ``device``
    (default: the GPU).  Every leaf must be float32 of rank 1 (bias), 2
    (dense weight) or 4 (OIHW kernel); with ``like`` (the port's own
    parameter dict) the names and shapes must match it too."""
    device = resolve_device(device)
    if like is not None and set(params) != set(like):
        raise ValueError(f"parameter names differ: "
                         f"{sorted(set(params) ^ set(like))}")
    out = {}
    for name in params:
        a = _float32(repr(name), params[name])
        if a.ndim not in (1, 2, 4):
            raise ValueError(f"{name!r}: expected a bias, dense weight or "
                             f"OIHW kernel, got shape {a.shape}")
        if like is not None and a.shape != tuple(like[name].shape):
            raise ValueError(f"{name!r}: expected {tuple(like[name].shape)},"
                             f" got {a.shape}")
        out[name] = torch.tensor(a, device=device)       # copies
    return out


def lm_params_from_jax(tree, *, like=None, device=None):
    """The JAX package's LM or whisper parameter tree (nested dicts and
    lists of float32 arrays, ``jax.device_get`` of ``init_lm_params``) ->
    the same tree of tensors on ``device`` (default: the GPU).  With
    ``like`` (the port's own tree for the same config) every path, shape
    and dtype must match it."""
    device = resolve_device(device)

    def walk(t, ref, path):
        if isinstance(t, Mapping):
            if ref is not None and (not isinstance(ref, Mapping)
                                    or set(t) != set(ref)):
                raise ValueError(f"{path or 'root'}: keys differ from the "
                                 f"port's tree")
            return {k: walk(v, None if ref is None else ref[k],
                            f"{path}[{k!r}]") for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            if ref is not None and (not isinstance(ref, (list, tuple))
                                    or len(t) != len(ref)):
                raise ValueError(f"{path or 'root'}: a list of {len(t)} "
                                 "where the port's tree differs")
            return [walk(v, None if ref is None else ref[i], f"{path}[{i}]")
                    for i, v in enumerate(t)]
        a = _float32(path, t)
        if ref is not None:
            if not isinstance(ref, torch.Tensor) or \
                    ref.dtype != torch.float32:
                raise ValueError(f"{path}: the port's leaf is not a float32 "
                                 "tensor")
            if a.shape != tuple(ref.shape):
                raise ValueError(f"{path}: expected {tuple(ref.shape)}, got "
                                 f"{a.shape}")
        return torch.tensor(a, device=device)            # copies

    return walk(tree, like, "")
