"""Helpers shared by the ``test_torch_lm_*`` files: the port's LM trees
built from the JAX package's weights, and the scaled comparison.

The two packages draw different random weights for a seed, so every
parity test carries the reference's weights across with
``repro_torch.convert.lm_params_from_jax`` and runs both sides in
float32."""
import dataclasses

import jax
import numpy as np
import torch
from torch.utils import _pytree

from repro.configs import get_config as jget_config
from repro_torch import convert
from repro_torch.configs import get_config as tget_config
from repro_torch.models import lm as TLM
from repro_torch.models import whisper as TWH

TOL = 1e-4              # of the largest |value| of the reference's output


def configs(arch, **changes):
    """(JAX config, port config) of ``arch``'s small form in float32."""
    changes = dict(dtype="float32", **changes)
    return (dataclasses.replace(jget_config(arch, smoke=True), **changes),
            dataclasses.replace(tget_config(arch, smoke=True), **changes))


def carry(jax_tree, tcfg=None, like=None):
    """The reference's parameter tree as the port's, checked against the
    port's own tree for ``tcfg`` (or ``like``)."""
    if like is None:
        init = TWH.init_whisper_params if tcfg.encdec else TLM.init_lm_params
        like = init(tcfg, torch.Generator().manual_seed(0))
    host = jax.tree.map(np.asarray, jax_tree)
    return convert.lm_params_from_jax(host, like=like, device="cpu")


def assert_close(got, want, tol=TOL, what=""):
    """max |got - want| within ``tol`` of max |want|."""
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got.astype(np.float64) - want).max())
    assert err <= tol * scale, f"{what}: {err:.3e} > {tol} x {scale:.3e}"


def flat_jax(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def flat_torch(tree):
    return {_pytree.keystr(p): v
            for p, v in _pytree.tree_flatten_with_path(tree)[0]}


def assert_trees_close(got, want, tol=TOL, what=""):
    """The port's tree against the reference's: the same key strings, and
    each leaf within ``tol`` of its largest |value|."""
    g, w = flat_torch(got), flat_jax(want)
    assert sorted(g) == sorted(w), (what, sorted(set(g) ^ set(w)))
    for k in w:
        if np.abs(w[k]).max() == 0:
            assert float(g[k].abs().max()) == 0, (what, k)
        else:
            assert_close(g[k], w[k], tol, f"{what}{k}")
