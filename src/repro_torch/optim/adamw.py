"""AdamW + global-norm clipping + cosine schedule over a tree of tensors
(``repro.optim.adamw`` twin, same math in float32, but for the global
norm's sum of squares, which is taken in float64: see ``global_norm``).

``torch.optim.AdamW`` is not a twin: it has neither the global-norm clip
nor this schedule.  A tree is nested dicts, lists and tuples of tensors,
as the LM's parameters are.  Leaves are visited in the order in which JAX
flattens a tree (dict keys sorted, sequences in order), so sums (the
global norm) add up alike; ``torch.utils._pytree`` would take a dict in
insertion order.  A ``None`` is an empty subtree, not a leaf, as in JAX.
On a mesh the leaves are ``DTensor``s (run it inside
``activation_sharding``): the global norm reduces over ranks, and each new
parameter and moment keeps its parameter's placement.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core.trace import span


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in JAX's order, ``None`` skipped."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_unflatten(like, leaves):
    """A tree of ``like``'s structure holding ``leaves`` (in
    ``tree_leaves``'s order); dicts keep ``like``'s key order."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_map(fn, tree):
    return tree_unflatten(tree, [fn(x) for x in tree_leaves(tree)])


def cosine_lr(cfg: AdamWConfig, step):
    """Linear warm-up, then cosine decay to ``min_lr_frac * lr``; ``step``
    is an integer tensor, the result a float32 scalar tensor."""
    step = step.to(torch.float32)
    warm = cfg.lr * step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    coss = cfg.lr * (cfg.min_lr_frac + (1 - cfg.min_lr_frac)
                     * 0.5 * (1 + torch.cos(math.pi * prog)))
    return torch.where(step < cfg.warmup_steps, warm, coss)


def placed_like(t, like):
    """``t`` laid out as ``like`` on its mesh when ``like`` is a
    ``DTensor`` (a partial sum is reduced, a shard cut), else ``t``."""
    from repro_torch.parallel.act_sharding import is_dtensor
    if not is_dtensor(like):
        return t
    if tuple(t.placements) == tuple(like.placements):
        return t
    return t.redistribute(like.device_mesh, like.placements)


def adamw_init(params):
    """Zero moments like ``params`` and a step count of 0."""
    device = tree_leaves(params)[0].device
    return {"mu": tree_map(torch.zeros_like, params),
            "nu": tree_map(torch.zeros_like, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree):
    """L2 norm over every tensor of a tree, as float32.  Each leaf's norm
    is taken in float64: in float32 its sum of squares overflows once the
    norm passes about 1.8e19, and the clip then scales every gradient to
    0, a step that does nothing (the JAX twin's float32 sum does so)."""
    return torch.sqrt(sum(
        torch.linalg.vector_norm(x, dtype=torch.float64).square()
        for x in tree_leaves(tree))).float()


def _leaves_like(tree, n, what):
    leaves = tree_leaves(tree)
    if len(leaves) != n:
        raise ValueError(f"adamw_update: {what} has {len(leaves)} leaves, "
                         f"the parameters {n}")
    return leaves


@torch.no_grad()
def adamw_update(grads, state, params, cfg: AdamWConfig):
    """One AdamW step: returns ``(new_params, new_state, {"lr",
    "grad_norm"})``; nothing is updated in place."""
    with span("optim/adamw"):
        step = state["step"] + 1
        lr = cosine_lr(cfg, step)
        gnorm = global_norm(grads)
        scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)

        t = step.to(torch.float32)
        bc1 = 1 - cfg.b1 ** t
        bc2 = 1 - cfg.b2 ** t

        flat_p = tree_leaves(params)
        n = len(flat_p)
        flat_g = _leaves_like(grads, n, "grads")
        flat_m = _leaves_like(state["mu"], n, "mu")
        flat_v = _leaves_like(state["nu"], n, "nu")
        new_p, mu, nu = [], [], []
        for g, m, v, p in zip(flat_g, flat_m, flat_v, flat_p):
            g = (g * scale).float()
            m = cfg.b1 * m + (1 - cfg.b1) * g
            v = cfg.b2 * v + (1 - cfg.b2) * g * g
            mh, vh = m / bc1, v / bc2
            p_new = p - lr * (mh / (torch.sqrt(vh) + cfg.eps)
                              + cfg.weight_decay * p)
            new_p.append(placed_like(p_new.to(p.dtype), p))
            mu.append(placed_like(m, p))
            nu.append(placed_like(v, p))
        return (tree_unflatten(params, new_p),
                {"mu": tree_unflatten(params, mu),
                 "nu": tree_unflatten(params, nu), "step": step},
                {"lr": lr, "grad_norm": gnorm})
