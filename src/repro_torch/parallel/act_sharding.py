"""Activation-sharding hook that the LM layers call at block boundaries.

Model code calls ``constrain(x, kind)`` with kind one of:
    "seq"    (B, S, d)
    "logits" (B, S, V)
    "heads"  (B, S, H, hd)
and ``current_mesh()`` where a layer has a sharded form (the expert-
parallel MoE).  Outside a mesh context both are the identity, as in the
JAX package.  The port has no mesh context for the LM path yet (its
sharded form is ROADMAP item 9c), so ``constrain`` returns its input and
``current_mesh`` returns None.
"""
from __future__ import annotations

KINDS = ("seq", "logits", "heads")


def current_mesh():
    """Mesh of the active activation-sharding context (none yet)."""
    return None


def constrain(x, kind: str):
    if kind not in KINDS:
        raise ValueError(kind)
    return x
