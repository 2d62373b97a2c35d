"""AdamW + global-norm clipping + cosine schedule over a dict of tensors
(``repro.optim.adamw`` twin, same math in float32).

``torch.optim.AdamW`` is not a twin: it has neither the global-norm clip
nor this schedule.  Parameters are visited in sorted-key order, the order
in which JAX flattens a dict, so sums (the global norm) add up alike.
"""
from __future__ import annotations

import dataclasses
import math

import torch


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


def adamw_init(params):
    """Zero moments like ``params`` and a step count of 0."""
    device = next(iter(params.values())).device
    return {"mu": {n: torch.zeros_like(p) for n, p in params.items()},
            "nu": {n: torch.zeros_like(p) for n, p in params.items()},
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree):
    """L2 norm over every tensor of a dict, in float32."""
    return torch.sqrt(sum(torch.sum(torch.square(tree[n].float()))
                          for n in sorted(tree)))


@torch.no_grad()
def adamw_update(grads, state, params, cfg: AdamWConfig):
    """One AdamW step: returns ``(new_params, new_state, {"lr",
    "grad_norm"})``; nothing is updated in place."""
    step = state["step"] + 1
    lr = cosine_lr(cfg, step)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)

    t = step.to(torch.float32)
    bc1 = 1 - cfg.b1 ** t
    bc2 = 1 - cfg.b2 ** t

    new_params, mu, nu = {}, {}, {}
    for n in sorted(params):
        p = params[n]
        g = (grads[n] * scale).float()
        m = cfg.b1 * state["mu"][n] + (1 - cfg.b1) * g
        v = cfg.b2 * state["nu"][n] + (1 - cfg.b2) * g * g
        mh, vh = m / bc1, v / bc2
        new_p = p - lr * (mh / (torch.sqrt(vh) + cfg.eps)
                          + cfg.weight_decay * p)
        new_params[n], mu[n], nu[n] = new_p.to(p.dtype), m, v
    return new_params, {"mu": mu, "nu": nu, "step": step}, \
        {"lr": lr, "grad_norm": gnorm}
