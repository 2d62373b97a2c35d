"""The plain reference of the conv configurations, and the data both sides
are handed.

Plain PyTorch only: ``F.conv2d``, ``F.max_pool2d``, autograd and AdamW
written out.  It imports nothing of the program and takes nothing the
program made: it is given the benchmark's own weights and inputs and works
everything else out again.  It runs in float32 with TF32 off, or, as the
control, with every convolution's operands rounded to TF32 (10 mantissa
bits, round to nearest even) and accumulated in float32, which is what
the tensor cores do with TF32 on.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from chipbench.harness import mix_seed

BIAS_STD = 0.01


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` (float32) rounded to TF32's 10-bit mantissa, to nearest even;
    infinities and NaNs pass through."""
    bits = t.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    rounded = (bits + 0xFFF + lsb) & ~0x1FFF
    finite = torch.isfinite(t)
    return torch.where(finite, rounded.view(torch.float32), t)


def set_precision(cfg: dict) -> None:
    """Run in the precision that the configuration states.  Float32 with
    TF32 off is the only one implemented: any other is refused."""
    if cfg.get("dtype") != "float32" or cfg.get("tf32") is not False:
        raise ValueError(
            f"{cfg.get('name')}: dtype {cfg.get('dtype')!r} with tf32 "
            f"{cfg.get('tf32')!r} is not implemented (float32 with TF32 "
            f"off is)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# --------------------------------------------------------------------------
# Data: made by the benchmark from the seed, handed to both sides
# --------------------------------------------------------------------------

def generator(device, seed: int, *salt: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(mix_seed(seed, *salt))
    return g


def make_params(layers, seed: int, device) -> tuple:
    """(kernels, biases): name -> tensor, He-normal kernels and small
    biases, drawn in one call on ``device`` and cut into views."""
    shapes = [(l["Cout"], l["C"], l["k"], l["k"]) for l in layers]
    sizes = [math.prod(s) for s in shapes] + [l["Cout"] for l in layers]
    flat = torch.randn(sum(sizes), generator=generator(device, seed, 1),
                       device=device)
    kernels, biases, off = {}, {}, 0
    for l, s in zip(layers, shapes):
        n = math.prod(s)
        fan_in = l["C"] * l["k"] * l["k"]
        kernels[l["name"]] = flat[off:off + n].view(s).mul_(
            math.sqrt(2.0 / fan_in))
        off += n
    for l in layers:
        biases[l["name"]] = flat[off:off + l["Cout"]].mul_(BIAS_STD)
        off += l["Cout"]
    return kernels, biases


def make_input(shape, seed: int, index: int, device) -> torch.Tensor:
    """Input number ``index`` of a run: standard normal, the same for the
    same (seed, index) on every device."""
    return torch.randn(shape, generator=generator(device, seed, 2, index),
                       device=device)


# --------------------------------------------------------------------------
# Forward
# --------------------------------------------------------------------------

class _TF32Conv(torch.autograd.Function):
    """``F.conv2d`` with TF32 operands in the forward and in both
    products of the backward (dx from the rounded cotangent and kernel, dk
    from the rounded input and cotangent), accumulated in float32."""

    @staticmethod
    def forward(ctx, x, k, pad):
        x, k = tf32_round(x), tf32_round(k)
        ctx.save_for_backward(x, k)
        ctx.pad = pad
        return F.conv2d(x, k, padding=pad)

    @staticmethod
    def backward(ctx, dy):
        x, k = ctx.saved_tensors
        dy = tf32_round(dy)
        dx = torch.nn.grad.conv2d_input(x.shape, k, dy, padding=ctx.pad)
        dk = torch.nn.grad.conv2d_weight(x, k.shape, dy, padding=ctx.pad)
        return dx, dk, None


def conv(x, k, b, pad, *, tf32=False, relu=True):
    if tf32:
        y = _TF32Conv.apply(x, k, pad) + b.view(1, -1, 1, 1)
    else:
        y = F.conv2d(x, k, b, padding=pad)
    return F.relu(y) if relu else y


def trunk(layers, kernels, biases, x, *, tf32=False):
    """The sequential trunk: conv + bias + ReLU, a 2x2 max-pool where the
    configuration says."""
    for l in layers:
        x = conv(x, kernels[l["name"]], biases[l["name"]], l["pad"],
                 tf32=tf32)
        if l.get("pool_after"):
            x = F.max_pool2d(x, 2, 2)
    return x


def trunk_rows(layers, kernels, biases, x, *, tf32=False, rows=64):
    """``trunk`` in blocks of ``rows`` images, so that it fits beside what
    the run keeps."""
    return torch.cat([trunk(layers, kernels, biases, x[i:i + rows],
                            tf32=tf32) for i in range(0, x.shape[0], rows)])


def scaled_err(y, y_ref) -> float:
    """max|y - y_ref| / max|y_ref|, in float64."""
    y, y_ref = y.double(), y_ref.double()
    return ((y - y_ref).abs().max() / y_ref.abs().max()).item()


# --------------------------------------------------------------------------
# Training: the loss sum(y * r), autograd, AdamW written out
# --------------------------------------------------------------------------

def adamw_lr(opt: dict, step: int) -> float:
    """Linear warm-up then cosine decay to ``min_lr_frac * lr``."""
    lr, warm = opt["lr"], opt["warmup_steps"]
    if step < warm:
        return lr * step / max(warm, 1)
    prog = min(max((step - warm) / max(opt["total_steps"] - warm, 1), 0.0),
               1.0)
    return lr * (opt["min_lr_frac"] + (1 - opt["min_lr_frac"]) * 0.5
                 * (1 + math.cos(math.pi * prog)))


def adamw_step(params: list, grads: list, mu: list, nu: list, step: int,
               opt: dict) -> tuple:
    """One AdamW step with global-norm clipping, in float32: returns new
    (params, mu, nu); nothing is updated in place."""
    lr = adamw_lr(opt, step)
    gnorm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads))
    scale = min(1.0, opt["clip_norm"] / (gnorm.item() + 1e-9))
    b1, b2 = opt["b1"], opt["b2"]
    bc1, bc2 = 1 - b1 ** step, 1 - b2 ** step
    out_p, out_m, out_v = [], [], []
    for p, g, m, v in zip(params, grads, mu, nu):
        g = g * scale
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        upd = (m / bc1) / (torch.sqrt(v / bc2) + opt["eps"])
        out_p.append(p - lr * (upd + opt["weight_decay"] * p))
        out_m.append(m)
        out_v.append(v)
    return out_p, out_m, out_v


def train_loss(layers, kernels, biases, x, r, *, tf32=False):
    return (trunk(layers, kernels, biases, x, tf32=tf32) * r).sum()


def train(layers, kernels, biases, batches, r, opt: dict, *, tf32=False):
    """``len(batches)`` steps of the trunk from the given parameters.
    Returns (losses, the first step's clipped gradient as AdamW's first
    moment holds it over (1 - b1), the parameters after the last step),
    each list in the order kernels then biases, layer by layer."""
    names = [l["name"] for l in layers]
    params = ([kernels[n].detach().clone() for n in names]
              + [biases[n].detach().clone() for n in names])
    mu = [torch.zeros_like(p) for p in params]
    nu = [torch.zeros_like(p) for p in params]
    losses, first = [], None
    n = len(names)
    for i, x in enumerate(batches):
        leaves = [p.requires_grad_() for p in params]
        loss = train_loss(layers, dict(zip(names, leaves[:n])),
                          dict(zip(names, leaves[n:])), x, r, tf32=tf32)
        grads = torch.autograd.grad(loss, leaves)
        losses.append(loss.item())
        params, mu, nu = adamw_step([p.detach() for p in leaves], grads,
                                    mu, nu, i + 1, opt)
        if first is None:
            first = [m / (1 - opt["b1"]) for m in mu]
    return losses, first, params


def step_from(layers, params: list, mu: list, nu: list, step: int, x, r,
              opt: dict, *, tf32=False) -> tuple:
    """AdamW step number ``step`` (counted from 1) from the given state,
    on batch ``x``: (loss, the clipped gradient as the first moment takes
    it, the new parameters), lists in the order of ``train``'s."""
    names = [l["name"] for l in layers]
    n = len(names)
    leaves = [p.detach().clone().requires_grad_() for p in params]
    loss = train_loss(layers, dict(zip(names, leaves[:n])),
                      dict(zip(names, leaves[n:])), x, r, tf32=tf32)
    grads = torch.autograd.grad(loss, leaves)
    new_p, new_m, _ = adamw_step([p.detach() for p in leaves], grads, mu,
                                 nu, step, opt)
    return loss.item(), first_moment_grad(mu, new_m, opt["b1"]), new_p


def first_moment_grad(mu: list, new_mu: list, b1: float) -> list:
    """The gradient that a step fed its first moment, worked out from the
    moment before and after it."""
    return [(m1 - b1 * m0) / (1 - b1) for m0, m1 in zip(mu, new_mu)]


def loss_scale(layers, kernels, biases, x, r) -> float:
    """The 2-norm of the loss's terms y * r on the first batch: the scale a
    loss gap is read against.  The loss itself is a sum of either sign and
    may lie near 0, and rounding errors of its terms add up to about this
    norm times their relative size, whatever the size of the batch."""
    with torch.no_grad():
        return (trunk(layers, kernels, biases, x) * r).double().norm().item()


def norm_gaps(got: list, want: list) -> list:
    """Per leaf, |norm(got) - norm(want)| over the larger of norm(want) and
    the median leaf's norm."""
    gn = [g.double().norm().item() for g in got]
    wn = [w.double().norm().item() for w in want]
    med = sorted(wn)[len(wn) // 2]
    return [abs(a - b) / max(b, med) for a, b in zip(gn, wn)]
