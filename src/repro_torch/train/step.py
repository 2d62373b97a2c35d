"""Train / prefill / decode step builders used by the launchers (the
``repro.train.step`` twin).

Every step is a plain function of (params, opt_state, batch) or (params,
batch or tokens, pos, cache) on the port's trees.  Training takes
gradients with autograd on detached copies of the parameters, so the
parameters go in and come out as plain tensors: no autograd graph and no
``requires_grad`` survive a step.  The decode cache is written in place
and returned.

Distributed-optimization features, as the reference's:
  * microbatching (gradient accumulation: a Python loop from zeros, then
    a division, in the reference's order),
  * activation remat (per pattern unit, ``torch.utils.checkpoint``),
  * gradient compression: grads rounded to bf16 and back (on one device
    there is no all-reduce to halve; the rounding is kept so that both
    packages train alike).
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.models.common import ModelConfig
from repro_torch.models import lm as LM
from repro_torch.models import whisper as WH
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               placed_like, tree_leaves, tree_map,
                               tree_unflatten)
from repro_torch.parallel.act_sharding import reduced


def cross_entropy(logits, labels, *, z_loss=1e-4, mask=None):
    """Masked softmax CE + z-loss. logits f32 (B, S, V); labels (B, S).

    The max is held out of the gradient (the reference's
    ``stop_gradient``).  Every op over V keeps vocab-sharded logits (a
    ``DTensor`` on a mesh) sharded: the label's log-prob is a masked sum
    over V (a reduction that shards, as the reference's one-hot einsum),
    not a gather along the sharded dim, which would gather the vocab."""
    m = reduced(torch.amax(logits, dim=-1, keepdim=True)).detach()
    shifted = logits - m
    lse = torch.log(torch.sum(torch.exp(shifted), dim=-1)) + m[..., 0]
    vocab = torch.arange(logits.shape[-1], device=logits.device)
    ll = torch.sum(torch.where(vocab == labels.long()[..., None], shifted,
                               0.0), dim=-1) + m[..., 0]
    ce = lse - ll
    if z_loss:
        ce = ce + z_loss * torch.square(lse)
    if mask is None:
        return torch.mean(ce)
    mask = mask.float()
    return torch.sum(ce * mask) / torch.clamp(torch.sum(mask), min=1.0)


def _lm_loss(params, cfg: ModelConfig, batch, use_flash):
    tokens, labels = batch["tokens"], batch["labels"]
    img = batch.get("img_embeds")
    logits = LM.lm_forward(params, cfg, tokens, img_embeds=img,
                           use_flash=use_flash, remat=True)
    # frontend/meta prefix positions carry no labels
    prefix = logits.shape[1] - labels.shape[1]
    logits = logits[:, prefix:]
    return cross_entropy(logits, labels)


def _whisper_loss(params, cfg: ModelConfig, batch, use_flash):
    # whisper's encoder and decoder layers are always recomputed in the
    # backward, as the reference's are
    enc = WH.encode(params, cfg, batch["frames"])
    logits = WH.decode_train(params, cfg, enc, batch["tokens"])
    return cross_entropy(logits, batch["labels"])


def train_loss(params, cfg: ModelConfig, batch, *, use_flash=False):
    """The training loss of ``batch``: the LM's, or whisper's."""
    loss_fn = _whisper_loss if cfg.encdec else _lm_loss
    return loss_fn(params, cfg, batch, use_flash)


def _value_and_grad(params, cfg, batch, use_flash):
    """(loss, grads) of one batch; unused parameters get zero grads, as
    ``jax.grad`` gives them.  On a mesh each grad is placed as its
    parameter (a partial sum over ranks is reduced there)."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    with torch.enable_grad():
        loss = train_loss(tree_unflatten(params, leaves), cfg, batch,
                          use_flash=use_flash)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
    return loss.detach(), tree_unflatten(
        params, [placed_like(g, p) for g, p in zip(grads, leaves)])


def loss_and_grads(params, cfg: ModelConfig, batch, *, use_flash=False,
                   microbatches=1):
    """(loss, grads) of ``batch``: with ``microbatches`` > 1 the batch's
    leading dim is cut into that many equal chunks (else ValueError, as
    the reference's reshape raises), whose losses and grads are summed
    from zero and then divided, as the reference's scan does."""
    if microbatches == 1:
        return _value_and_grad(params, cfg, batch, use_flash)
    rows = next(iter(batch.values())).shape[0]
    if rows % microbatches:
        raise ValueError(f"a batch of {rows} rows does not split into "
                         f"{microbatches} microbatches")
    n = rows // microbatches
    tot = torch.zeros((), dtype=torch.float32,
                      device=tree_leaves(params)[0].device)
    acc = tree_map(torch.zeros_like, params)
    for i in range(microbatches):
        mb = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
        loss, g = _value_and_grad(params, cfg, mb, use_flash)
        tot = tot + loss
        acc = tree_unflatten(params, [a + b for a, b in
                                      zip(tree_leaves(acc), tree_leaves(g))])
    return tot / microbatches, tree_map(lambda x: x / microbatches, acc)


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, *,
                    microbatches: int = 1, use_flash: bool = False,
                    grad_bf16: bool = False):
    """Returns train_step(params, opt_state, batch) -> (params, opt,
    metrics {"lr", "grad_norm", "loss"}), the metrics 0-d tensors."""
    def train_step(params, opt_state, batch):
        loss, grads = loss_and_grads(params, cfg, batch, use_flash=use_flash,
                                     microbatches=microbatches)
        if grad_bf16:
            # compression: a DP all-reduce would carry the bf16 values
            grads = tree_map(lambda g: g.to(torch.bfloat16).float(), grads)
        params, opt_state, om = adamw_update(grads, opt_state, params,
                                             opt_cfg)
        return params, opt_state, dict(om, loss=loss)

    return train_step


def make_prefill_step(cfg: ModelConfig, *, use_flash: bool = True):
    if cfg.encdec:
        def prefill(params, batch, cache):
            enc = WH.encode(params, cfg, batch["frames"])
            cache = WH.prefill_cross(params, cfg, enc, cache)
            return WH.decode_step(params, cfg, batch["tokens"], 0, cache)
        return prefill

    def prefill(params, batch, cache):
        img = batch.get("img_embeds")
        logits, cache, _ = LM.lm_prefill(params, cfg, batch["tokens"], cache,
                                         img_embeds=img, use_flash=use_flash)
        return logits, cache
    return prefill


def make_decode_step(cfg: ModelConfig):
    if cfg.encdec:
        def decode(params, tokens, pos, cache):
            return WH.decode_step(params, cfg, tokens, pos, cache)
        return decode

    def decode(params, tokens, pos, cache):
        return LM.lm_decode_step(params, cfg, tokens, pos, cache)
    return decode


def init_train_state(cfg: ModelConfig, gen, *, device=None):
    """(params, AdamW state) on ``device`` (default: the GPU).  ``gen`` is
    a ``torch.Generator`` or an integer seed of one on ``device``; the
    weights are drawn on the generator's device."""
    device = resolve_device(device)
    if not isinstance(gen, torch.Generator):
        gen = torch.Generator(device=device).manual_seed(int(gen))
    init = WH.init_whisper_params if cfg.encdec else LM.init_lm_params
    params = tree_map(lambda t: t.to(device), init(cfg, gen))
    return params, adamw_init(params)
