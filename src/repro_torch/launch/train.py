"""Training launcher, on the GPU unless ``--device cpu`` is given (the
twin of ``repro.launch.train``: the same flags and printed lines).

    # hymba-1.5b at full width on one card
    PYTHONPATH=src python -m repro_torch.launch.train --arch hymba-1.5b \
        --batch 2 --seq 2048 --steps 6
    # a small form on the host, with checkpoints and a resume
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-14b \
        --smoke --steps 6 --batch 2 --seq 16 --device cpu \
        --ckpt-dir /tmp/ckpt --ckpt-every 3 [--resume]

Features exercised here: deterministic seekable data, AdamW + cosine,
microbatching, async atomic checkpoints, crash-resume (--resume), and a
straggler watchdog (per-step wall-time EWMA; steps slower than
``--straggler-factor`` x the EWMA are logged — on a real cluster this signal
feeds the failover controller that re-queues the step's data shard, which is
replayable because batches are pure functions of the step index).  The
weights are the port's own random draw from ``--seed``; the data are the
reference's for the same seed."""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any

import torch

import repro_torch.checkpoint as ckpt
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.data import DataConfig, frames_batch, lm_batch
from repro_torch.device import resolve_device
from repro_torch.launch.batcher import _sync
from repro_torch.optim import AdamWConfig, tree_leaves
from repro_torch.train import init_train_state, make_train_step


@dataclasses.dataclass
class Trained:
    """What a run did: its config, the final parameters and AdamW state,
    each step's loss and host seconds (``{step: value}``, the steps this
    run took), and the final loss."""
    cfg: Any
    params: Any
    opt: Any
    losses: dict
    step_s: dict
    loss: float


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_NAMES, default="qwen3-14b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--straggler-factor", type=float, default=3.0)
    # size overrides (e.g. the ~100M end-to-end training run)
    ap.add_argument("--d-model", type=int, default=0)
    ap.add_argument("--n-layers", type=int, default=0)
    ap.add_argument("--n-heads", type=int, default=0)
    ap.add_argument("--n-kv", type=int, default=0)
    ap.add_argument("--d-ff", type=int, default=0)
    ap.add_argument("--vocab", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    return ap.parse_args(argv)


def config(args):
    """The arch's config with the size overrides, and MoE dispatched in
    one group, as the reference launcher does."""
    cfg = get_config(args.arch, smoke=args.smoke)
    over = {}
    if args.d_model:
        over.update(d_model=args.d_model,
                    head_dim=args.d_model // (args.n_heads or cfg.n_heads))
    if args.n_layers:
        over["n_layers"] = args.n_layers
    if args.n_heads:
        over.update(n_heads=args.n_heads, pad_heads=0, pad_kv=0)
    if args.n_kv:
        over["n_kv"] = args.n_kv
    if args.d_ff:
        over["d_ff"] = args.d_ff
    if args.vocab:
        over["vocab"] = args.vocab
    if over:
        cfg = dataclasses.replace(cfg, **over)
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, moe_groups=1)
    return cfg


def batch_at(cfg, dc: DataConfig, step: int, device):
    """The step's batch: the LM stream, or whisper's frames and tokens cut
    to its decoder length."""
    if cfg.encdec:
        batch = frames_batch(dc, step, d_model=cfg.d_model, frames=64,
                             device=device)
        batch["tokens"] = batch["tokens"][:, :cfg.max_dec_len]
        batch["labels"] = batch["labels"][:, :cfg.max_dec_len]
        return batch
    return lm_batch(dc, step, device=device)


def main(argv=None) -> Trained:
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = config(args)
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=min(20, args.steps // 5),
                          total_steps=args.steps)
    params, opt = init_train_state(cfg, args.seed, device=device)
    n_params = sum(x.numel() for x in tree_leaves(params))
    print(f"arch={cfg.name} params={n_params/1e6:.1f}M "
          f"steps={args.steps} batch={args.batch} seq={args.seq}")

    start_step = 0
    if args.resume and args.ckpt_dir:
        last = ckpt.latest_step(args.ckpt_dir)
        if last is not None:
            (state, meta) = ckpt.restore(args.ckpt_dir, last,
                                         {"params": params, "opt": opt},
                                         device=device)
            params, opt = state["params"], state["opt"]
            start_step = last
            print(f"resumed from step {last}")

    dc = DataConfig(vocab=cfg.vocab, seq_len=args.seq + 1,
                    global_batch=args.batch, seed=args.seed)
    step_fn = make_train_step(cfg, opt_cfg, microbatches=args.microbatches)

    ewma, loss, losses, step_s = None, None, {}, {}
    for step in range(start_step, args.steps):
        batch = batch_at(cfg, dc, step, device)
        _sync(device)
        t0 = time.time()
        params, opt, m = step_fn(params, opt, batch)
        loss = float(m["loss"])
        _sync(device)
        dt = time.time() - t0
        losses[step], step_s[step] = loss, dt
        ewma = dt if ewma is None else 0.9 * ewma + 0.1 * dt
        straggler = " [STRAGGLER]" if dt > args.straggler_factor * ewma \
            and step > start_step + 3 else ""
        if step % 10 == 0 or step == args.steps - 1 or straggler:
            print(f"step {step:5d} loss {loss:.4f} "
                  f"lr {float(m['lr']):.2e} {dt*1e3:.0f}ms{straggler}")
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            ckpt.save_async(args.ckpt_dir, step + 1,
                            {"params": params, "opt": opt})
    ckpt.wait_pending()
    print("done; final loss", loss)
    return Trained(cfg=cfg, params=params, opt=opt, losses=losses,
                   step_s=step_s, loss=loss)


if __name__ == "__main__":
    main()
