"""Dry-run: trace every (arch x shape x mesh) cell on a fake 256- or
512-rank mesh, with ``meta`` stand-ins for every input (no allocation, no
device), count its collectives, its FLOPs and its live bytes a rank, and
cache a JSON record a cell for the roofline table (the twin of
``repro.launch.dryrun``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-14b \\
        --shape train_4k [--multi-pod] [--variant ring|ep]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]
    PYTHONPATH=src python -m repro_torch.launch.report

The mechanism, in place of the reference's lower + compile with
``ShapeDtypeStruct``s over 512 forced host devices:

  * a fake process group (``FakeStore``, backend ``fake``) of the mesh's
    rank count, this process rank 0: every collective returns at once;
  * a ``cuda``-typed ``DeviceMesh`` over it (no GPU needed), so that
    ``DTensor`` plans the collectives NCCL would run: on a ``cpu`` mesh it
    turns every shard-to-shard all-to-all into an all-gather and a chunk;
  * the parameters, AdamW state, batch and cache as ``meta`` tensors
    (``launch.specs``) placed as ``DTensor``s by ``launch.shardings.place``
    (a rank's block, no copy);
  * the reference's step (train / prefill / decode) with its arguments, run
    once under ``activation_sharding``, serving under ``no_grad``, and
    under ``_Tally``, a ``TorchDispatchMode`` that sees the local ops a
    rank runs (``DTensor``'s ops are handed on to it).

In place of the compiled program's analyses, the record holds:

  * ``collectives``: the reference's ``{"bytes", "counts",
    "total_bytes"}`` by HLO kind, per rank (``roofline.CollectiveCounter``);
  * ``flops_per_device``: ``torch.utils.flop_counter``'s count over the
    local ops of rank 0 (not ``DTensor``'s global ops, which a
    ``FlopCounterMode`` around the step would count);
  * ``argument_size_in_bytes``, ``temp_size_in_bytes`` (the peak of live
    local storage bytes, the arguments included, as plan-lint's tally) and
    ``output_size_in_bytes``, a rank;
  * ``lower_s``: the trace's seconds.

The FLOPs and HBM bytes of the roofline are the analytic model's
(``launch.analytic``), as in the reference.  The dry-run starts and
destroys its own process group: a process that holds one cannot run it.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback
from concurrent.futures import ThreadPoolExecutor

import torch
import torch.distributed as dist

from repro_torch.configs import ARCH_NAMES, LONG_CONTEXT_OK, get_config
from repro_torch.conv.analyze import LiveBytes, _tensors
from repro_torch.launch import mesh as M
from repro_torch.launch import shardings as SH
from repro_torch.launch import specs as SP
from repro_torch.launch.analytic import analytic_costs
from repro_torch.launch.report import OUT_DIR
from repro_torch.launch.roofline import (CollectiveCounter, model_flops,
                                         roofline_terms)
from repro_torch.models.common import SHAPES, ShapeCell
from repro_torch.optim import AdamWConfig
from repro_torch.parallel.act_sharding import activation_sharding
from repro_torch.train import (make_decode_step, make_prefill_step,
                               make_train_step)

PRODUCTION = {False: (16, 16), True: (2, 16, 16)}      # by multi_pod


def _shape_by_name(name):
    for s in SHAPES:
        if s.name == name:
            return s
    raise KeyError(name)


def _axes(mesh_shape):
    return ("data", "model") if len(mesh_shape) == 2 else \
        ("pod", "data", "model")


def start_fake_group(world_size: int) -> None:
    """A fake default process group of ``world_size`` ranks, this process
    rank 0: collectives return at once and move nothing."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("the dry-run starts its own (fake) process "
                           "group: this process already holds one")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def build_cell(arch, shape, multi_pod: bool = False, variant: str = "",
               *, mesh_shape=None, param_dtype=None, use_flash: bool = True,
               grad_bf16: bool = True, smoke: bool = False,
               device_type: str = "cuda"):
    """Returns (fn, args, meta) for one cell, its args placed on a mesh of
    the started process group.  ``arch``: a name of ``ARCH_NAMES`` (its
    small form with ``smoke``) or a ``ModelConfig``.  ``shape``: a name of
    ``SHAPES`` or a ``ShapeCell``.  ``variant``: '' / 'ring' / 'ep'.
    ``mesh_shape``: the production mesh's by default.  ``param_dtype``:
    float32 for train and bfloat16 for serving by default, as the
    reference's; ``use_flash``/``grad_bf16`` are the train step's.
    ``device_type``: the mesh's; ``cuda`` plans what NCCL runs."""
    cell = shape if isinstance(shape, ShapeCell) else _shape_by_name(shape)
    if mesh_shape is None:
        mesh = M.make_production_mesh(multi_pod=multi_pod,
                                      device_type=device_type)
    else:
        mesh = M.make_mesh(mesh_shape, _axes(mesh_shape),
                           device_type=device_type)
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    n_dp = sizes["data"] * sizes.get("pod", 1)
    cfg = get_config(arch, smoke=smoke) if isinstance(arch, str) else arch
    if cfg.n_experts and cell.global_batch * cell.seq_len % n_dp == 0:
        cfg = dataclasses.replace(cfg, moe_groups=n_dp)
    if variant == "ring":
        cfg = dataclasses.replace(cfg, ring_local_cache=True)
    elif variant == "ep":
        cfg = dataclasses.replace(cfg, moe_ep=True)
    elif variant:
        raise ValueError(f"unknown variant {variant!r}")
    train = cell.kind == "train"
    if param_dtype is None:
        param_dtype = torch.float32 if train else torch.bfloat16
    pstr = SP.param_structs(cfg, bf16=param_dtype == torch.bfloat16)

    batch = SP.input_specs(cfg, cell)
    bspec = SH.batch_specs(cfg, cell, mesh)
    placed_batch = SH.place(mesh, {k: bspec[k] for k in batch}, batch)
    if train:
        pspec = SH.param_specs(cfg, pstr, mesh, fsdp=True)
        fn = make_train_step(cfg, AdamWConfig(), use_flash=use_flash,
                             grad_bf16=grad_bf16)
        args = (SH.place(mesh, pspec, pstr),
                SH.place(mesh, SH.opt_specs(pspec), SP.opt_structs(pstr)),
                placed_batch)
        tokens = cell.global_batch * cell.seq_len
    else:
        pspec = SH.param_specs(cfg, pstr, mesh, fsdp=False)
        cache = SH.place(mesh, SH.cache_specs(cfg, cell, mesh),
                         SP.cache_structs(cfg, cell))
        params = SH.place(mesh, pspec, pstr)
        if cell.kind == "prefill":
            fn = make_prefill_step(cfg)
            args = (params, placed_batch, cache)
            tokens = cell.global_batch * cell.seq_len
        else:
            # a host int, as the port's decode step takes it: the last
            # slot of the cell's cache
            fn = make_decode_step(cfg)
            args = (params, placed_batch["tokens"], cell.seq_len - 1, cache)
            tokens = cell.global_batch             # one new token per seq
    meta = {"cfg": cfg, "cell": cell, "mesh": mesh, "tokens": tokens}
    return fn, args, meta


def _local_bytes(tree) -> int:
    """A tree's local storage bytes, each storage once."""
    storages = {t.untyped_storage()._cdata: t.untyped_storage().nbytes()
                for t in _tensors(tree)}
    return sum(storages.values())


class _Tally(LiveBytes, CollectiveCounter):
    """The collectives, the FLOPs of the local ops
    (``torch.utils.flop_counter``'s formulas) and the live local storage
    bytes of one rank (plan-lint's tally, ``conv/analyze.py``
    ``LiveBytes``)."""

    def __init__(self, inputs):
        from torch.utils.flop_counter import FlopCounterMode
        CollectiveCounter.__init__(self)
        LiveBytes.__init__(self, inputs)
        self.flops = FlopCounterMode(display=False)
        self.n_ops = 0

    def dispatched(self, func, args, kwargs, out) -> None:
        super().dispatched(func, args, kwargs, out)
        self.n_ops += 1
        self.flops._count_flops(func._overloadpacket, out, args, kwargs)
        for t in _tensors(out):
            self._track(t)


def trace_cell(fn, args, meta) -> dict:
    """Run ``fn(*args)`` once on the cell's mesh under ``_Tally``; the
    record's trace fields."""
    train = meta["cell"].kind == "train"
    tally = _Tally(args)
    t0 = time.perf_counter()
    with activation_sharding(meta["mesh"]), tally, \
            torch.set_grad_enabled(train):
        out = fn(*args)
    seconds = time.perf_counter() - t0
    return {"collectives": tally.result(), "collective_ops": tally.ops,
            "flops_per_device": float(tally.flops.get_total_flops()),
            "argument_size_in_bytes": _local_bytes(args),
            "temp_size_in_bytes": tally.peak,
            "output_size_in_bytes": _local_bytes(out),
            "n_ops": tally.n_ops, "lower_s": seconds}


def _model_flops(cfg, cell, tokens):
    if cfg.encdec:
        enc_p, dec_p = cfg.encdec_split()
        B = cell.global_batch
        f = 6.0 if cell.kind == "train" else 2.0
        if cell.kind == "train":
            return f * (enc_p * B * cell.seq_len
                        + dec_p * B * cfg.max_dec_len)
        if cell.kind == "prefill":
            return f * (enc_p * B * cell.seq_len + dec_p * B)
        return f * dec_p * B
    return model_flops(cfg.n_active_params(), tokens,
                       train=(cell.kind == "train"))


def dry_run(arch, shape, multi_pod: bool = False, variant: str = "",
            **build) -> dict:
    """One cell's record fields (no status, no file): a fake process
    group of the mesh's rank count started, the cell built and traced,
    the group destroyed whatever happens."""
    mesh_shape = build.get("mesh_shape") or PRODUCTION[multi_pod]
    world = 1
    for s in mesh_shape:
        world *= s
    start_fake_group(world)
    try:
        t0 = time.perf_counter()
        fn, args, meta = build_cell(arch, shape, multi_pod, variant, **build)
        place_s = time.perf_counter() - t0
        rec = trace_cell(fn, args, meta)
    finally:
        dist.destroy_process_group()
    cfg, cell = meta["cfg"], meta["cell"]
    n_dev = world
    ac = analytic_costs(cfg, cell)
    mf = _model_flops(cfg, cell, meta["tokens"])
    rec.update({
        "n_devices": n_dev, "mesh_shape": list(mesh_shape),
        "place_s": place_s,
        "analytic_flops": ac["flops"], "analytic_bytes": ac["bytes"],
        "roofline": roofline_terms(ac["flops"] / n_dev, ac["bytes"] / n_dev,
                                   rec["collectives"]["total_bytes"]),
        "model_flops": mf,
        "useful_flops_ratio": (mf / ac["flops"]) if ac["flops"] else 0.0})
    return rec


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: str,
             force: bool = False, verbose: bool = True, variant: str = "",
             **build):
    """One cell's record, written to (or, unless ``force``, read from)
    ``out_dir``: ``status`` ok / skip (the reference's long-context skip)
    / fail (with the error).  ``build``: ``build_cell``'s options."""
    mesh_tag = "pod512" if multi_pod else "pod256"
    if variant:
        mesh_tag = f"{mesh_tag}__{variant}"
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{arch}__{shape_name}__{mesh_tag}.json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)

    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_tag,
           "status": "ok"}
    if shape_name == "long_500k" and not LONG_CONTEXT_OK[arch]:
        rec["status"] = "skip"
        rec["reason"] = "pure full-attention arch; see DESIGN.md §4"
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        if verbose:
            print(f"[{arch} x {shape_name} x {mesh_tag}] SKIP "
                  f"({rec['reason']})")
        return rec

    try:
        rec.update(dry_run(arch, shape_name, multi_pod, variant, **build))
        if verbose:
            t = rec["roofline"]
            print(f"[{arch} x {shape_name} x {mesh_tag}] OK  "
                  f"flops={rec['analytic_flops']:.3e} "
                  f"bytes={rec['analytic_bytes']:.3e} "
                  f"coll/dev={rec['collectives']['total_bytes']:.3e}  "
                  f"dominant={t['dominant']} "
                  f"bound={t['bound_s']*1e3:.2f}ms "
                  f"useful={rec['useful_flops_ratio']:.2f} "
                  f"temp/dev={rec['temp_size_in_bytes']/1e9:.1f}GB "
                  f"(trace {rec['lower_s']:.0f}s)", flush=True)
    except Exception as e:
        rec["status"] = "fail"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
        if verbose:
            print(f"[{arch} x {shape_name} x {mesh_tag}] FAIL: {rec['error']}",
                  flush=True)

    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def _cell_command(arch, shape, args):
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
           "--arch", arch, "--shape", shape, "--out-dir", args.out_dir]
    if args.multi_pod:
        cmd.append("--multi-pod")
    if args.force:
        cmd.append("--force")
    if args.variant:
        cmd += ["--variant", args.variant]
    return cmd


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_NAMES)
    ap.add_argument("--shape", choices=[s.name for s in SHAPES])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--variant", default="", choices=("", "ring", "ep"),
                    help="hillclimb config tag ('ring' or 'ep')")
    ap.add_argument("--out-dir", default=os.path.abspath(OUT_DIR))
    args = ap.parse_args(argv)

    if args.all:
        cells = [(arch, s.name) for arch in ARCH_NAMES for s in SHAPES]

        def one(cell):
            r = subprocess.run(_cell_command(*cell, args),
                               env=dict(os.environ))
            return cell if r.returncode else None
        # a traced cell holds one core and a few hundred MB: half the
        # host's cores trace at once, one process a cell
        jobs = max(1, len(os.sched_getaffinity(0)) // 2)
        with ThreadPoolExecutor(jobs) as pool:
            fails = [c for c in pool.map(one, cells) if c]
        if fails:
            print("FAILED CELLS:", fails)
            sys.exit(1)
        return

    if not (args.arch and args.shape):
        ap.error("--arch and --shape required (or --all)")
    rec = run_cell(args.arch, args.shape, args.multi_pod, args.out_dir,
                   force=args.force, variant=args.variant)
    if rec["status"] == "fail":
        sys.exit(1)


if __name__ == "__main__":
    main()
