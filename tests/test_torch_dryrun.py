"""The dry-run (``repro_torch.launch.dryrun``) on the host: small forms of
one dense model, one MoE through the expert-parallel MoE and one through
the TP-MoE, the SSM hybrid and whisper traced on a fake (16, 16) mesh in
subprocesses (status ``ok``, the record's keys, 2 all-to-alls a MoE layer
for EP); a MoE train step on ``meta`` stand-ins without a mesh (the
expert count had no meta kernel); the process left as the dry-run found
it; and the twin of ``test_dryrun_records_complete`` over the port's out
dir."""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as M
from repro_torch.launch import specs as SP
from repro_torch.models.common import SHAPES, ShapeCell
from repro_torch.optim import AdamWConfig
from repro_torch.train import make_train_step

ROOT = pathlib.Path(__file__).resolve().parents[1]

# (arch, shape, variant): a dense model with FSDP, the TP-MoE with FSDP,
# a MoE served with ``--variant ep`` (the small form's 8 experts do not
# divide 16 ranks: the TP-MoE serves), the SSM hybrid serving (its 8 SSM
# heads of the small form on 16 ranks), whisper serving
CELLS = [("qwen3-14b", "train_4k", ""), ("mixtral-8x7b", "train_4k", ""),
         ("deepseek-v2-lite-16b", "decode_32k", "ep"),
         ("hymba-1.5b", "decode_32k", ""),
         ("whisper-small", "decode_32k", "")]

RECORD_KEYS = {"arch", "shape", "mesh", "status", "collectives",
               "collective_ops", "flops_per_device", "argument_size_in_bytes",
               "temp_size_in_bytes", "output_size_in_bytes", "n_ops",
               "lower_s", "n_devices", "mesh_shape", "place_s",
               "analytic_flops", "analytic_bytes", "roofline", "model_flops",
               "useful_flops_ratio"}

_CELL = r"""
import json, sys
from repro_torch.launch import dryrun
arch, shape, variant, out = sys.argv[1:]
rec = dryrun.run_cell(arch, shape, False, out, verbose=False,
                      variant=variant, smoke=True)
print("RECORD " + json.dumps(rec))
"""


@pytest.fixture(scope="module")
def small_cells(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", _CELL, *cell, str(out)],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cell in CELLS]
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    recs = {}
    for cell, p, log in zip(CELLS, procs, logs):
        assert p.returncode == 0, log[-3000:]
        line = next(ln for ln in log.splitlines() if ln.startswith("RECORD "))
        recs[cell] = json.loads(line[len("RECORD "):])
    return recs


@pytest.mark.parametrize("cell", CELLS, ids=lambda c: "-".join(filter(None, c)))
def test_small_form_traces_on_the_production_mesh(small_cells, cell):
    rec = small_cells[cell]
    assert rec["status"] == "ok", rec.get("error")
    assert RECORD_KEYS <= set(rec)
    assert rec["mesh"] == ("pod256__ep" if cell[2] else "pod256")
    assert rec["n_devices"] == 256 and rec["mesh_shape"] == [16, 16]
    coll = rec["collectives"]
    assert set(coll["counts"]) == set(coll["bytes"]) == {
        "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
        "collective-permute"}
    assert coll["total_bytes"] == sum(coll["bytes"].values()) > 0
    assert sum(coll["counts"].values()) == sum(rec["collective_ops"].values())
    assert rec["flops_per_device"] > 0 and rec["n_ops"] > 0
    assert rec["temp_size_in_bytes"] >= rec["argument_size_in_bytes"] > 0
    assert rec["roofline"]["bound_s"] == max(
        rec["roofline"][k] for k in ("compute_s", "memory_s",
                                     "collective_s"))
    if cell[2] == "ep":
        # the expert-parallel MoE runs where the experts divide the model
        # axis (else the TP-MoE): 2 all-to-alls a MoE layer
        cfg = get_config(cell[0], smoke=True)
        ep = cfg.n_experts % 16 == 0
        assert rec["collective_ops"].get("c10d.alltoall_base_", 0) == \
            2 * (cfg.n_layers - cfg.first_dense) * ep


def test_records_and_report_of_the_small_cells(small_cells, tmp_path,
                                               capsys):
    from repro_torch.launch import report
    for n, rec in enumerate(small_cells.values()):
        (tmp_path / f"{n}.json").write_text(json.dumps(rec))
    report.main(["--out-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "4 ok / 0 skip / 0 fail (4 baseline cells)" in out
    assert out.count("| ok |") == 5


def test_moe_steps_trace_on_meta_stand_ins():
    """A MoE train step on ``meta`` parameters, AdamW state and batch,
    with no mesh, and an expert-parallel decode step on a fake (1, 4)
    mesh: both dispatches count their experts at a static shape
    (``torch.bincount`` has no meta kernel)."""
    cfg = dataclasses.replace(get_config("mixtral-8x7b", smoke=True),
                              dtype="float32")
    params = SP.param_structs(cfg)
    cell = ShapeCell("t", 16, 4, "train")
    step = make_train_step(cfg, AdamWConfig())
    p1, o1, m = step(params, SP.opt_structs(params),
                     SP.input_specs(cfg, cell))
    assert m["loss"].device.type == "meta" and m["loss"].shape == ()
    assert all(a.shape == b.shape for a, b in zip(
        torch.utils._pytree.tree_leaves(p1),
        torch.utils._pytree.tree_leaves(params)))
    ep = get_config("deepseek-v2-lite-16b", smoke=True)
    rec = dryrun.dry_run("deepseek-v2-lite-16b", ShapeCell("d", 64, 4,
                                                           "decode"),
                         variant="ep", mesh_shape=(1, 4), smoke=True)
    assert rec["collective_ops"]["c10d.alltoall_base_"] == \
        2 * (ep.n_layers - ep.first_dense)


def test_dryrun_leaves_the_process_as_it_found_it():
    """The dry-run destroys the fake group it started, and refuses to run
    in a process that holds a group (it would need its own)."""
    assert not dist.is_initialized()
    rec = dryrun.dry_run("mamba2-2.7b", ShapeCell("d", 64, 4, "decode"),
                         mesh_shape=(1, 1), smoke=True)
    assert not dist.is_initialized() and rec["n_devices"] == 1
    M.start_process_group("gloo")
    try:
        with pytest.raises(RuntimeError, match="already holds one"):
            dryrun.dry_run("mamba2-2.7b", "decode_32k", smoke=True)
        assert dist.get_backend() == "gloo"
    finally:
        M.destroy_process_group()


def test_dryrun_records_complete():
    """The twin of ``tests/test_launch.py``'s: the port's dry-run records
    (``python -m repro_torch.launch.dryrun --all [--multi-pod]``, not
    committed) cover all 40 cells x 2 meshes with no failure."""
    d = dryrun.OUT_DIR
    if not os.path.isdir(d):
        pytest.skip("dry-run artifacts not generated yet")
    recs = {}
    for fn in os.listdir(d):
        if fn.endswith(".json") and "__ring" not in fn and "__ep" not in fn:
            with open(os.path.join(d, fn)) as f:
                r = json.load(f)
            recs[(r["arch"], r["shape"], r["mesh"])] = r["status"]
    for mesh in ("pod256", "pod512"):
        for arch in ARCH_NAMES:
            for s in SHAPES:
                st = recs.get((arch, s.name, mesh))
                assert st in ("ok", "skip"), (arch, s.name, mesh, st)
