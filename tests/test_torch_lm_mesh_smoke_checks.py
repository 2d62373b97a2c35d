"""Phase 20 (``lm_mesh``) of chip_smoke.py rehearsed on the CPU: the
full-width run's function at deepseek's small form on a one-rank gloo
(1, 1) mesh, its gates, and each gate failing on a planted fault: a wrong
exchange permutation and a dropped shared expert (the float32 gate on the
logits), the exchange count, and logits gathered on the vocab before
``cross_entropy`` (on two spawned gloo ranks, where a gather is a
collective)."""
import importlib.util
import json
import os
import pathlib
import subprocess
import sys

import pytest

from repro_torch.launch import mesh as M

ROOT = pathlib.Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)


@pytest.fixture(scope="module")
def full_run():
    M.start_process_group("gloo")
    try:
        mesh = M.make_host_mesh(1, 1)
        yield (smoke.lm_mesh_full(mesh, smoke=True, device="cpu"),
               smoke.lm_vocab_record(mesh, device="cpu"))
    finally:
        M.destroy_process_group()


def test_full_run_passes_its_gates_on_the_host(full_run):
    r, vocab = full_run
    smoke.check_lm_mesh_full(r)
    smoke.check_lm_vocab(vocab)
    # one rank: the expert-parallel and the TP dispatch are the same ops
    assert r["err"] == 0.0 and r["err_float32_prefill"] == 0.0
    assert r["all_to_all_recorded"] == 2 * r["moe_layers"] * r["steps"]
    assert r["collectives"] == {
        "alltoall_base_": r["short_all_to_all_recorded"]}
    assert r["tokens_shape"] == [smoke.LM_MESH_BATCH, smoke.LM_MESH_GEN]
    assert vocab["collectives"] == {}


def _faulty(r, **kw):
    return dict(r, **kw)


def test_each_gate_fails_on_a_planted_fault(full_run):
    """The planted faults' float32 prefills read beyond ``LM_TOL``: a run
    whose output is theirs fails the logits gate; an exchange too few or
    too many, another collective, a copy of the weights, a launch, fail
    theirs."""
    r, _ = full_run
    faults = r["err_planted_faults"]
    assert set(faults) == {"exchange_rolled", "shared_dropped"}
    for name, err in faults.items():
        assert err > smoke.LM_TOL, name
        with pytest.raises(AssertionError):
            smoke.check_lm_mesh_full(_faulty(r, err_float32_prefill=err))
    one_launch = dict(r["launches"], cgemm=1)
    n, m = r["all_to_all_recorded"], r["short_all_to_all_recorded"]
    for bad in ({"all_to_all_recorded": n - 1},
                {"short_all_to_all_recorded": m + 1},
                {"collectives": {"alltoall_base_": m + 1}},
                {"collectives": {"alltoall_base_": m, "allreduce_": 1}},
                {"err": 2 * smoke.LM_FULL_TOL}, {"shares_storage": False},
                {"finite": False}, {"launches": one_launch},
                {"err_planted_faults": dict(faults, shared_dropped=0.0)}):
        with pytest.raises(AssertionError):
            smoke.check_lm_mesh_full(_faulty(r, **bad))


_RANK = r"""
import json, os, sys
import chip_smoke as smoke
from repro_torch.launch import mesh as M
rank = int(sys.argv[1])
M.start_process_group("gloo", rank=rank, world_size=2,
                      store_path=sys.argv[2] + "/store")
mesh = M.make_host_mesh(1, 2)
out = {k: smoke.lm_vocab_record(mesh, device="cpu", gather=k == "gathered")
       for k in ("sound", "gathered")}
if rank == 0:
    with open(sys.argv[2] + "/vocab.json", "w") as f:
        json.dump(out, f)
M.destroy_process_group()
"""


def test_vocab_gate_sees_logits_gathered_on_two_ranks(tmp_path):
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(ROOT), str(ROOT / "src")]))
    procs = [subprocess.Popen([sys.executable, "-c", _RANK, str(r),
                               str(tmp_path)], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        logs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    out = json.loads((tmp_path / "vocab.json").read_text())
    smoke.check_lm_vocab(out["sound"])
    assert out["sound"]["placements"] == ["R", "S(2)"]
    assert out["gathered"]["loss_err"] <= smoke.LM_TOL
    with pytest.raises(AssertionError, match="gathers"):
        smoke.check_lm_vocab(out["gathered"])
