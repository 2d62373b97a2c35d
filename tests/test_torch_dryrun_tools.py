"""The dry-run's arithmetic and tooling against the JAX package:
``launch.analytic`` (every arch x shape cell, the ``ring`` and ``ep``
configs too, within 1e-12), ``launch.roofline``'s terms with the
reference's rates, ``launch.report``'s text for the same records,
``launch.env``'s mesh shape and its guard; the collective table that
plan-lint and the roofline share; and ``roofline.CollectiveCounter`` on a
fake process group."""
import dataclasses
import importlib
import io
import json
import os
import sys
from contextlib import redirect_stdout

import pytest
import torch
import torch.distributed as dist

from repro.configs import get_config as jget_config
from repro.launch import analytic as JA
from repro.launch import env as JENV
from repro.launch import report as JREPORT
from repro.launch import roofline as JR
from repro.models.common import SHAPES as JSHAPES
from repro_torch.configs import ARCH_NAMES, LONG_CONTEXT_OK, get_config
from repro_torch.launch import analytic as TA
from repro_torch.launch import dryrun
from repro_torch.launch import env as TENV
from repro_torch.launch import mesh as M
from repro_torch.launch import report as TREPORT
from repro_torch.launch import roofline as TR
from repro_torch.models.common import SHAPES

VARIANTS = {"": {}, "ring": dict(ring_local_cache=True),
            "ep": dict(moe_ep=True)}


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-300)


@pytest.mark.parametrize("shape", [s.name for s in SHAPES])
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_analytic_costs_equal_the_reference(arch, shape):
    """The stronger twin of ``test_analytic_costs_positive``: the port's
    model gives the reference's numbers, in the base, ``ring`` and ``ep``
    configs and with the dry-run's ``moe_groups``."""
    cell = next(s for s in SHAPES if s.name == shape)
    jcell = next(s for s in JSHAPES if s.name == shape)
    for variant, changes in VARIANTS.items():
        for groups in (None, 16, 32):
            extra = dict(changes)
            if groups is not None:
                extra["moe_groups"] = groups
            t = TA.analytic_costs(
                dataclasses.replace(get_config(arch), **extra), cell)
            j = JA.analytic_costs(
                dataclasses.replace(jget_config(arch), **extra), jcell)
            for k in ("flops", "bytes"):
                assert _rel(t[k], j[k]) <= 1e-12, (arch, shape, variant, k)
            assert t["flops"] > 0 and t["bytes"] > 0
    assert TA.N_MODEL == JA.N_MODEL == 16


@pytest.mark.parametrize("terms", [(1e12, 1e9, 0.0), (3e15, 2e12, 5e10),
                                   (0.0, 0.0, 7.0), (1e10, 1e13, 1e12)])
def test_roofline_terms_with_the_reference_rates(terms):
    rates = dict(peak_flops=JR.PEAK_FLOPS, hbm_bw=JR.HBM_BW,
                 link_bw=JR.LINK_BW)
    assert TR.roofline_terms(*terms, **rates) == JR.roofline_terms(*terms)
    ours = TR.roofline_terms(*terms)
    assert ours["bound_s"] == max(terms[0] / 989e12, terms[1] / 3.35e12,
                                  terms[2] / 450e9)


def test_model_flops_and_the_h100_rates():
    for n, d, train in ((14_000_000_000, 4096, True), (7, 3, False)):
        assert TR.model_flops(n, d, train=train) == JR.model_flops(
            n, d, train=train)
    assert (TR.PEAK_FLOPS, TR.HBM_BW, TR.LINK_BW) == (989e12, 3.35e12,
                                                      450e9)
    assert TR.COLL_KINDS == JR._COLL_KINDS


# --------------------------------------------------------------------------
# report
# --------------------------------------------------------------------------

def _records():
    """Records of every status and mesh, and a variant, with the keys the
    report reads (numbers from the analytic model)."""
    recs = []
    for i, arch in enumerate(ARCH_NAMES):
        for j, s in enumerate(SHAPES):
            for mesh in ("pod256", "pod512"):
                r = {"arch": arch, "shape": s.name, "mesh": mesh,
                     "status": "ok"}
                if s.name == "long_500k" and not LONG_CONTEXT_OK[arch]:
                    r["status"] = "skip"
                elif (i + j) % 7 == 3:
                    r["status"] = "fail"
                else:
                    ac = TA.analytic_costs(get_config(arch), s)
                    coll = {"total_bytes": 1.5e9 * (i + 1) / (j + 1)}
                    n = 256 if mesh == "pod256" else 512
                    r.update(analytic_flops=ac["flops"],
                             analytic_bytes=ac["bytes"], collectives=coll,
                             roofline=TR.roofline_terms(
                                 ac["flops"] / n, ac["bytes"] / n,
                                 coll["total_bytes"]),
                             useful_flops_ratio=0.1 * (j + 1),
                             temp_size_in_bytes=3e9 * (i + j))
                recs.append(r)
    ring = dict(recs[5], mesh="pod256__ring")
    recs.append(ring)
    return recs


def _printed(main, out_dir, argv_prefix):
    buf = io.StringIO()
    old = sys.argv
    sys.argv = [argv_prefix, "--out-dir", str(out_dir)]
    try:
        with redirect_stdout(buf):
            main() if main is JREPORT.main else main(sys.argv[1:])
    finally:
        sys.argv = old
    return buf.getvalue()


def test_report_prints_the_reference_text(tmp_path):
    for n, r in enumerate(_records()):
        (tmp_path / f"{n}.json").write_text(json.dumps(r))
    ours = _printed(TREPORT.main, tmp_path, "report")
    theirs = _printed(JREPORT.main, tmp_path, "report")
    # the meshes are of ranks, not chips: the headings say so
    assert ours == theirs.replace(" chips)", " ranks)")
    assert "### Mesh single-pod 16x16 (256 ranks)" in ours
    assert "hillclimb variants" in ours and "| skip |" in ours


# --------------------------------------------------------------------------
# env
# --------------------------------------------------------------------------

@pytest.mark.parametrize("ndev,model", [(8, 1), (8, 2), (8, 8), (6, 3),
                                        (1, 1), (8, 3), (4, 0), (4, -2),
                                        (0, 1), ("4", "2")])
def test_env_mesh_shape_matches_the_reference(ndev, model):
    try:
        want = JENV.mesh_shape(ndev, model=model)
    except Exception as e:               # the same error, the same words
        with pytest.raises(type(e)) as got:
            TENV.mesh_shape(ndev, model=model)
        assert str(got.value) == str(e)
    else:
        assert TENV.mesh_shape(ndev, model=model) == want


def test_env_values_and_main(capsys):
    v = TENV.rank_env(4, cores=8)
    assert v == {"OMP_NUM_THREADS": "2", "GLOO_SOCKET_IFNAME": "lo"}
    assert TENV.rank_env(16, cores=8)["OMP_NUM_THREADS"] == "1"
    assert TENV.rank_env(2, cores=8, extra=(("OMP_NUM_THREADS", "3"),)
                         )["OMP_NUM_THREADS"] == "3"
    with pytest.raises(ValueError):
        TENV.rank_env(0)
    env = {}
    assert TENV.apply(4, cores=8, env=env) == v and env == v
    assert TENV.main(["--ndev", "2", "--print"]) == 0
    line = capsys.readouterr().out.strip()
    assert line.startswith("OMP_NUM_THREADS=") and " GLOO_SOCKET_IFNAME=lo" \
        in line


def test_env_apply_raises_once_a_process_group_started():
    assert not dist.is_initialized()
    threads = torch.get_num_threads()
    M.start_process_group("gloo")
    try:
        with pytest.raises(RuntimeError, match="process group"):
            TENV.apply(2)
        # an explicit mapping is only composed, never too late
        assert TENV.apply(2, cores=4, env={})["OMP_NUM_THREADS"] == "2"
    finally:
        M.destroy_process_group()
    assert torch.get_num_threads() == threads


# --------------------------------------------------------------------------
# the collective table and its counter
# --------------------------------------------------------------------------

# plan-lint's names and operand arguments before the table grew its HLO
# kinds: they must not change
PLAN_LINT = {
    ("c10d", "alltoall_base_"): ("all_to_all", 1),
    ("c10d", "alltoall_"): ("all_to_all", 1),
    ("c10d", "allreduce_"): ("psum", 0),
    ("c10d", "allreduce_coalesced_"): ("psum", 0),
    ("c10d", "allgather_"): ("all_gather", 1),
    ("c10d", "_allgather_base_"): ("all_gather", 1),
    ("c10d", "allgather_coalesced_"): ("all_gather", 1),
    ("c10d", "allgather_into_tensor_coalesced_"): ("all_gather", 1),
    ("c10d", "send"): ("ppermute", 0),
    ("c10d", "recv_"): ("ppermute", 0),
}


def test_the_collective_table_keeps_plan_lint_names():
    table = importlib.import_module("repro_torch.conv.analyze")._COLLECTIVE_OPS
    for key, entry in table.items():
        ns, op = key
        # what plan-lint read for the op before: its entry, or the op's
        # own name and argument 0
        assert entry[:2] == PLAN_LINT.get(key, (f"{ns}.{op}", 0)), key
        assert entry[2] in TR.COLL_KINDS, key
    assert set(PLAN_LINT) <= set(table)
    kinds = {e[2] for e in table.values()}
    assert kinds == set(TR.COLL_KINDS)


def test_collective_counter_on_a_fake_mesh():
    """Each redistribution of a ``DTensor`` on a fake (2, 2) ``cuda`` mesh
    counts as the collective NCCL would run, with its per-rank result
    bytes; a ``cpu`` mesh turns the shard-to-shard all-to-all into an
    all-gather (and a chunk)."""
    from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                          Shard)
    got = {}
    for device_type in ("cuda", "cpu"):
        dryrun.start_fake_group(4)
        try:
            mesh = M.make_mesh((2, 2), ("data", "model"),
                               device_type=device_type)
            x = DTensor.from_local(torch.empty(4, 8, device="meta"), mesh,
                                   [Shard(0), Replicate()], run_check=False,
                                   shape=(8, 8), stride=(8, 1))
            with TR.CollectiveCounter() as c:
                x.redistribute(mesh, [Shard(1), Replicate()])   # 8x4 local
                x.redistribute(mesh, [Replicate(), Replicate()])  # 8x8
                p = DTensor.from_local(torch.empty(4, 8, device="meta"),
                                       mesh, [Shard(0), Partial()],
                                       run_check=False, shape=(8, 8),
                                       stride=(8, 1))
                p.redistribute(mesh, [Shard(0), Replicate()])   # 4x8
            got[device_type] = c.result()
        finally:
            dist.destroy_process_group()
    cuda, cpu = got["cuda"], got["cpu"]
    assert cuda["counts"] == {"all-gather": 1, "all-reduce": 1,
                              "reduce-scatter": 0, "all-to-all": 1,
                              "collective-permute": 0}
    assert cuda["bytes"]["all-to-all"] == 8 * 4 * 4
    assert cuda["bytes"]["all-gather"] == 8 * 8 * 4
    assert cuda["bytes"]["all-reduce"] == 4 * 8 * 4
    assert cuda["total_bytes"] == sum(cuda["bytes"].values())
    assert cpu["counts"]["all-to-all"] == 0
    assert cpu["counts"]["all-gather"] == 2
