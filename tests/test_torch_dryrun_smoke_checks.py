"""Phase 21 (``dryrun``) of chip_smoke.py rehearsed on the CPU: its child's
dry-runs at the small forms (phases 18-20's runs on a fake (1, 1) mesh,
the two production cells on the fake (16, 16) one), held against phase
records of the shape phases 18-20 emit, and each gate failing on a planted
fault: a collective count off by one, another collective, a busy time
under its bound, a production cell that failed (a decode or a train
cell), an EP trace short of its all-to-alls, qwen3-14b's decode step
moving more than ``DRYRUN_DECODE_BYTES`` a rank, a kernel launch."""
import copy
import importlib.util
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)


@pytest.fixture(scope="module")
def child():
    return smoke.dryrun_child(smoke=True)


def _phases(r, busy_share=0.5):
    """Records as phases 18-20 emit them, whose busy times are the
    dry-run's bounds over ``busy_share`` and whose peaks are twice its
    estimates; phase 20's ``CommDebugMode`` counts over a short run of 2
    steps are what the dry-run traced."""
    phases = {}
    for name, (_, _, _, _, busy_key, peak_key) in smoke.dryrun_runs().items():
        d = r["runs"][name]
        phases[name] = {
            busy_key: {"busy_ms": d["roofline"]["bound_s"] * 1e3
                       / busy_share},
            peak_key: 2 * d["temp_size_in_bytes"]}
    d = r["runs"]["lm_mesh_full"]
    phases["lm_mesh_full"].update(
        short_steps=2, moe_layers=d["collective_ops"]["c10d.alltoall_base_"]
        // 2, collectives={k.split(".")[1]: 2 * n for k, n in
                          d["collective_ops"].items()})
    return phases


def test_child_passes_its_gates_on_the_host(child):
    rows = smoke.dryrun_readings(child, _phases(child))
    smoke.check_dryrun(child, rows)
    assert set(rows) == {"lm_serve_full", "lm_train_full", "lm_mesh_full"}
    # phases 18 and 19 run plain tensors, and a (1, 1) mesh splits nothing
    assert rows["lm_serve_full"]["collectives"] == {}
    assert rows["lm_train_full"]["collectives"] == {}
    assert rows["lm_mesh_full"]["collectives"] == {
        "alltoall_base_": 2 * rows["lm_mesh_full"]["moe_layers"]}
    for row in rows.values():
        assert row["bound_share"] == pytest.approx(0.5)
        assert row["peak_ratio"] == pytest.approx(0.5)
    assert [(p["arch"], p["shape"], p["mesh"], p["status"])
            for p in child["production"]] == [
        ("qwen3-14b", "decode_32k", "pod256", "ok"),
        ("deepseek-v2-lite-16b", "decode_32k", "pod256__ep", "ok"),
        ("hymba-1.5b", "train_4k", "pod256", "ok"),
        ("whisper-small", "train_4k", "pod256", "ok")]
    assert all(p["lower_s"] > 0 for p in child["production"])


def test_each_gate_fails_on_a_planted_fault(child):
    def fails(r=child, phases=None, **row_changes):
        phases = phases or _phases(r)
        rows = smoke.dryrun_readings(r, phases)
        for name, changes in row_changes.items():
            rows[name].update(changes)
        with pytest.raises(AssertionError):
            smoke.check_dryrun(r, rows)

    # a collective too many in the phase, or one the phase never ran
    phases = _phases(child)
    phases["lm_mesh_full"]["collectives"]["alltoall_base_"] += 2
    fails(phases=phases)
    fails(lm_serve_full={"collectives": {"all_reduce": 1}})
    # EP short of its 2 all-to-alls a MoE layer on both sides
    fails(lm_mesh_full={"moe_layers": 1 + child["runs"]["lm_mesh_full"][
        "collective_ops"]["c10d.alltoall_base_"] // 2})
    # a busy time beating its bound by more than the slack
    fails(phases=_phases(child, busy_share=1 / (1 - 2 * smoke.DRYRUN_SLACK)))
    # ... but not within it
    smoke.check_dryrun(child, smoke.dryrun_readings(
        child, _phases(child, busy_share=1 / (1 - smoke.DRYRUN_SLACK / 2))))
    # a production cell failed, or its EP trace lost an all-to-all
    bad = copy.deepcopy(child)
    bad["production"][0] = {"arch": "qwen3-14b", "shape": "decode_32k",
                            "mesh": "pod256", "status": "fail",
                            "error": "RuntimeError: planted"}
    fails(r=bad)
    for i in range(len(child["production"])):
        bad = copy.deepcopy(child)
        bad["production"][i]["want_all_to_alls"] += 2
        fails(r=bad)
    # a train cell failed; qwen3-14b's decode moving the card's 1.57 GB a
    # rank (the gathered table), or just over the gate
    for i in (2, 3):
        bad = copy.deepcopy(child)
        bad["production"][i] = dict(bad["production"][i], status="fail",
                                    error="RuntimeError: planted")
        fails(r=bad)
    for moved in (1.57e9, smoke.DRYRUN_DECODE_BYTES * 1.01):
        bad = copy.deepcopy(child)
        bad["production"][0]["collectives"]["total_bytes"] = moved
        fails(r=bad)
    bad = copy.deepcopy(child)
    bad["production"][0]["collectives"]["total_bytes"] = \
        smoke.DRYRUN_DECODE_BYTES
    smoke.check_dryrun(bad, smoke.dryrun_readings(bad, _phases(bad)))
    # a kernel launched
    bad = copy.deepcopy(child)
    bad["launches"] = dict(bad["launches"], cgemm=1)
    fails(r=bad)
