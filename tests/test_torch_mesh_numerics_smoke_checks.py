"""Phase 22 (``mesh_numerics``) of chip_smoke.py rehearsed on the CPU under
the host's torch: one spawn of four gloo ranks at (1, 4) (child processes,
as the phase runs them), mixtral's expert-parallel form stepped with FSDP
against the same step on plain tensors, sound and with a planted fault
(``unreduced``: a per-rank body's partial-sum gradient taken as reduced),
and the kv2 form served with its cache split on its sequence.  The gates
pass on the sound records and fail on the planted fault and on each
planted miss of a record: an error, a difference beyond the tolerance,
parameters not placed as their specs or not finite, tokens that differ."""
import copy
import importlib.util
import pathlib

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)

FAULTY = "moe_ep!unreduced"


@pytest.fixture(scope="module")
def recs():
    return smoke.mesh_numerics_child(
        (("moe_ep", (1, 4)), (FAULTY, (1, 4))), (("kv2", (1, 4)),))


def _sound(recs):
    out = copy.deepcopy(recs)
    for rec in out.values():
        rec["train"].pop(FAULTY)
    return out


def test_phase_passes_its_gates_on_the_host(recs):
    assert list(recs) == ["1x4"]
    rec = recs["1x4"]
    assert rec["torch"] == torch.__version__ and rec["mesh"] == [1, 4]
    assert smoke.mesh_numerics_misses(_sound(recs)) == []
    step = rec["train"]["moe_ep"]
    assert set(step["vs_local"]) == {"loss", "grad_norm", "mu", "nu"}
    # the expert-parallel MoE exchanged tokens: 2 all-to-alls a MoE layer
    # forward and 2 backward
    assert step["collectives"]["alltoall_base_"] > 0
    served = rec["serve"]["kv2"]
    assert served["tokens_equal"]
    assert served["k_spec"] == [None, "data", None, "model", None]
    assert len(served["steps_vs_local"]) == smoke.MESH_NUMERICS_SERVE[2] + 1


def test_each_gate_fails_on_a_planted_fault(recs):
    faulty = recs["1x4"]["train"][FAULTY]
    assert max(faulty["vs_local"].values()) > 1e3 * smoke.MESH_NUMERICS_TOL
    misses = smoke.mesh_numerics_misses(recs)
    assert len(misses) == 1 and misses[0].startswith(f"train {FAULTY}")

    def fails(kind, name, **changes):
        bad = _sound(recs)
        bad["1x4"][kind][name].update(changes)
        assert smoke.mesh_numerics_misses(bad), (kind, name, changes)

    step = recs["1x4"]["train"]["moe_ep"]
    fails("train", "moe_ep", error="RuntimeError: planted")
    for key in step["vs_local"]:
        fails("train", "moe_ep", vs_local=dict(
            step["vs_local"], **{key: 2 * smoke.MESH_NUMERICS_TOL}))
    fails("train", "moe_ep", placed_as_specs=False)
    fails("train", "moe_ep", finite=False)
    served = recs["1x4"]["serve"]["kv2"]
    fails("serve", "kv2", error="RuntimeError: planted")
    fails("serve", "kv2", tokens_equal=False)
    fails("serve", "kv2", steps_vs_local=served["steps_vs_local"][:-1]
          + [2 * smoke.MESH_NUMERICS_TOL])
