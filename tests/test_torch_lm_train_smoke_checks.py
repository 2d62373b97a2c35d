"""Phase 19 (``lm_train``) of chip_smoke.py rehearsed on the CPU: each
small form's train step against itself on the host (the card's side of
the check), microbatches and remat; the resume check, which must fail on
a perturbed leaf; and the full-width run's gradient gates at hymba's
small form, where every planted fault must read beyond both gates, with
the gates on that run's record."""
import dataclasses
import importlib.util
import pathlib

import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

ROOT = pathlib.Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)

from torch_lm_train import one_torch_thread  # noqa: E402,F401

SMALL_RUN = ["--arch", "hymba-1.5b", "--smoke", "--batch", "2", "--seq",
             "16", "--steps", "3", "--device", "cpu"]


@pytest.mark.parametrize("arch", smoke.ARCH_NAMES)
def test_lm_train_small_phase_on_the_host(arch):
    r = smoke.lm_train_small(arch, device="cpu")
    assert set(r["card_vs_host"].values()) == {0.0}
    assert r["remat_off_err"] == (None if arch in smoke.LM_ALWAYS_REMAT
                                  else 0.0)
    assert r["microbatches_2_err"] <= smoke.LM_TOL


@pytest.fixture(scope="module")
def small_run():
    return smoke.lm_train_full_child(SMALL_RUN, remat_seq=32)


def test_grad_gates_pass_on_a_sound_small_run(small_run):
    """At hymba's small form the sound run passes every gate of the
    full-width check, and each planted fault reads beyond both gradient
    gates."""
    smoke.check_lm_train_full(small_run)
    assert small_run["losses_finite"] and len(small_run["losses"]) == 3
    assert set(small_run["faults"]) == {
        "labels_shifted", "ssd_branch_detached", "last_unit_left_out"}
    for name, f in small_run["faults"].items():
        assert f["grad_max"] > smoke.LM_TRAIN_BF16_TOL, name
        assert f["fd_err"] > smoke.LM_TRAIN_FD_TOL, name


def _faulty(r, **kw):
    return dict(r, **kw)


def test_check_lm_train_full_gates(small_run):
    r = small_run
    assert set(r["launches"].values()) == {0}
    one_launch = dict(r["launches"])
    one_launch[next(iter(one_launch))] = 1
    for bad in (
            {"launches": one_launch}, {"losses_finite": False}, {"params_finite": False},
            {"bf16": dict(r["bf16"], grad_max=2 * smoke.LM_TRAIN_BF16_TOL)},
            {"fd": dict(r["fd"], err=2 * smoke.LM_TRAIN_FD_TOL)},
            {"remat_err": 10 * smoke.LM_REMAT_TOL},
            {"faults": dict(r["faults"], labels_shifted={
                "grad_max": 1.0, "fd_err": smoke.LM_TRAIN_FD_TOL / 2})},
            {"faults": dict(r["faults"], last_unit_left_out={
                "grad_max": smoke.LM_TRAIN_BF16_TOL / 2, "fd_err": 1.0})},
            {"faults": {k: r["faults"][k] for k in
                        ("labels_shifted", "last_unit_left_out")}}):
        with pytest.raises(AssertionError):
            smoke.check_lm_train_full(_faulty(r, **bad))


def test_ssd_fault_detaches_one_layer():
    """The planted SSD fault zeroes the grads of one unit's mamba slices
    and of no other unit's."""
    cfg = dataclasses.replace(smoke.get_config("hymba-1.5b", smoke=True),
                              dtype="float32")
    params, _ = smoke.init_train_state(cfg, 0, device="cpu")
    batch = smoke.lm_train_batch(cfg, "cpu")
    with smoke.ssd_detached(params, 2):
        _, g = smoke.loss_and_grads(params, cfg, batch)
    _, g0 = smoke.loss_and_grads(params, cfg, batch)
    w = g["layers"][0]["mamba"]["w_z"]
    assert float(w[2].abs().max()) == 0.0
    assert all(float(w[u].abs().max()) > 0 for u in (0, 1, 3))
    assert torch.equal(g["layers"][0]["mamba"]["w_z"][3],
                       g0["layers"][0]["mamba"]["w_z"][3])


def test_resume_check_fails_on_a_perturbed_leaf():
    smoke.lm_resume("qwen3-14b", "cpu")
    whole = smoke.train_launch.main(smoke.LM_RESUME_ARGS
                                    + ["--arch", "qwen3-14b", "--device",
                                       "cpu"])
    resumed = dataclasses.replace(whole, losses={3: 0.0, 4: 0.0,
                                                 5: whole.loss})
    smoke.check_lm_resume("qwen3-14b", whole, resumed)
    leaf = whole.opt["mu"]["embed"]
    one_ulp = torch.nextafter(leaf, torch.full_like(leaf, float("inf")))
    bad = dataclasses.replace(resumed, opt=dict(
        whole.opt, mu=dict(whole.opt["mu"], embed=one_ulp)))
    with pytest.raises(AssertionError, match="embed"):
        smoke.check_lm_resume("qwen3-14b", whole, bad)
    with pytest.raises(AssertionError, match="final loss"):
        smoke.check_lm_resume("qwen3-14b", whole, dataclasses.replace(
            resumed, loss=whole.loss + 1e-3))
