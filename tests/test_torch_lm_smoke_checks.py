"""Phase 18 (``lm_serve``) of chip_smoke.py rehearsed on the CPU: for
each of the ten architectures at its small form, the float32 run from
``serve``'s decode position against itself on the host (the card's side
of the check), its greedy tokens, and the bf16 decode steps against the
teacher-forced forward at the reference's tolerance; the planted faults
of its full-width check and the gates on that check's record."""
import importlib.util
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

ROOT = pathlib.Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)


@pytest.mark.parametrize("arch", smoke.ARCH_NAMES)
def test_lm_small_phase_on_the_host(arch):
    r = smoke.lm_small(arch, device="cpu")
    assert r["card_vs_host_max"] == 0.0
    assert len(r["card_vs_host"]) == smoke.LM_STEPS + 2
    assert len(r["tokens"]) == smoke.LM_BATCH
    assert len(r["tokens"][0]) == smoke.LM_STEPS + 1



def test_planted_faults_differ_from_the_sound_forward():
    """Each of phase 18's planted faults, on qwen3's small form in float32
    on the host, computes other logits than the sound ``lm_forward``."""
    cfg = smoke.dataclasses.replace(smoke.get_config("qwen3-14b", smoke=True),
                                    dtype="float32")
    params = smoke.LM.init_lm_params(cfg, torch.Generator().manual_seed(0))
    seq = torch.tensor(np.random.default_rng(0).integers(1, cfg.vocab,
                                                         (2, 9)))
    with torch.inference_mode():
        sound = smoke.LM.lm_forward(params, cfg, seq)[:, -1]
    faults = smoke.lm_planted_faults(params, cfg, seq)
    assert set(faults) == {"qk_norm_off", "rope_theta_1e4",
                           "last_layer_skipped"}
    for name, f in faults.items():
        assert f.shape == sound.shape
        assert smoke.lm_scaled_err(f, sound) > 1e-3, name


def _lm_full_record(**kw):
    r = {"launches": dict.fromkeys(smoke.read_counts(), 0), "finite": True, "tokens_shape": [4, 16],
         "logits_shape": [4, 1, smoke.get_config("qwen3-14b").vocab],
         "err": 0.045, "err_float32": 1.4e-5, "err_one_position_off": 1.47,
         "err_planted_faults": {"qk_norm_off": 1.0, "rope_theta_1e4": 0.6,
                                "last_layer_skipped": 0.5}}
    r.update(kw)
    return r


def test_check_lm_full_gates():
    """The full-width record passes when the served step is within
    ``LM_FULL_TOL`` in bf16 and ``LM_TOL`` in float32 and every planted
    fault reads beyond ``LM_FULL_TOL``, and no kernel launched in the
    child; it fails otherwise."""
    smoke.check_lm_full(_lm_full_record())
    tol = smoke.LM_FULL_TOL
    one_launch = dict.fromkeys(smoke.read_counts(), 0)
    one_launch[next(iter(one_launch))] = 1
    for bad in ({"launches": one_launch}, {"err": 2 * tol}, {"err_float32": 10 * smoke.LM_TOL},
                {"finite": False}, {"tokens_shape": [4, 15]},
                {"err_one_position_off": tol / 2},
                {"err_planted_faults": {"qk_norm_off": 1.0,
                                        "rope_theta_1e4": tol / 2,
                                        "last_layer_skipped": 0.5}}):
        with pytest.raises(AssertionError):
            smoke.check_lm_full(_lm_full_record(**bad))
