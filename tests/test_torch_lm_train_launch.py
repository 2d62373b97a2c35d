"""The training launcher twin, ``repro_torch.launch.train``, on the CPU:

- ``--smoke --steps 6 --batch 2 --seq 16 --device cpu`` prints the lines
  that ``repro.launch.train`` prints for the same flags (the losses and
  milliseconds aside: the weights are each package's own draw);
- a run checkpointed every 3 steps and resumed from step 3 ends with the
  uninterrupted run's final loss and parameters, bit for bit;
- the train state it checkpoints restores through
  ``repro.checkpoint.restore`` with the same keys and values;
- with no device given and no GPU, the launcher, ``init_train_state`` and
  the LM data streams raise rather than run on the host;
- the example twin (``repro_torch.examples.train_lm``) runs.
"""
import dataclasses
import json
import os
import re
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

import jax  # noqa: E402

import repro.checkpoint as jckpt  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.train import init_train_state as jinit_train_state  # noqa: E402
from repro_torch import data as tdata, train as ttrain  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.examples import train_lm  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.optim import tree_leaves  # noqa: E402

import torch_lm_common as C  # noqa: E402
from torch_lm_train import one_torch_thread  # noqa: E402,F401

SMOKE = ["--smoke", "--steps", "6", "--batch", "2", "--seq", "16"]


def _shape(lines):
    """The printed lines with each loss and time replaced by a mark."""
    out = []
    for ln in lines:
        ln = re.sub(r"loss -?\d+\.\d+", "loss <loss>", ln)
        ln = re.sub(r"\d+ms", "<ms>ms", ln)
        ln = re.sub(r"final loss \S+", "final loss <loss>", ln)
        out.append(ln)
    return out


def test_launcher_prints_the_reference_lines(capsys):
    run = train.main(SMOKE + ["--device", "cpu"])
    ours = capsys.readouterr().out.splitlines()
    loss = jtrain.main(SMOKE)
    theirs = capsys.readouterr().out.splitlines()
    assert _shape(ours) == _shape(theirs)
    assert ours[0] == theirs[0]       # arch=qwen3-14b params=0.2M ...
    assert [ln.split()[1] for ln in ours[1:-1]] == ["0", "5"]
    assert ours[-1] == f"done; final loss {run.loss}"
    assert sorted(run.losses) == list(range(6))
    assert all(np.isfinite(v) for v in run.losses.values())
    # the two packages' losses start near ln(vocab) and fall alike
    assert abs(run.losses[0] - float(theirs[1].split()[3])) < 0.1
    assert abs(run.loss - loss) < 0.1


def _run(tmp_path, *extra, ckpt=True):
    argv = SMOKE + ["--device", "cpu", "--arch", "hymba-1.5b"]
    if ckpt:
        argv += ["--ckpt-dir", str(tmp_path), "--ckpt-every", "3"]
    return train.main(argv + list(extra))


def test_resume_is_bit_exact(tmp_path, capsys):
    """Checkpoints at steps 3 and 6; the step-6 one is then taken away, as
    if the run had died after step 5, and ``--resume`` carries on from
    step 3.  Hymba's small form: meta tokens, SSD, per-layer windows."""
    whole = _run(tmp_path, ckpt=False)
    first = _run(tmp_path)
    assert sorted(os.listdir(tmp_path)) == ["step_00000003", "step_00000006"]
    shutil.rmtree(tmp_path / "step_00000006")
    capsys.readouterr()
    resumed = _run(tmp_path, "--resume")
    assert "resumed from step 3" in capsys.readouterr().out
    assert sorted(resumed.losses) == [3, 4, 5]
    for run in (first, resumed):
        assert run.loss == whole.loss
        for a, b in zip(tree_leaves((run.params, run.opt)),
                        tree_leaves((whole.params, whole.opt))):
            assert torch.equal(a, b)


def test_checkpoint_restores_in_the_reference(tmp_path):
    """The launcher's train state ``{"params", "opt"}`` restores through
    ``repro.checkpoint.restore`` onto the reference's own state for the
    config: the same keys, and the port's values."""
    run = _run(tmp_path, "--steps", "3")
    cfg = jget_config("hymba-1.5b", smoke=True)
    jparams, jopt = jax.eval_shape(lambda k: jinit_train_state(cfg, k),
                                   jax.random.PRNGKey(0))
    target = {"params": jparams, "opt": jopt}
    with open(tmp_path / "step_00000003" / "meta.json") as f:
        keys = json.load(f)["keys"]
    shapes = {jax.tree_util.keystr(p): tuple(v.shape) for p, v in
              jax.tree_util.tree_flatten_with_path(target)[0]}
    assert sorted(keys) == sorted(shapes)
    state, meta = jckpt.restore(str(tmp_path), 3, target)
    assert meta["step"] == 3
    got = C.flat_jax(state)
    want = {k: v.numpy() for k, v in
            C.flat_torch({"params": run.params, "opt": run.opt}).items()}
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == shapes[k], k
        assert np.array_equal(got[k], want[k]), k


def test_moe_trains_in_one_dispatch_group(monkeypatch):
    """MoE runs with ``moe_groups=1``, as the reference launcher forces,
    whatever the config says."""
    cfg = dataclasses.replace(get_config("mixtral-8x7b", smoke=True),
                              moe_groups=4)
    monkeypatch.setattr(train, "get_config", lambda arch, smoke: cfg)
    args = train.parse_args(["--arch", "mixtral-8x7b", "--smoke"])
    assert train.config(args).moe_groups == 1
    run = train.main(["--smoke", "--steps", "2", "--batch", "2", "--seq",
                      "8", "--device", "cpu", "--arch", "mixtral-8x7b"])
    assert run.cfg.moe_groups == 1 and np.isfinite(run.loss)


def test_size_overrides_and_microbatches():
    run = train.main(["--smoke", "--steps", "2", "--batch", "4", "--seq",
                      "8", "--device", "cpu", "--d-model", "32",
                      "--n-layers", "2", "--n-heads", "2", "--n-kv", "1",
                      "--d-ff", "48", "--vocab", "128", "--microbatches",
                      "2"])
    cfg = run.cfg
    assert (cfg.d_model, cfg.n_layers, cfg.n_heads, cfg.n_kv, cfg.d_ff,
            cfg.vocab, cfg.head_dim) == (32, 2, 2, 1, 48, 128, 16)
    assert run.params["embed"].shape == (128, 32)


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the host "
                    "without a GPU")
def test_entry_points_want_a_gpu_unless_told_otherwise():
    cfg = get_config("qwen3-14b", smoke=True)
    dc = tdata.DataConfig(vocab=cfg.vocab, seq_len=9, global_batch=2)
    for call in (lambda: train.main(SMOKE),
                 lambda: ttrain.init_train_state(cfg, 0),
                 lambda: tdata.lm_batch(dc, 0),
                 lambda: tdata.frames_batch(dc, 0, d_model=8, frames=4)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_train_lm_example_runs(capsys):
    run = train_lm.main(["--arch", "mamba2-2.7b", "--steps", "3", "--batch",
                         "2", "--seq", "16", "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.startswith("arch=mamba2-2.7b ")
    assert "done; final loss" in out and np.isfinite(run.loss)
