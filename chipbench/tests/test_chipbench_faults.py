"""Each cell's check, driven on the host at a small size: a sound run is
correct; the control (the reference with TF32 operands in the program's
place) and each fault the cell can have, planted under the timed path,
come out not correct.  The card's own readings are in PERF.md; this keeps
the check's power to fail from being lost."""
import json
import pathlib

import pytest
import torch

from chipbench import harness, run

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
SERVING = ["vgg16-t1.infer-b64", "paper-table1.sweep-b64",
           "vgg16-t1.open-ragged"]
CPU = torch.device("cpu")
SEED = 2 ** 33 + 101


def execute(cell, cfg, seconds=0.3):
    return run.execute(cell, cfg, BENCH, seed=SEED, seconds=seconds,
                       trace=0, device=CPU)


def exceeds(checks, limits):
    return any(v > limits[k] for k, v in checks.items())


@pytest.mark.parametrize("name", SERVING + ["vgg16-t1.train-b32"])
def test_sound_run_is_correct(small, name):
    out = execute(*small(name))
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("name", SERVING + ["vgg16-t1.train-b32"])
def test_control_fails(small, name):
    cell, cfg = small(name)
    drv = harness.driver_for(cell)
    ctx = harness.Context(cell=cell, cfg=cfg, seed=SEED, seconds=0.3,
                          device=CPU)
    state = drv.setup(ctx)
    import time
    ctx.deadline = time.perf_counter() + 0.3
    rec = drv.window(ctx, state)
    drv.free(state)
    assert exceeds(drv.control(ctx, state, rec), cell["limits"])


def _half_batch(call):
    """Half of every batch left out: the rows past the first half come
    back as zeros."""
    def wrapped(self, x, **kw):
        y = call(self, x, **kw)
        h = max(1, y.shape[0] // 2)
        if y.shape[0] > 1:
            y = torch.cat([y[:h], torch.zeros_like(y[h:])])
        else:
            y = torch.zeros_like(y)
        return y
    return wrapped


def _altered(call):
    """An answer altered where it is produced: one output value moved by
    a thousandth of the largest."""
    def wrapped(self, x, **kw):
        y = call(self, x, **kw).clone()
        y.view(-1)[0] += 1e-3 * y.abs().max()
        return y
    return wrapped


@pytest.mark.parametrize("fault", [_half_batch, _altered])
@pytest.mark.parametrize("name", SERVING)
def test_serving_fault_fails(small, monkeypatch, name, fault):
    from repro_torch.conv.plan import PreparedConv
    monkeypatch.setattr(PreparedConv, "__call__",
                        fault(PreparedConv.__call__))
    out = execute(*small(name))
    assert not out["correct"], out["checks"]


def test_train_state_unchanged_fails(small, monkeypatch):
    from repro_torch.optim import adamw

    def unchanged(grads, state, params, cfg):
        return params, state, {}
    monkeypatch.setattr(adamw, "adamw_update", unchanged)
    out = execute(*small("vgg16-t1.train-b32"))
    assert not out["correct"], out["checks"]
    assert out["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_train_half_batch_fails(small, monkeypatch):
    """Half of the batch left out, the loss taken as twice the rest (the
    mean over the rows that are left, scaled back to a sum)."""
    from repro_torch.models import layers
    monkeypatch.setattr(layers, "conv_block", _half_training_batch(layers))
    out = execute(*small("vgg16-t1.train-b32"))
    assert not out["correct"], out["checks"]


def test_train_in_place_optimizer_is_correct(small, monkeypatch):
    """A sound optimizer that writes its results into the old parameters
    and moments in place: what set-up and the window copied aside keeps
    the check sound."""
    from repro_torch.optim import adamw
    update = adamw.adamw_update

    def in_place(grads, state, params, cfg):
        new, st, info = update(grads, state, params, cfg)
        with torch.no_grad():
            for tree, src in ((params, new), (state["mu"], st["mu"]),
                              (state["nu"], st["nu"])):
                for a, b in zip(adamw.tree_leaves(tree),
                                adamw.tree_leaves(src)):
                    a.copy_(b)
            state["step"].copy_(st["step"])
        return params, state, info
    monkeypatch.setattr(adamw, "adamw_update", in_place)
    out = execute(*small("vgg16-t1.train-b32"))
    assert out["correct"], out["checks"]


def _stale_weights(layers):
    """The forward keeps the kernels it first saw (a cache of kernel
    spectra that goes stale across updates); gradients still reach the
    live kernels."""
    block, seen = layers.conv_block, {}

    def stale(x, k, *a, **kw):
        old = seen.setdefault(tuple(k.shape), k.detach().clone())
        return block(x, k + (old - k).detach(), *a, **kw)
    return stale


def _half_training_batch(layers):
    """Half of every step's batch left out (its first half twice), at the
    first layer, known by its kernel's shape."""
    block, first = layers.conv_block, {}

    def half(x, k, *a, **kw):
        if first.setdefault("shape", tuple(k.shape)) == tuple(k.shape):
            h = x.shape[0] // 2
            x = torch.cat([x[:h], x[:h]])
        return block(x, k, *a, **kw)
    return half


@pytest.mark.parametrize("fault", ["stale_weights", "half_batch",
                                   "state_unchanged"])
def test_train_fault_in_the_window_fails(small, monkeypatch, fault):
    """A fault that starts only when the window opens, after the set-up
    steps that the reference follows from the start: the window's last
    step catches it."""
    from repro_torch.models import layers
    from repro_torch.optim import adamw
    cell, cfg = small("vgg16-t1.train-b32")
    drv = harness.driver_for(cell)
    window = drv.window

    def planted(ctx, state):
        if fault == "state_unchanged":
            monkeypatch.setattr(adamw, "adamw_update",
                                lambda g, s, p, c: (p, s, {}))
        else:
            make = {"stale_weights": _stale_weights,
                    "half_batch": _half_training_batch}[fault]
            monkeypatch.setattr(layers, "conv_block", make(layers))
        return window(ctx, state)
    monkeypatch.setattr(drv, "window", planted)
    out = execute(cell, cfg)
    assert not out["correct"], out["checks"]
    first = ("loss_gap", "grad_gap", "change_gap")
    assert all(out["checks"][k]["value"] <= cell["limits"][k]
               for k in first), out["checks"]
