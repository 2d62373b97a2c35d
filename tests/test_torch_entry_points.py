"""The port's small entry points against the JAX package's, on the CPU.

- The deprecated shims ``repro_torch.core.fft_conv2d`` (routed to
  ``fft-torch``) and ``fft_conv2d_pallas`` (routed to ``fft-cuda``, whose
  kernels run their plain versions on a CPU tensor): both warn, as
  ``repro.core``'s do, and match the reference shims on the same numpy
  inputs at the tolerances of ``tests/test_fftconv_core.py::
  test_deprecated_shims_still_work`` (2e-4 and 3e-4, there against the
  direct oracle).  ``bm`` naming a row of the CGEMM's tile table works; a
  triple naming no row is the plan's ``ValueError``.
- The example twins ``repro_torch.examples.quickstart`` and
  ``serve_batcher`` with ``--device cpu``, against the reference examples
  run in this process: the same backends chosen; the relative error and
  the grad norm (both float32 rounding, under 1e-6 in either package)
  within 1e-5 absolute of the reference's; the served trace's request,
  batch and occupancy figures, the dedupe report, the oversize rejection
  and the shape after the weight update equal.  Both modules also run as
  ``python -m``.
- ``serve --analyze`` (plan-lint, ``repro_torch.conv.analyze``): the
  fixed-shape loop certifies every layer before serving and serves what
  it serves without the flag; with ``--serve-trace`` the flag is
  accepted and the trace served, as the reference's serve does (its
  trace mode plans inside the engine and lints nothing).
- ``serve``'s defaults: with no flags both ``main``s serve ``--arch
  qwen3-14b`` at full width; ``--convnet vgg``, ``--serve-trace`` and
  ``--tune`` take both to the conv trunk.
"""
import contextlib
import io
import os
import runpy
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

import jax.numpy as jnp

import repro.core as jcore
import repro_torch.core as tcore
from repro_torch.conv import plan_conv
from repro_torch.examples import quickstart, serve_batcher
from repro_torch.launch import serve

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
NAMES = {"direct": "direct", "fft-xla": "fft-torch",
         "fft-pallas": "fft-cuda"}
EXAMPLE_TOL = 1e-5          # absolute, on numbers that are rounding noise


def _np(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _reference_example(name):
    """Run ``examples/<name>.py`` of the JAX package here; its globals."""
    with contextlib.redirect_stdout(io.StringIO()):
        return runpy.run_path(os.path.join(ROOT, "examples", f"{name}.py"))


# --------------------------------------------------------------------------
# The deprecated shims
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name,tol", [("fft_conv2d", 2e-4),
                                      ("fft_conv2d_pallas", 3e-4)])
def test_shims_warn_and_match_the_reference(name, tol):
    x, k = _np((1, 3, 12, 12), 13), _np((2, 3, 3, 3), 14)
    with pytest.warns(DeprecationWarning, match=name):
        y = getattr(tcore, name)(torch.from_numpy(x), torch.from_numpy(k),
                                 padding=1)
    with pytest.warns(DeprecationWarning, match=name):
        yj = getattr(jcore, name)(jnp.asarray(x), jnp.asarray(k), padding=1)
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), rtol=tol, atol=tol)
    y0 = tcore.conv2d_direct(torch.from_numpy(x), torch.from_numpy(k),
                             padding=1)
    np.testing.assert_allclose(y.numpy(), y0.numpy(), rtol=tol, atol=tol)


def test_shims_are_exported_as_the_reference_exports_them():
    assert {"fft_conv2d", "fft_conv2d_pallas"} <= set(tcore.__all__)
    assert {"fft_conv2d", "fft_conv2d_pallas"} <= set(jcore.__all__)


def test_shim_routes_to_its_backend(monkeypatch):
    """``fft_conv2d`` plans ``fft-torch`` and ``fft_conv2d_pallas``
    ``fft-cuda``, with the caller's knobs."""
    import repro_torch.conv as tconv
    seen = []

    def spy(*args, **kw):
        plan = plan_conv(*args, **kw)
        seen.append((plan.backend, plan.spec.delta, plan.three_m, plan.bm))
        return plan
    monkeypatch.setattr(tconv, "plan_conv", spy)
    x, k = torch.from_numpy(_np((1, 3, 12, 12), 1)), \
        torch.from_numpy(_np((2, 3, 3, 3), 2))
    with pytest.warns(DeprecationWarning):
        tcore.fft_conv2d(x, k, padding=1, delta=8, three_m=False)
    with pytest.warns(DeprecationWarning):
        tcore.fft_conv2d_pallas(x, k, padding=1, bm=16)
    assert seen == [("fft-torch", 8, False, None), ("fft-cuda", 16, True, 16)]


@pytest.mark.parametrize("bm", [64, 4, 8, 16, 32])
def test_pallas_shim_takes_a_tile_row(bm):
    x, k = _np((2, 4, 16, 16), 3), _np((8, 4, 3, 3), 4)
    with pytest.warns(DeprecationWarning):
        y = tcore.fft_conv2d_pallas(torch.from_numpy(x), torch.from_numpy(k),
                                    padding=1, bm=bm)
    y0 = tcore.conv2d_direct(torch.from_numpy(x), torch.from_numpy(k),
                             padding=1)
    np.testing.assert_allclose(y.numpy(), y0.numpy(), rtol=3e-4, atol=3e-4)


@pytest.mark.parametrize("blocks", [dict(bm=48), dict(bm=64, bn=128),
                                    dict(bn=128), dict(bk=32)],
                         ids=["no-bm-row", "bm-bn-mismatch", "bn-many-rows",
                              "bk-no-row"])
def test_pallas_shim_refuses_a_triple_that_names_no_row(blocks):
    x, k = torch.zeros((1, 3, 12, 12)), torch.zeros((2, 3, 3, 3))
    with pytest.raises(ValueError) as plan_err:
        plan_conv(tuple(x.shape), tuple(k.shape), padding=1,
                  backend="fft-cuda", **blocks)
    with pytest.warns(DeprecationWarning), \
            pytest.raises(ValueError) as shim_err:
        tcore.fft_conv2d_pallas(x, k, padding=1, **blocks)
    assert str(shim_err.value) == str(plan_err.value)
    assert "tile table" in str(shim_err.value)


# --------------------------------------------------------------------------
# The example twins
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def quickstarts():
    return quickstart.main(["--device", "cpu"]), \
        _reference_example("quickstart")


def test_quickstart_twin_matches_the_reference(quickstarts):
    ours, ref = quickstarts
    assert ours.backend == NAMES[ref["plan"].backend] == "fft-torch"
    assert ours.tiny_backend == NAMES[ref["tiny"].backend] == "direct"
    assert abs(ours.rel_err - ref["err"]) <= EXAMPLE_TOL
    assert ours.rel_err <= EXAMPLE_TOL
    grad_norm = float(jnp.linalg.norm(ref["g"]))
    assert abs(ours.grad_norm - grad_norm) <= EXAMPLE_TOL
    assert ours.prepared_matches


def test_quickstart_twin_prints_the_reference_lines(quickstarts):
    """Line for line the reference's text, up to the numbers that are
    rounding and the backend's name."""
    ours, ref = quickstarts
    plan = ref["plan"]
    assert ours.lines[0].startswith("output (2, 128, 56, 56), rel err")
    assert ours.lines[1] == plan.describe().replace("fft-xla", "fft-torch")
    spec = plan.spec
    assert ours.lines[2] == (
        f"tiling: {spec.X}x{spec.D} tiles of {spec.delta}x{spec.delta}, "
        f"P=130 frequency points (real layout), "
        f"CGEMM {spec.M}x{spec.C}x{spec.Cout}")
    assert ours.lines[3] == ("auto backend for a 1x1-kernel layer: direct "
                             "(vs fft-torch for the VGG layer)")
    assert ours.lines[-1] == "prepared exec matches one-shot: True"


@pytest.fixture(scope="module")
def serve_batchers():
    return serve_batcher.main(["--device", "cpu"]), \
        _reference_example("serve_batcher")


def test_serve_batcher_twin_matches_the_reference(serve_batchers):
    ours, ref = serve_batchers
    rep, jrep = ours.report, ref["rep"]
    keys = ("n_requests", "n_batches", "occupancy")
    assert {label: {k: b[k] for k in keys}
            for label, b in rep["buckets"].items()} == \
        {label: {k: b[k] for k in keys}
         for label, b in jrep["buckets"].items()}
    for k in ("n_requests", "n_rejected", "real_rows", "padded_rows",
              "occupancy", "queue_depth_max", "replica_batches",
              "plan_cache_misses_after_warmup"):
        assert rep[k] == jrep[k], k
    assert (rep["n_requests"], rep["n_rejected"]) == (16, 1)
    assert rep["executor"] == "eager"
    jbr = ref["engine"].bucket_report()
    for k in ("n_buckets", "n_layer_plans", "n_distinct_plans"):
        assert ours.bucket_report[k] == jbr[k], k
    assert ours.rejected
    rid = max(ref["engine"].results)
    assert ours.updated_shape == tuple(ref["engine"].results[rid].shape) \
        == (3, 16, 32, 32)
    assert ours.engine.weights_version == ref["engine"].weights_version == 1


def test_serve_batcher_twin_serves_the_reference_results(serve_batchers):
    """The same numpy draws give the same requests and weights: every
    request's rows, before and after the weight update, within 1e-4 of
    the largest |y| of the reference engine's (as
    tests/test_torch_batcher.py holds the engines)."""
    ours, ref = serve_batchers
    theirs = ref["engine"].results
    assert sorted(ours.engine.results) == sorted(theirs) == list(range(17))
    assert ours.engine.placements[16] == ("b4", 0, 0)
    for rid, y in ours.engine.results.items():
        yj = np.asarray(theirs[rid])
        scale = np.abs(yj).max()
        np.testing.assert_allclose(y.numpy() / scale, yj / scale, atol=1e-4)


@pytest.mark.parametrize("name", ["quickstart", "serve_batcher"])
def test_example_twin_runs_as_a_module(name):
    out = subprocess.run(
        [sys.executable, "-m", f"repro_torch.examples.{name}", "--device",
         "cpu"], capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")))
    assert out.returncode == 0, out.stderr[-3000:]
    want = {"quickstart": "prepared exec matches one-shot: True",
            "serve_batcher": "after weight update: result (3, 16, 32, 32)"}
    assert want[name] in out.stdout


# --------------------------------------------------------------------------
# serve --analyze
# --------------------------------------------------------------------------

def _serve_lines(capsys, *flags):
    serve.main(["--convnet", "vgg", "--conv-backend", "fft-cuda", "--smoke",
                "--batch", "1", "--gen", "2", "--device", "cpu", *flags])
    return capsys.readouterr().out.splitlines()


def test_serve_analyze_certifies_and_serves_the_same(capsys):
    """``serve --analyze --conv-backend fft-cuda --smoke --batch 1 --gen 2
    --device cpu`` prints the reference's plan-lint line and serves; its
    ``output:`` line is the one the same run prints without the flag."""
    lines = _serve_lines(capsys, "--analyze")
    lint = [l for l in lines if l.startswith("plan-lint:")]
    assert len(lint) == 1
    assert lint[0].startswith("plan-lint: OK — 9 layers certified, "
                              "collectives/pass: all_to_all=0 psum=0, "
                              "peak live ~")
    assert "  total collectives/pass: all_to_all=0 psum=0" in lines
    plain = _serve_lines(capsys)
    assert not [l for l in plain if l.startswith("plan-lint:")]
    output = [l for l in lines if l.startswith("output:")]
    assert len(output) == 1
    assert output == [l for l in plain if l.startswith("output:")]


def test_serve_trace_takes_analyze(capsys):
    """``serve --serve-trace --analyze --device cpu`` serves the trace (the
    flag no longer refuses)."""
    res = serve.main(["--serve-trace", "--analyze", "--conv-backend",
                      "fft-cuda", "--image", "32", "--max-batch", "2",
                      "--trace-requests", "4", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "serve-trace mode=bucketed" in out
    assert res.reports["bucketed"]["n_requests"] == 4
    assert all(bool(torch.isfinite(y).all())
               for y in res.engines["bucketed"].results.values())


# --------------------------------------------------------------------------
# serve's defaults
# --------------------------------------------------------------------------

class _Resolved(Exception):
    pass


def _resolve(monkeypatch, module, argv):
    """What ``module.main(argv)`` would serve, stopped before it builds
    anything: ("lm", arch, smoke) or ("convnet", name)."""
    def lm(name, smoke=False):
        raise _Resolved("lm", name, smoke)

    def convnet(args):
        raise _Resolved("convnet", args.convnet)

    monkeypatch.setattr(module, "get_config", lm)
    monkeypatch.setattr(module, "serve_convnet", convnet)
    with pytest.raises(_Resolved) as e:
        module.main(argv)
    return e.value.args


@pytest.mark.parametrize("argv", [[], ["--smoke"], ["--arch", "mamba2-2.7b"],
                                  ["--convnet", "vgg"], ["--serve-trace"],
                                  ["--tune"], ["--analyze"]],
                         ids=lambda a: " ".join(a) or "no flags")
def test_serve_defaults_match_the_reference(monkeypatch, argv):
    """Both ``main``s resolve the same flags to the same system; with none
    it is ``--arch qwen3-14b`` at full width."""
    from repro.launch import serve as jserve
    got = _resolve(monkeypatch, serve, argv)
    assert got == _resolve(monkeypatch, jserve, argv)
    if not argv:
        assert got == ("lm", "qwen3-14b", False)
