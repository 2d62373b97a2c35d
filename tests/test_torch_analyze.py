"""Plan-lint in repro_torch (``repro_torch.conv.analyze``) on the CPU.

(a) Twins of the 19 tests of ``tests/test_analyze.py`` (40 cases), of
    ``tests/test_netplan.py::test_report_aggregates_stages_and_collectives``
    and ``::test_report_counts_sharded_collectives``, and of the three
    analyzer tests of ``tests/test_conv_overlap.py``, with the port's
    counts: it stacks the real and imaginary planes of a collective in one
    buffer, so nfft issues 3 all-to-alls where the reference's jaxpr has 6
    (2 prepared or replicated where it has 4; ``2k + 1`` overlapped where
    it has ``4k + 2``), and wfft 1 all-reduce where it has 2 psums (``k``
    where it has ``2k``).  The sharded plans run on a (1, 1) mesh over a
    one-rank gloo group, the fake tensors on the CPU.
(b) What running plans on fake tensors must not leave behind: the kernel
    wrappers' fake branch (the plain version's shapes and dtypes, no launch
    counted), a real forward after an analysis in a fresh process (a plain
    tensor, equal to 0.0 to one never preceded by an analysis, no fake
    tensor in any constant cache), the plan and prepared caches unchanged,
    and a plan at Table I's batch 64 analyzed without a real operand.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode

from repro_torch.conv import (
    Epilogue, NetworkConv, PlanProfile, analyze, backend_schedule_pairs,
    invariants_for, plan_conv, plan_network, prepared_cache_info,
    plan_cache_info, register_invariant,
)
from repro_torch.conv import stages
from repro_torch.conv.analyze import (
    _REGISTRY, VIOLATION_MODES, Invariant, main, seeded_violation,
)
from repro_torch.kernels import cgemm as kcgemm
from repro_torch.kernels import dft_tile as kdft
from repro_torch.launch import mesh as tmesh

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))

# the builtin pairs only (collected before any test registers more)
PAIRS = backend_schedule_pairs()


def _rand(shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32))


@pytest.fixture(scope="module")
def mesh():
    """A (1, 1) mesh on a one-rank gloo group, for the whole module."""
    tmesh.start_process_group("gloo")
    try:
        yield tmesh.make_host_mesh(1, 1)
    finally:
        tmesh.destroy_process_group()


def _plan(mesh, backend, schedule, **kw):
    return plan_conv((2, 3, 18, 18), (4, 3, 3, 3), padding=1,
                     backend=backend, schedule=schedule,
                     mesh=mesh if schedule != "local" else None, **kw)


def _analyze(target, **kw):
    return analyze(target, device="cpu", **kw)


# --------------------------------------------------------------------------
# (a) Every registered pair certifies, in every variant
# --------------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["full", "prepared", "epilogue"])
@pytest.mark.parametrize("backend,schedule", PAIRS,
                         ids=[f"{b}-{s}" for b, s in PAIRS])
def test_every_pair_certifies(mesh, backend, schedule, variant):
    kw = {}
    if variant == "epilogue":
        kw["epilogue"] = Epilogue(bias=True, activation="relu")
    plan = _plan(mesh, backend, schedule, **kw)
    profile = _analyze(plan, prepared=(variant == "prepared"))
    assert isinstance(profile, PlanProfile)
    profile.check().raise_if_failed()
    assert profile.n_eqns > 0
    assert profile.peak_live_bytes > 0
    if variant == "prepared":
        assert profile.prepared
        assert profile.elision is not None
    else:
        assert not profile.prepared
    if variant == "epilogue":
        assert profile.epilogue_delta is not None
    else:
        assert profile.epilogue_delta is None


def test_analyze_existing_prepared_conv(mesh):
    """analyze(PreparedConv) profiles the already-bound prepared state."""
    plan = _plan(mesh, "fft-torch", "nfft")
    profile = _analyze(plan.prepare(_rand(plan.k_shape, 0)))
    assert profile.prepared
    assert profile.collectives["all_to_all"] == 2
    assert profile.stage_counts.get("kernel_transform", 0) == 0
    profile.check().raise_if_failed()


def test_analyze_rejects_non_plans():
    with pytest.raises(TypeError, match="ConvPlan"):
        analyze(object())


# --------------------------------------------------------------------------
# Collective / dtype-flow facts (the paper's structural claims)
# --------------------------------------------------------------------------

def test_nfft_collective_and_dtype_facts(mesh):
    """nfft pays one all-to-all per live stage boundary; with bf16 compute
    the D and Z boundaries move half-width bytes while the kernel boundary
    stays f32."""
    p32 = _analyze(_plan(mesh, "fft-torch", "nfft"))
    assert p32.collectives == {"all_to_all": 3, "psum": 0, "ppermute": 0,
                               "all_gather": 0}
    p16 = _analyze(_plan(mesh, "fft-torch", "nfft",
                         compute_dtype=torch.bfloat16))
    assert p16.compute_dtype == "bfloat16"
    assert p16.cgemm_dtypes == ("bfloat16",)
    assert p16.collective_dtypes["all_to_all"] == {"bfloat16": 2,
                                                   "float32": 1}
    assert p16.collective_bytes < p32.collective_bytes  # casts shrink bytes
    assert not p16.has_f64 and not p32.has_f64
    p16.check().raise_if_failed()


def test_wfft_hot_psum_pair_in_compute_dtype(mesh):
    p = _analyze(_plan(mesh, "fft-cuda", "wfft",
                       compute_dtype=torch.bfloat16))
    assert p.collectives == {"all_to_all": 0, "psum": 1, "ppermute": 0,
                             "all_gather": 0}
    assert p.collective_dtypes["psum"] == {"bfloat16": 1}
    assert p.cgemm_dtypes == ("bfloat16",)
    p.check().raise_if_failed()


def test_prepared_and_replicated_elide_kernel_boundary(mesh):
    prep = _analyze(_plan(mesh, "fft-torch", "nfft"), prepared=True)
    assert prep.collectives["all_to_all"] == 2
    assert prep.elision == {"all_to_all": 1, "psum": 0, "ppermute": 0,
                            "all_gather": 0, "kernel_transform": 1}
    repl = _analyze(_plan(mesh, "fft-torch", "nfft",
                          replicate_kernel_transform=True))
    assert repl.collectives["all_to_all"] == 2
    repl.check().raise_if_failed()


def test_epilogue_delta_is_zero_everywhere(mesh):
    ep = Epilogue(bias=True, activation="silu", residual=True)
    p = _analyze(_plan(mesh, "fft-torch", "wfft", epilogue=ep))
    assert p.epilogue == ep.describe()
    assert all(v == 0 for v in p.epilogue_delta["collectives"].values())
    assert all(v == 0 for v in p.epilogue_delta["stage_counts"].values())


# --------------------------------------------------------------------------
# Invariant registry: wildcards, extension, custom rules
# --------------------------------------------------------------------------

def test_register_invariant_wildcard_merge():
    inv = register_invariant(
        "fft-torch", "local", "test-eqn-budget",
        lambda p: None if p.n_eqns < 10 ** 6 else "program too large",
        "a rule of this test only")
    try:
        names = [i.name for i in invariants_for("fft-torch", "local")]
        assert "test-eqn-budget" in names
        assert "no-f64" in names                       # ("*", "*") merged in
        assert "test-eqn-budget" not in [
            i.name for i in invariants_for("fft-cuda", "local")]
        report = _analyze(_plan(None, "fft-torch", "local")).check()
        assert "test-eqn-budget" in report.checked
        assert report.ok
    finally:
        _REGISTRY[("fft-torch", "local")].remove(inv)


def test_check_extra_rules_and_failure_raises():
    p = _analyze(_plan(None, "fft-torch", "local"))
    bad = Invariant("always-fails", lambda p: "boom")
    report = p.check(extra=[bad])
    assert not report.ok
    assert report.violations[0].invariant == "always-fails"
    with pytest.raises(AssertionError, match=r"(?s)plan-lint: .*always-fails"):
        report.raise_if_failed()


# --------------------------------------------------------------------------
# Network-wide aggregation
# --------------------------------------------------------------------------

def test_network_profile_aggregates_and_certifies(mesh):
    net = plan_network(
        [NetworkConv("c1", (2, 3, 18, 18), (4, 3, 3, 3), padding=1),
         NetworkConv("c2", (2, 4, 18, 18), (4, 4, 3, 3), padding=1,
                     epilogue=Epilogue(bias=True, activation="relu"))],
        backend="fft-torch", schedule="nfft", mesh=mesh)
    prof = net.analyze()
    assert list(prof.layers) == ["c1", "c2"]
    assert prof.total_collectives["all_to_all"] == sum(
        p.collectives["all_to_all"] for p in prof.layers.values()) == 6
    assert prof.peak_live_bytes == max(
        p.peak_live_bytes for p in prof.layers.values())
    assert prof.check() == []
    assert prof.raise_if_failed() is prof
    d = prof.to_dict()
    assert set(d["layers"]) == {"c1", "c2"}
    json.dumps(d)                                  # artifact-serializable
    # analyze() dispatches NetworkPlan to the same path
    assert list(analyze(net).layers) == ["c1", "c2"]


# --------------------------------------------------------------------------
# Negative path: a deliberately broken pipeline MUST be caught
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mode", VIOLATION_MODES)
def test_seeded_violation_is_caught(mesh, mode):
    kw = {"compute_dtype": torch.bfloat16} if mode == "skip-cast" else {}
    if mode == "overlap-oversend":
        kw["overlap"] = "slab:2"       # only overlapped plans hit the slab ops
    with seeded_violation(mode):
        p = _analyze(plan_conv((2, 4, 22, 22), (4, 4, 3, 3), padding=1,
                               backend="fft-torch", schedule="nfft",
                               mesh=mesh, **kw))
    report = p.check()
    assert not report.ok
    with pytest.raises(AssertionError, match="plan-lint"):
        report.raise_if_failed()


def test_seeded_violation_unknown_mode_and_restore():
    orig = stages._boundary_a2a
    with seeded_violation("extra-collective"):
        assert stages._boundary_a2a is not orig
    assert stages._boundary_a2a is orig            # restored on exit
    with pytest.raises(ValueError, match="unknown violation mode"):
        with seeded_violation("nope"):
            pass                                   # pragma: no cover


# --------------------------------------------------------------------------
# CLI gate (the CI entry point)
# --------------------------------------------------------------------------

def test_cli_check_passes_and_writes_json(tmp_path, capsys):
    out = tmp_path / "profiles.json"
    rc = main(["--check", "--limit", "1", "--batch", "2", "--device", "cpu",
               "--json-out", str(out)])
    assert rc == 0
    assert "plan-lint: OK" in capsys.readouterr().out
    payload = json.loads(out.read_text())
    assert payload
    sample = payload[next(iter(payload))]
    for field in ("collectives", "stage_counts", "peak_live_bytes",
                  "cgemm_dtypes"):
        assert field in sample


def test_cli_seeded_violation_fails_the_gate(capsys):
    """Acceptance: the gate exits non-zero when an invariant is broken."""
    rc = main(["--check", "--limit", "1", "--batch", "2", "--device", "cpu",
               "--inject", "extra-collective"])
    assert rc == 1
    assert "VIOLATION" in capsys.readouterr().out


def test_cli_without_action_exits_2(capsys):
    assert main([]) == 2


# --------------------------------------------------------------------------
# Canary: the static counts against what one real run records
# --------------------------------------------------------------------------

def test_static_counts_agree_with_a_real_run(mesh):
    """The twin of the reference's string canary: where the reference
    holds its equation walk against jax's pretty printer, the port holds
    the analyzer's counts and bytes against what ``stage_trace`` records
    around one real forward of the same plan."""
    plan = _plan(mesh, "fft-torch", "nfft")
    profile = _analyze(plan)
    with stages.stage_trace() as counts:
        plan(_rand(plan.x_shape, 1), _rand(plan.k_shape, 2))
    assert counts[("collective", "all_to_all")] \
        == profile.collectives["all_to_all"] == 3
    assert counts[("collective_bytes", "all_to_all")] \
        == profile.collective_bytes
    assert {k: v for k, v in counts.items() if isinstance(k, str)} \
        == profile.stage_counts


# --------------------------------------------------------------------------
# Twins of tests/test_netplan.py's report tests
# --------------------------------------------------------------------------

EP = Epilogue(bias=True, activation="relu")


def _layers():
    return [NetworkConv("c1", (2, 4, 16, 16), (4, 4, 3, 3), padding=1,
                        epilogue=EP),
            NetworkConv("c2", (2, 4, 16, 16), (4, 4, 3, 3), padding=1,
                        epilogue=EP),
            NetworkConv("c3", (2, 4, 16, 16), (8, 4, 3, 3), padding=1)]


def test_report_aggregates_stages_and_collectives():
    net = plan_network(_layers(), backend="fft-torch")
    rep = net.report()
    assert rep["n_layers"] == 3
    assert rep["n_distinct_plans"] == 2
    assert rep["total_stage_counts"]["cgemm"] == 3
    assert rep["total_stage_counts"]["kernel_transform"] == 3
    assert rep["total_collectives"]["all_to_all"] == 0   # local schedule
    assert rep["total_flops"] == sum(p.flops()
                                     for p in net.plans.values())
    assert "c1" in net.describe()


def test_report_counts_sharded_collectives(mesh):
    layers = [NetworkConv("s1", (2, 4, 16, 16), (4, 4, 3, 3), padding=1,
                          epilogue=EP)]
    net = plan_network(layers, backend="fft-torch", schedule="nfft",
                       mesh=mesh)
    rep = net.report()
    # 3 boundary all-to-alls (re/im stacked) for one nfft layer
    assert rep["total_collectives"]["all_to_all"] == 3
    desc = net.describe()
    assert "s1: fft-torch/nfft" in desc and "all_to_all=3" in desc
    assert "total collectives/pass: all_to_all=3 psum=0" in desc
    netw = plan_network(layers, backend="fft-torch", schedule="wfft",
                        mesh=mesh)
    repw = netw.report()
    assert repw["total_collectives"]["psum"] == 1    # the hot all-reduce
    assert repw["total_collectives"]["all_to_all"] == 0


# --------------------------------------------------------------------------
# Twins of tests/test_conv_overlap.py's analyzer tests
# --------------------------------------------------------------------------

@pytest.mark.parametrize("schedule", ["nfft", "wfft"])
def test_analyzer_certifies_overlap(mesh, schedule):
    plan = plan_conv((4, 4, 20, 20), (4, 4, 3, 3), padding=1,
                     schedule=schedule, mesh=mesh, overlap="slab:2")
    p = _analyze(plan)
    assert p.num_slabs == 2 and p.overlap == "slab:2"
    assert "slab:2" in p.describe_key()
    if schedule == "nfft":
        assert p.collectives["all_to_all"] == 2 * 2 + 1   # 2k+1
    else:
        assert p.collectives["psum"] == 2                 # k
    # overlapping must not move more bytes than the sequential twin
    assert p.overlap_delta is not None
    assert p.overlap_delta["ratio"] <= 1.005
    p.check().raise_if_failed()
    # prepared overlap still elides exactly the kernel boundary
    prep = _analyze(plan.prepare(_rand((4, 4, 3, 3), 9)))
    prep.check().raise_if_failed()
    if schedule == "nfft":
        assert prep.collectives["all_to_all"] == 2 * 2
        assert prep.elision["all_to_all"] == 1


def test_overlap_oversend_violation_is_caught(mesh):
    plan = plan_conv((4, 4, 20, 20), (4, 4, 3, 3), padding=1,
                     schedule="nfft", mesh=mesh, overlap="slab:2")
    with seeded_violation("overlap-oversend"):
        report = _analyze(plan).check()
    assert not report.ok
    assert any(v.invariant == "overlap-bytes-parity"
               for v in report.violations)
    with pytest.raises(AssertionError, match="plan-lint"):
        report.raise_if_failed()
    # the same seed leaves sequential plans untouched
    seq = plan_conv((4, 4, 20, 20), (4, 4, 3, 3), padding=1,
                    schedule="nfft", mesh=mesh, overlap="off")
    with seeded_violation("overlap-oversend"):
        assert _analyze(seq).check().ok


def test_sequential_plans_have_no_overlap_delta(mesh):
    p = _analyze(plan_conv((4, 4, 20, 20), (4, 4, 3, 3), padding=1,
                           schedule="nfft", mesh=mesh, overlap="off"))
    assert p.num_slabs == 1 and p.overlap_delta is None


# --------------------------------------------------------------------------
# The port's own: fake tensors leave nothing behind
# --------------------------------------------------------------------------

def _wrapper_cases():
    n, d = 5, 16
    P = kdft.ops.num_freq_real(d)
    dh = d // 2 + 1
    return {
        "cgemm_cuda": (kcgemm.cgemm_cuda, kcgemm.cgemm_ref,
                       [(3, 7, 4), (3, 7, 4), (3, 4, 6), (3, 4, 6)], {}),
        "tile_rfft_cuda": (kdft.tile_rfft_cuda, kdft.tile_rfft_ref,
                           [(n, d, d)], {"delta": d}),
        "tile_irfft_cuda": (kdft.tile_irfft_cuda, kdft.tile_irfft_ref,
                            [(n, P), (n, P)], {"delta": d}),
        "tile_irfft_epilogue_cuda": (
            kdft.tile_irfft_epilogue_cuda, kdft.tile_irfft_epilogue_ref,
            [(n, P), (n, P), (n,)], {"delta": d, "activation": "relu"}),
        "tile_fft_cuda": (kdft.tile_fft_cuda, kdft.tile_fft_ref,
                          [(n, d, d)], {"delta": d}),
        "tile_ifft_cuda": (kdft.tile_ifft_cuda, kdft.tile_ifft_ref,
                           [(n, d, dh), (n, d, dh)], {"delta": d}),
        "tile_ifft_epilogue_cuda": (
            kdft.tile_ifft_epilogue_cuda, kdft.tile_ifft_epilogue_ref,
            [(n, d, dh), (n, d, dh), (n,)], {"delta": d,
                                             "activation": "relu"}),
    }


def _counters(fn):
    return {k: (dict(v) if isinstance(v, dict) else v)
            for k, v in vars(fn).items()
            if k in ("launches", "variant_launches", "form_launches",
                     "tiles_launches")}


def _shapes(out):
    out = out if isinstance(out, tuple) else (out,)
    return [(tuple(t.shape), t.dtype) for t in out]


@pytest.mark.parametrize("name", sorted(_wrapper_cases()))
def test_wrapper_fake_branch(name):
    """On fake CUDA tensors each of the seven wrappers checks its contract
    and returns the plain version's shapes and dtypes, launching nothing
    and counting nothing."""
    wrapper, plain, shapes, kw = _wrapper_cases()[name]
    args = [_rand(s, i) for i, s in enumerate(shapes)]
    if name == "cgemm_cuda":
        kw = {"three_m": True}
    want = _shapes(plain(*args, **kw))
    before = _counters(wrapper)
    with FakeTensorMode():
        fakes = [torch.empty(s, device="cuda") for s in shapes]
        out = wrapper(*fakes, **kw)
        assert all(isinstance(t, FakeTensor) and t.device.type == "cuda"
                   for t in (out if isinstance(out, tuple) else (out,)))
        assert _shapes(out) == want
        with pytest.raises((ValueError, TypeError)):
            wrapper(*[f.double() for f in fakes], **kw)   # contract held
    assert _counters(wrapper) == before


def test_analysis_touches_neither_cache(mesh):
    """``analyze(plan, prepared=True)`` prepares on a fake kernel with the
    pipeline's own ``prepare``: the prepared cache and the plan cache keep
    their sizes."""
    plans = [_plan(None, "fft-cuda", "local"),
             _plan(mesh, "fft-torch", "nfft", overlap="off")]
    before = (prepared_cache_info(), plan_cache_info().size)
    for plan in plans:
        _analyze(plan, prepared=True).check().raise_if_failed()
    assert (prepared_cache_info(), plan_cache_info().size) == before


def test_batch_64_layer_analyzes_without_a_real_operand(monkeypatch):
    """Table I's Vconv1.1 at batch 64 (a real run would allocate
    gigabytes): the plain CGEMM of ``fft-torch`` sees fake operands
    only."""
    seen = []
    orig = stages.cgemm

    def recording(*operands, **kw):
        seen.extend(operands)
        return orig(*operands, **kw)

    monkeypatch.setattr(stages, "cgemm", recording)
    plan = plan_conv((64, 3, 224, 224), (64, 3, 3, 3), padding=1,
                     backend="fft-torch")
    p = _analyze(plan)
    p.check().raise_if_failed()
    assert p.peak_live_bytes > 2 ** 30          # what a real run would hold
    assert len(seen) == 4 and all(isinstance(t, FakeTensor) for t in seen)


_HAZARD = r"""
import sys
import numpy as np
import torch
from torch.utils._pytree import tree_flatten
from torch._subclasses.fake_tensor import FakeTensor
from repro_torch.conv import analyze, plan_conv
from repro_torch.core import dft
from repro_torch.kernels.cgemm import ops as cops
from repro_torch.kernels.dft_tile import ops as dops
from repro_torch.launch import mesh as M

analyze_first = sys.argv[2] == "1"
M.start_process_group("gloo")
mesh = M.make_host_mesh(1, 1)
rng = np.random.default_rng(0)
x = torch.from_numpy(rng.standard_normal((2, 3, 18, 18)).astype(np.float32))
k = torch.from_numpy(rng.standard_normal((4, 3, 3, 3)).astype(np.float32))
plans = [plan_conv(x.shape, k.shape, padding=1, backend=b, schedule=s,
                   mesh=mesh if s != "local" else None)
         for b in ("fft-torch", "fft-cuda") for s in ("local", "nfft")]
if analyze_first:
    for p in plans:
        analyze(p).check().raise_if_failed()
        analyze(p, prepared=True).check().raise_if_failed()
out = {}
for i, p in enumerate(plans):
    y = p(x, k)
    y = y.full_tensor() if p.mesh is not None else y
    assert type(y) is torch.Tensor, type(y)
    out[str(i)] = y.numpy()
caches = [dft._dft_mats_np, dft._dft_mats_on, dft._compact_layout_np,
          dft._compact_layout_on, dops._form, dops._inverse_form,
          dops.forward_tables, dops.inverse_tables, dops._lib,
          dops._forward_consts, dops._inverse_consts, cops._lib]
leaves = [v for c in caches for v in tree_flatten(list(c.cache.values()))[0]]
assert not any(isinstance(v, FakeTensor) for v in leaves)
assert sum(isinstance(v, torch.Tensor) for v in leaves) > 0
np.savez(sys.argv[1], **out)
M.destroy_process_group()
"""


def test_real_forward_after_an_analysis_is_real(tmp_path):
    """In a fresh process, analyze ``fft-torch`` and ``fft-cuda`` plans
    (local and on a (1, 1) gloo mesh, one-shot and prepared) before their
    first real forward: every forward returns a plain tensor, equal to
    0.0 to that of a process that never analyzed, and no constant cache
    holds a fake tensor."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    procs = {flag: subprocess.Popen(
        [sys.executable, "-c", _HAZARD, str(tmp_path / f"y{flag}.npz"),
         flag], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for flag in ("0", "1")}
    for flag, proc in procs.items():
        _, err = proc.communicate(timeout=240)
        assert proc.returncode == 0, err[-3000:]
    a, b = np.load(tmp_path / "y0.npz"), np.load(tmp_path / "y1.npz")
    assert sorted(a.files) == sorted(b.files) == ["0", "1", "2", "3"]
    for key in a.files:
        assert np.abs(a[key] - b[key]).max() == 0.0
