"""The port's tuner over the sharded schedules (``nfft``/``wfft`` x
overlap, on a ``torch.distributed`` mesh), on the CPU.

(a) In process, on a one-rank gloo group and a (1, 1) mesh: twins of
    ``tests/test_autotune.py::test_tuned_parity_with_auto_for_every_pair``
    (every backend and schedule pair, seeded as the winner, plans to what
    ``backend="auto"`` computes); the candidate lists held against the JAX
    package's ``candidates`` on the same spec, on a (1, 1) mesh for both,
    with backend names mapped (``fft-xla`` -> ``fft-torch``,
    ``fft-pallas`` -> ``fft-cuda``); ``plan_network(mesh=,
    backend="tuned")`` and its ``tuning_report``.  Known differences in
    the candidate lists: the port's CGEMM tile rows in place of the
    reference's half- and double-sized blocks, and ``DFT_BT_ALT`` in place
    of the reference's ``bt`` 64.
(b) Two spawned gloo ranks over a ``FileStore`` at a (1, 2) mesh: the
    ranks' own times disagree, and every rank still crowns the same
    winner (the argmin of the slowest rank's times); a budget that runs
    out on one rank only stops both at the same candidate, or neither; a
    candidate refused on one rank is skipped on both; a measurement that
    fails on one rank raises on both; only rank 0 writes the cache file,
    and its cache answers for both."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

from repro.compat import make_mesh as jmake_mesh
from repro.conv import autotune as jautotune
import repro_torch.conv as tconv
from repro_torch.conv import (
    Epilogue, NetworkConv, TunedConfig, autotune, autotune_info,
    plan_network)
from repro_torch.core.fftconv import conv2d_direct
from repro_torch.launch import mesh as tmesh

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
X_SHAPE = (1, 4, 16, 16)
K_SHAPE = (8, 4, 3, 3)
NAMES = {"direct": "direct", "fft-xla": "fft-torch",
         "fft-pallas": "fft-cuda"}


def _rand(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _t(a):
    return torch.from_numpy(a)


@pytest.fixture(scope="module")
def mesh():
    """A (1, 1) mesh on a one-rank gloo group, for the whole module."""
    tmesh.start_process_group("gloo")
    try:
        yield tmesh.make_host_mesh(1, 1)
    finally:
        tmesh.destroy_process_group()


@pytest.fixture
def tune_env(tmp_path, monkeypatch):
    """Isolated tuning cache + small budget, measuring on the CPU."""
    path = tmp_path / "tune.json"
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(path))
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_BUDGET_MS", "400")
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_REPS", "1")
    monkeypatch.delenv("REPRO_TORCH_AUTOTUNE", raising=False)
    autotune.reset()
    tconv.clear_plan_cache()
    with autotune.measure_on("cpu"):
        yield path
    autotune.reset()
    tconv.clear_plan_cache()


# --------------------------------------------------------------------------
# (a) In process: one rank, mesh (1, 1)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("backend,schedule", [
    ("direct", "local"), ("fft-torch", "local"), ("fft-cuda", "local"),
    ("fft-torch", "nfft"), ("fft-torch", "wfft"),
    ("fft-cuda", "nfft"), ("fft-cuda", "wfft"),
])
def test_tuned_parity_with_auto_for_every_pair(mesh, tune_env, backend,
                                               schedule):
    """Whatever pair the tuner crowns, execution must match ``auto``'s
    numerics: seed the cache with each pair as the winner and compare,
    on the (1, 1) mesh for the sharded schedules."""
    on = mesh if schedule in ("nfft", "wfft") else None
    autotune.seed(X_SHAPE, K_SHAPE,
                  TunedConfig(backend, schedule, source="seeded"),
                  padding=(1, 1), mesh=on)
    plan = tconv.plan_conv(X_SHAPE, K_SHAPE, padding=1, backend="tuned",
                           mesh=on)
    assert (plan.backend, plan.schedule) == (backend, schedule)
    assert autotune_info().hits == 1
    auto = tconv.plan_conv(X_SHAPE, K_SHAPE, padding=1, backend="auto",
                           mesh=on)
    x, k = _t(_rand(X_SHAPE)), _t(_rand(K_SHAPE, 1))
    y, y_auto = plan(x, k), auto(x, k)
    if on is not None:
        y, y_auto = y.full_tensor(), y_auto.full_tensor()
    np.testing.assert_allclose(y.numpy(), y_auto.numpy(), atol=2e-4)
    np.testing.assert_allclose(
        y.numpy(), conv2d_direct(x, k, padding=1).numpy(), atol=2e-4)


def _projection(cands, alt):
    """A candidate list with the packages' differences mapped out: the
    backend's name, ``dft_bt`` as None or "alt", and the tile as pinned
    or not."""
    return [(NAMES.get(c.backend, c.backend), c.schedule, c.spectrum,
             c.overlap, c.bm is not None,
             None if c.dft_bt is None else ("alt" if c.dft_bt == alt
                                            else c.dft_bt))
            for c in cands]


@pytest.mark.parametrize("request_", [
    dict(), dict(spectrum="real"), dict(overlap="auto"),
    dict(on_mesh=True), dict(on_mesh=True, overlap="auto"),
    dict(on_mesh=True, schedule="wfft", overlap="auto"),
    dict(on_mesh=True, spectrum="complex", overlap="auto"),
], ids=["local", "local-real", "local-overlap-auto", "mesh",
        "mesh-overlap-auto", "mesh-wfft", "mesh-complex"])
def test_candidates_match_the_reference(mesh, tune_env, request_):
    """The port's tuning space is the reference's on the same spec and
    request, on a (1, 1) mesh for both packages: the same unpinned
    candidates in the same order (cost-model pick first, the CUDA kernels'
    backend last), and the same kinds of pinned-tile candidate.  The tile
    rows themselves differ (the port's compiled table against the
    reference's half- and double-sized blocks), and so does the
    alternative ``dft_bt`` (``DFT_BT_ALT`` against 64)."""
    kw = dict(request_)
    on_mesh = kw.pop("on_mesh", False)
    spec = autotune._make_spec(X_SHAPE, K_SHAPE, (1, 1), 16)
    jspec = jautotune._make_spec(X_SHAPE, K_SHAPE, (1, 1), 16)
    ours = autotune.candidates(spec, mesh=mesh if on_mesh else None, **kw)
    theirs = jautotune.candidates(
        jspec, mesh=jmake_mesh((1, 1), ("data", "model")) if on_mesh
        else None, **kw)
    p_ours = _projection(ours, autotune.DFT_BT_ALT)
    p_theirs = _projection(theirs, 64)
    assert [p for p in p_ours if not p[4]] \
        == [p for p in p_theirs if not p[4]]
    assert set(p_ours) == set(p_theirs)


def test_the_mesh_keys_the_cache(mesh, tune_env):
    """A winner tuned on a mesh answers for the same mesh (another
    ``DeviceMesh`` object of the same value included) and never for a
    local plan of the same geometry."""
    autotune.seed(X_SHAPE, K_SHAPE,
                  TunedConfig("fft-torch", "wfft", source="seeded"),
                  padding=(1, 1), mesh=mesh)
    same = tmesh.make_host_mesh(1, 1)
    assert autotune.lookup(X_SHAPE, K_SHAPE, padding=(1, 1),
                           mesh=same).schedule == "wfft"
    assert autotune.lookup(X_SHAPE, K_SHAPE, padding=(1, 1)) is None
    assert autotune.lookup(X_SHAPE, K_SHAPE, padding=(1, 1), mesh=mesh,
                           replicate_kernel_transform=True) is None


def test_disabled_falls_back_to_the_cost_model_on_a_mesh(mesh, tune_env,
                                                         monkeypatch,
                                                         tmp_path):
    """Measurement off: the cost model's sharded pick, fft-torch on nfft
    with no overlap, as the reference's tuner falls back on a (1, 1) mesh
    (fft-xla on nfft), and the plan ``backend="auto"`` makes there."""
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE", "0")
    monkeypatch.setenv("REPRO_AUTOTUNE", "0")
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "jax.json"))
    jautotune.reset()
    w = autotune.tune(X_SHAPE, K_SHAPE, padding=1, mesh=mesh,
                      overlap="auto")
    jw = jautotune.tune(X_SHAPE, K_SHAPE, padding=1, overlap="auto",
                        mesh=jmake_mesh((1, 1), ("data", "model")))
    jautotune.reset()
    assert (w.backend, w.schedule, w.overlap, w.source) \
        == ("fft-torch", "nfft", "off", "cost-model")
    assert (NAMES[jw.backend], jw.schedule, jw.overlap, jw.source) \
        == (w.backend, w.schedule, w.overlap, w.source)
    plan = tconv.plan_conv(X_SHAPE, K_SHAPE, padding=1, backend="tuned",
                           mesh=mesh, overlap="auto")
    assert (plan.backend, plan.schedule, plan.overlap) \
        == ("fft-torch", "nfft", "off")


def test_tuned_network_on_a_mesh_and_its_report(mesh, tune_env):
    """``plan_network(mesh=, backend="tuned", overlap="auto")`` tunes each
    geometry once over the sharded schedules, and ``tuning_report`` finds
    each layer's winner under the mesh's key and reports the plan's own
    overlap; a seeded ``slab:2`` winner is reported as ``slab:2``."""
    ep = Epilogue(bias=True, activation="relu")
    layers = [NetworkConv("c1", (4, 3, 12, 12), (4, 3, 3, 3), padding=1,
                          epilogue=ep),
              NetworkConv("c2", (4, 4, 12, 12), (6, 4, 3, 3), padding=1,
                          epilogue=ep)]
    autotune.seed((4, 4, 12, 12), (6, 4, 3, 3),
                  TunedConfig("fft-cuda", "wfft", overlap="slab:2",
                              source="seeded"),
                  padding=(1, 1), mesh=mesh, overlap="auto")
    net = plan_network(layers, mesh=mesh, backend="tuned", overlap="auto")
    assert autotune_info().misses == 1 and autotune_info().hits == 1
    rep = net.tuning_report()
    c1, c2 = net["c1"], net["c2"]
    assert c1.schedule in ("nfft", "wfft") and c1.mesh is mesh
    assert rep["c1"]["source"] == "measured"
    assert rep["c1"]["us_per_call"] > 0
    assert rep["c1"]["overlap"] == c1.overlap
    assert (c2.backend, c2.schedule, c2.overlap) \
        == ("fft-cuda", "wfft", "slab:2")
    assert (rep["c2"]["overlap"], rep["c2"]["source"]) \
        == ("slab:2", "seeded")
    # the report of a local net does not take the mesh's winners
    local = plan_network(layers, backend="fft-cuda")
    assert {r["source"] for r in local.tuning_report().values()} \
        == {"unmeasured"}


# --------------------------------------------------------------------------
# (b) Two spawned gloo ranks at a (1, 2) mesh
# --------------------------------------------------------------------------

_RANK = r'''
import json, os
import torch.distributed as dist
from repro_torch.conv import autotune, autotune_info
from repro_torch.launch import mesh as M

rank = int(os.environ["RANK"])
out_dir = os.environ["OUT"]
M.start_process_group("gloo", rank=rank, world_size=2,
                      store_path=os.environ["STORE"])
mesh = M.make_host_mesh(1, 2)
X, K = (2, 4, 12, 12), (4, 4, 3, 3)
# each rank its own file: rank 1's must never be written
os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = os.path.join(
    out_dir, f"cache{rank}.json")
real_measure, real_plan = autotune._measure_plan, autotune._candidate_plan
calls = []


def fake(times, fail_at=None):
    """Run the candidate for real (its collectives), then report this
    rank's own time for it, or fail."""
    def measure(plan, reps, device):
        real_measure(plan, 1, device)
        i = len(calls)
        calls.append(i)
        if i == fail_at:
            raise RuntimeError("kernel launch failed (test)")
        return float(times[i] if i < len(times) else 100 + i)
    return measure


def tune(**kw):
    calls.clear()
    with autotune.measure_on("cpu"):
        return autotune.tune(X, K, padding=1, mesh=mesh, reps=1, **kw)


def last():
    sw = autotune.sweeps()[-1]
    return dict(reached=sw["reached"], candidates=sw["candidates"],
                measured=[[c.backend, c.schedule, c.spectrum, c.overlap,
                           c.bm, c.us_per_call] for c in sw["measured"]])


out = {}
# 1. the ranks' own times disagree: rank 0 alone would crown candidate 1,
# rank 1 alone candidate 2; the slowest rank's times crown candidate 0
autotune._measure_plan = fake({0: [50, 10, 90], 1: [50, 90, 10]}[rank])
w = tune(budget=1e9)
dist.barrier()                  # rank 0 has written its file by now
out["disagree"] = dict(winner=w.to_json(), sweep=last(),
                       files=[os.path.exists(os.path.join(
                           out_dir, f"cache{r}.json")) for r in (0, 1)])
# 2. rank 0's cache answers for both ranks after a reset
autotune.reset()
autotune._measure_plan = fake([])
w2 = tune(budget=1e9)
out["hit"] = dict(winner=w2.to_json(), info=list(autotune_info()),
                  calls=len(calls))
# 3. a budget spent on one rank only: rank 0's decides for both
autotune._measure_plan = fake([1, 2, 3])
tune(spectrum="real", budget=0.0 if rank == 0 else 1e9)
out["rank0_spent"] = last()
tune(spectrum="complex", budget=1e9 if rank == 0 else 0.0)
out["rank1_spent"] = last()
# 4. a candidate refused on rank 1 only is skipped on both


def refuse(cand, *args, **kw):
    if rank == 1 and cand.spectrum == "complex" \
            and cand.backend == "fft-torch":
        raise ValueError("refused on rank 1 (test)")
    return real_plan(cand, *args, **kw)


autotune._candidate_plan = refuse
tune(overlap="auto", budget=1e9)
out["refused"] = last()
autotune._candidate_plan = real_plan
# 5. a measurement that fails on rank 1 raises on both ranks
autotune._measure_plan = fake([1, 2, 3], fail_at=1 if rank == 1 else None)
try:
    tune(schedule="nfft", budget=1e9)
    out["failed"] = None
except RuntimeError as e:
    out["failed"] = str(e)
with open(os.path.join(out_dir, f"out{rank}.json"), "w") as fh:
    json.dump(out, fh)
M.destroy_process_group()
'''


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Run the scenarios once on two spawned gloo ranks."""
    tmp = tmp_path_factory.mktemp("tune_ranks")
    base = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                OUT=str(tmp), STORE=str(tmp / "store"), OMP_NUM_THREADS="1")
    base.pop("REPRO_TORCH_AUTOTUNE", None)
    procs = [subprocess.Popen([sys.executable, "-c", _RANK],
                              env=dict(base, RANK=str(r)),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in (0, 1)]
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    failed = [log[-3000:] for p, log in zip(procs, logs) if p.returncode]
    assert not failed, "\n\n".join(failed)
    return [json.loads((tmp / f"out{r}.json").read_text()) for r in (0, 1)]


def test_ranks_agree_on_the_winner(two_ranks):
    r0, r1 = two_ranks
    assert r0["disagree"]["winner"] == r1["disagree"]["winner"]
    assert r0["disagree"]["sweep"] == r1["disagree"]["sweep"]
    w = r0["disagree"]["winner"]
    first = r0["disagree"]["sweep"]["measured"][0]
    # candidate 0 at the slower rank's 50 us, not either rank's own pick
    assert w["us_per_call"] == 50.0 and first[-1] == 50.0
    assert [w["backend"], w["schedule"], w["spectrum"], w["overlap"],
            w["bm"]] == first[:5]
    assert [m[-1] for m in r0["disagree"]["sweep"]["measured"][:3]] \
        == [50.0, 90.0, 90.0]


def test_only_rank_0_writes_and_its_cache_answers(two_ranks):
    r0, r1 = two_ranks
    assert r0["disagree"]["files"] == r1["disagree"]["files"] \
        == [True, False]
    for r in (r0, r1):
        assert r["hit"]["winner"] == r0["disagree"]["winner"]
        assert r["hit"]["info"][:2] == [1, 0] and r["hit"]["calls"] == 0


def test_a_budget_spent_on_one_rank_stops_both_alike(two_ranks):
    r0, r1 = two_ranks
    assert r0["rank0_spent"] == r1["rank0_spent"]
    assert r0["rank0_spent"]["reached"] == 1
    assert len(r0["rank0_spent"]["measured"]) == 1
    assert r0["rank1_spent"] == r1["rank1_spent"]
    assert r0["rank1_spent"]["reached"] == r0["rank1_spent"]["candidates"]


def test_a_refusal_on_one_rank_skips_the_candidate_on_both(two_ranks):
    r0, r1 = two_ranks
    assert r0["refused"] == r1["refused"]
    sweep = r0["refused"]
    assert not any(m[0] == "fft-torch" and m[2] == "complex"
                   for m in sweep["measured"])
    assert len(sweep["measured"]) == sweep["candidates"] - 6


def test_a_failure_on_one_rank_raises_on_both(two_ranks):
    r0, r1 = two_ranks
    assert r1["failed"] == "kernel launch failed (test)"
    assert "failed on another rank" in r0["failed"]
