"""repro_torch.launch.batcher's ``ServeEngine`` over a mesh (the sharded
schedules behind the serving engine), on the CPU.

(a) In process, on a one-rank gloo group and a (1, 1) mesh, against the
    JAX engine on ``make_mesh((1, 1), ("data", "model"))`` (backend
    ``fft-xla``): the port on ``fft-torch`` and ``fft-cuda`` (its kernels'
    plain versions), ``nfft`` and ``wfft``, overlap ``off`` and
    ``slab:2``, a bias+ReLU trunk with weights carried over by
    ``repro_torch.convert``, under one fake clock on the same numpy
    inputs.  The engines form the same batches and placements (as
    ``tests/test_torch_batcher.py`` holds the local engines); every result
    is a plain tensor within 1e-4 of the largest |y| of the reference's;
    zero plan-cache misses after warm-up; the gather of each forward's
    output counts as one ``output_gather``; ``update_weights`` re-prepares
    on the mesh; ``bucket_report`` gives the reference's dedupe.
(b) Two spawned gloo ranks over a ``FileStore``, at meshes (1, 2) and
    (2, 1), every scenario in one spawn per mesh: each rank runs its own
    fake clock, rank 1's running three times as fast, so that alone it
    would flush other batches inside the window.  Both ranks form rank 0's batches (those of a local
    engine on rank 0's clock); results are equal on both ranks and within
    1e-5 of the largest |y| of a local engine's; ``replicas=2``
    round-robins alike on both ranks; a divergent submit on one rank (one
    request more, or other rows) raises the same ``RuntimeError`` on both
    and hangs neither.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

import jax.numpy as jnp

import repro.conv as jconv
from repro.compat import make_mesh as jmake_mesh
from repro.launch import batcher as jbatcher
from repro_torch.conv import Epilogue, NetworkConv, stages
from repro_torch.convert import params_from_jax
from repro_torch.launch import mesh as tmesh
from repro_torch.launch.batcher import (
    BucketPolicy, ServeEngine, synthetic_trace)

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
RESULT_TOL = 1e-4          # against JAX, scaled by max|y|
RANK_TOL = 1e-5            # against a local engine of the port, scaled
CONFIGS = [("nfft", "off"), ("nfft", "slab:2"), ("wfft", "off"),
           ("wfft", "slab:2")]
EP = Epilogue(bias=True, activation="relu")


def _np(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _layers(batch):
    return [NetworkConv("s1", (batch, 2, 8, 8), (4, 2, 3, 3), padding=1,
                        epilogue=EP),
            NetworkConv("s2", (batch, 4, 8, 8), (6, 4, 3, 3), padding=1,
                        epilogue=EP)]


def _jax_layers(batch):
    ep = jconv.Epilogue(bias=True, activation="relu")
    return [jconv.NetworkConv(l.name, l.x_shape, l.k_shape,
                              padding=l.padding, epilogue=ep)
            for l in _layers(batch)]


KERNELS = {"s1": _np((4, 2, 3, 3), 1), "s2": _np((6, 4, 3, 3), 2)}
BIASES = {"s1": _np((4,), 3), "s2": _np((6,), 4)}


def _forward(biases):
    def forward(prepared, x):
        for name in prepared:
            x = prepared[name](x, bias=biases[name])
        return x
    return forward


class FakeClock:
    """A clock that reads ``rate`` seconds for each second of ``t``."""

    def __init__(self, rate=1.0):
        self.t, self.rate = 0.0, rate

    def __call__(self):
        return self.t * self.rate


TRACE = synthetic_trace(n_requests=14, max_batch=4, rate_rps=4.0, seed=5)
INPUTS = [_np((tr.batch, 2, 8, 8), 100 + i) for i, tr in enumerate(TRACE)]
UPDATE_SCALE = 1.5
WINDOW = 0.2               # batching window, s of the fake clocks


def _serve(eng, clock, to_input):
    """Replay the trace through ``eng``: a drain halfway between two
    arrivals (a poll with nothing new, where only the window can flush),
    and at each arrival a submit and a drain; then flush.  Returns
    ``eng``."""
    last = 0.0
    for tr, x in zip(TRACE, INPUTS):
        clock.t = (last + tr.t) / 2
        eng.drain()
        clock.t = last = tr.t
        eng.submit(to_input(x))
        eng.drain()
    eng.drain(force=True)
    return eng


# --------------------------------------------------------------------------
# (a) In process: one rank, mesh (1, 1), against the JAX engine
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mesh():
    """A (1, 1) mesh on a one-rank gloo group, for the whole module."""
    tmesh.start_process_group("gloo")
    try:
        yield tmesh.make_host_mesh(1, 1)
    finally:
        tmesh.destroy_process_group()


@pytest.fixture(scope="module")
def jax_engines():
    """The JAX engine for each (schedule, overlap), served once: its
    report, results, placements, bucket report and the post-update
    result."""
    jmesh = jmake_mesh((1, 1), ("data", "model"))
    biases = {n: jnp.asarray(b) for n, b in BIASES.items()}
    out = {}
    for schedule, overlap in CONFIGS:
        clock = FakeClock()
        eng = jbatcher.ServeEngine(
            _jax_layers, {n: jnp.asarray(k) for n, k in KERNELS.items()},
            policy=BucketPolicy(max_batch=4), window_s=WINDOW, clock=clock,
            forward=_forward(biases), backend="fft-xla", mesh=jmesh,
            schedule=schedule, overlap=overlap)
        _serve(eng, clock, jnp.asarray)
        rep = eng.report()
        results = {rid: np.asarray(y) for rid, y in eng.results.items()}
        eng.update_weights({n: jnp.asarray(k * UPDATE_SCALE)
                            for n, k in KERNELS.items()},
                           weights_version=1)
        rid = eng.submit(jnp.asarray(INPUTS[0]))
        eng.drain(force=True)
        out[(schedule, overlap)] = dict(
            report=rep, results=results,
            updated=np.asarray(eng.results[rid]),
            bucket_report=eng.bucket_report())
    return out


def _placements_of(report):
    keys = ("n_requests", "n_batches", "occupancy")
    return {label: {k: b[k] for k in keys}
            for label, b in report["buckets"].items()}


def _scaled(y, ref):
    y, ref = np.asarray(y, np.float64), np.asarray(ref, np.float64)
    return np.abs(y - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("backend", ["fft-torch", "fft-cuda"])
@pytest.mark.parametrize("schedule,overlap", CONFIGS,
                         ids=[f"{s}-{o}" for s, o in CONFIGS])
def test_engine_on_a_mesh_serves_what_jax_serves(mesh, jax_engines, backend,
                                                 schedule, overlap):
    ref = jax_engines[(schedule, overlap)]
    kernels, biases = params_from_jax(KERNELS, BIASES, device="cpu")
    clock = FakeClock()
    with stages.stage_trace() as trace:
        eng = ServeEngine(_layers, kernels, policy=BucketPolicy(max_batch=4),
                          window_s=WINDOW, clock=clock,
                          forward=_forward(biases), backend=backend,
                          device="cpu", mesh=mesh, schedule=schedule,
                          overlap=overlap)
    # the warm-up runs one forward a bucket, each gathered once
    n_buckets = len(eng.policy.batch_buckets())
    assert trace[("collective", "output_gather")] == n_buckets
    with stages.stage_trace() as trace:
        _serve(eng, clock, torch.from_numpy)
    rep = eng.report()
    n_batches = sum(b["n_batches"] for b in rep["buckets"].values())
    assert trace[("collective", "output_gather")] == n_batches
    assert _placements_of(rep) == _placements_of(ref["report"])
    for k in ("n_requests", "replica_batches", "queue_depth_max",
              "plan_cache_misses_after_warmup"):
        assert rep[k] == ref["report"][k], k
    assert rep["plan_cache_misses_after_warmup"] == 0
    assert rep["mesh"] == {"data": 1, "model": 1}
    assert rep["rank_broadcasts"] >= n_batches + 1
    assert rep["executor"] == "eager"
    assert sorted(eng.results) == sorted(ref["results"])
    for rid, y in eng.results.items():
        assert type(y) is torch.Tensor
        assert _scaled(y.numpy(), ref["results"][rid]) <= RESULT_TOL

    new = {n: k * UPDATE_SCALE for n, k in kernels.items()}
    eng.update_weights(new, weights_version=1)
    rid = eng.submit(torch.from_numpy(INPUTS[0]))
    eng.drain(force=True)
    y = eng.results[rid]
    assert type(y) is torch.Tensor
    assert _scaled(y.numpy(), ref["updated"]) <= RESULT_TOL
    assert eng.report()["plan_cache_misses_after_warmup"] == 0

    ours, theirs = eng.bucket_report(), ref["bucket_report"]
    for k in ("n_buckets", "n_layer_plans", "n_distinct_plans",
              "dedupe_ratio"):
        assert ours[k] == theirs[k], k


def test_engine_refuses_a_mesh_of_another_device_type(mesh):
    with pytest.raises(ValueError, match="cannot serve on device"):
        ServeEngine(_layers, {}, policy=BucketPolicy(max_batch=1),
                    device="meta", mesh=mesh, backend="fft-torch")


def test_report_without_a_mesh_broadcasts_nothing():
    kernels, biases = params_from_jax(KERNELS, BIASES, device="cpu")
    eng = ServeEngine(_layers, kernels, policy=BucketPolicy(max_batch=2),
                      forward=_forward(biases), backend="fft-torch",
                      device="cpu")
    eng.submit(torch.from_numpy(INPUTS[0][:1]))
    eng.drain(force=True)
    rep = eng.report()
    assert (rep["mesh"], rep["rank_broadcasts"]) == (None, 0)


# --------------------------------------------------------------------------
# (b) Two spawned gloo ranks at meshes (1, 2) and (2, 1)
# --------------------------------------------------------------------------

_RANK = r'''
import json, os, sys
import numpy as np
import torch
sys.path.insert(0, os.environ["TESTS"])
import test_torch_batcher_mesh as T
from repro_torch.convert import params_from_jax
from repro_torch.launch import mesh as M
from repro_torch.launch.batcher import BucketPolicy, ServeEngine

rank = int(os.environ["RANK"])
shape = tuple(json.loads(os.environ["SHAPE"]))
M.start_process_group("gloo", rank=rank, world_size=2,
                      store_path=os.environ["STORE"])
mesh = M.make_host_mesh(*shape)
kernels, biases = params_from_jax(T.KERNELS, T.BIASES, device="cpu")
RATE = 3.0                      # rank 1's clock runs this much faster


def engine(clock, on_mesh=True, **kw):
    if on_mesh:
        kw = dict(dict(mesh=mesh, schedule="nfft"), **kw)
    return ServeEngine(T._layers, kernels, policy=BucketPolicy(max_batch=4),
                       window_s=T.WINDOW, clock=clock, forward=T._forward(biases),
                       backend="fft-cuda", device="cpu", **kw)


def served(eng):
    return dict(placements={str(r): list(p)
                            for r, p in sorted(eng.placements.items())},
                replica_batches=eng.report()["replica_batches"],
                rank_broadcasts=eng.report()["rank_broadcasts"],
                results={str(r): y.tolist()
                         for r, y in sorted(eng.results.items())},
                plain=all(type(y) is torch.Tensor
                          for y in eng.results.values()))


out = {}
# 1. skewed clocks: every rank takes rank 0's batches
clock = T.FakeClock(rate=RATE if rank else 1.0)
out["mesh"] = served(T._serve(engine(clock), clock, torch.from_numpy))
for who in (0, 1):              # local engines on each rank's clock
    clock = T.FakeClock(rate=RATE if who else 1.0)
    out[f"local{who}"] = served(T._serve(engine(clock, on_mesh=False),
                                         clock, torch.from_numpy))
# 2. replicas round-robin alike
clock = T.FakeClock(rate=RATE if rank else 1.0)
out["replicas"] = served(T._serve(engine(clock, replicas=2,
                                         schedule="wfft", overlap="slab:2"),
                                  clock, torch.from_numpy))
# 3. a divergent submit on rank 1: one request more, or other rows


def diverge(extra):
    eng = engine(T.FakeClock())
    x = torch.from_numpy(T.INPUTS[0])
    if rank == 1 and not extra:             # the same rid, other rows
        x = torch.zeros((x.shape[0] % 4 + 1,) + tuple(x.shape[1:]))
    eng.submit(x)
    if rank == 1 and extra:
        eng.submit(x)
    try:
        eng.drain(force=True)
        return None
    except RuntimeError as e:
        return str(e)


out["extra_request"] = diverge(True)
out["other_rows"] = diverge(False)
with open(os.path.join(os.environ["OUT"], f"out{rank}.json"), "w") as fh:
    json.dump(out, fh)
M.destroy_process_group()
'''

SHAPES = [(1, 2), (2, 1)]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Run every scenario once per mesh shape on two spawned gloo ranks,
    both shapes at once."""
    runs = {}
    for shape in SHAPES:
        tmp = tmp_path_factory.mktemp(f"serve_{shape[0]}x{shape[1]}")
        base = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                    TESTS=os.path.dirname(os.path.abspath(__file__)),
                    OUT=str(tmp), STORE=str(tmp / "store"),
                    SHAPE=json.dumps(shape), OMP_NUM_THREADS="1")
        runs[shape] = (tmp, [subprocess.Popen(
            [sys.executable, "-c", _RANK], env=dict(base, RANK=str(r)),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in (0, 1)])
    out = {}
    try:
        for shape, (tmp, procs) in runs.items():
            logs = [p.communicate(timeout=300)[0] for p in procs]
            failed = [log[-3000:] for p, log in zip(procs, logs)
                      if p.returncode]
            assert not failed, "\n\n".join(failed)
            out[shape] = [json.loads((tmp / f"out{r}.json").read_text())
                          for r in (0, 1)]
    finally:
        for _, procs in runs.values():
            for p in procs:
                p.kill()
    return out


@pytest.mark.parametrize("shape", SHAPES, ids=["1x2", "2x1"])
def test_ranks_form_rank_zeros_batches(two_ranks, shape):
    r0, r1 = two_ranks[shape]
    # the clocks matter: rank 1's alone flushes other batches
    assert r0["local0"]["placements"] != r0["local1"]["placements"]
    assert r0["mesh"]["placements"] == r1["mesh"]["placements"] \
        == r0["local0"]["placements"]
    assert r0["mesh"]["rank_broadcasts"] == r1["mesh"]["rank_broadcasts"]


@pytest.mark.parametrize("shape", SHAPES, ids=["1x2", "2x1"])
def test_ranks_hold_equal_plain_results(two_ranks, shape):
    r0, r1 = two_ranks[shape]
    assert r0["mesh"]["plain"] and r1["mesh"]["plain"]
    assert r0["mesh"]["results"] == r1["mesh"]["results"]
    local = r0["local0"]["results"]
    assert sorted(r0["mesh"]["results"]) == sorted(local)
    for rid, y in r0["mesh"]["results"].items():
        assert _scaled(y, local[rid]) <= RANK_TOL


@pytest.mark.parametrize("shape", SHAPES, ids=["1x2", "2x1"])
def test_replicas_round_robin_alike_on_every_rank(two_ranks, shape):
    r0, r1 = two_ranks[shape]
    a, b = r0["replicas"], r1["replicas"]
    assert a["placements"] == b["placements"]
    assert a["replica_batches"] == b["replica_batches"]
    assert abs(a["replica_batches"][0] - a["replica_batches"][1]) <= 1
    assert {p[1] for p in a["placements"].values()} == {0, 1}
    assert a["results"] == b["results"]
    local = r0["local0"]["results"]
    for rid, y in a["results"].items():
        assert _scaled(y, local[rid]) <= RANK_TOL


@pytest.mark.parametrize("shape", SHAPES, ids=["1x2", "2x1"])
@pytest.mark.parametrize("how", ["extra_request", "other_rows"])
def test_a_divergent_submit_raises_on_every_rank(two_ranks, shape, how):
    r0, r1 = two_ranks[shape]
    assert r0[how] is not None and r0[how] == r1[how]
    assert "diverged" in r0[how]
