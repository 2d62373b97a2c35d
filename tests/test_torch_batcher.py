"""repro_torch.launch.batcher, the continuous-batching serve engine, held
to repro.launch.batcher on the CPU.

One twin of each test of tests/test_batcher.py, against the port (backend
``fft-cuda`` on ``device="cpu"``, which runs the kernels' plain versions),
with the JAX tests' small net: two layers at 8x8, 2 and 4 channels.  Then
parity with the JAX package on the same numpy inputs: the same synthetic
trace for the same arguments; a JAX engine (``fft-xla``) and a port engine
under one fake clock form the same batches (per-bucket requests, batches
and occupancy equal) and each request's result agrees within 1e-4 of the
largest |y| (same algorithm, float32, as tests/test_torch_plan.py); and
``plan_network(..., buckets=)`` gives the same dedupe report.  Last, the
parts that are the port's own: the ``serve --serve-trace`` entry point on
the CPU, what is not ported yet, and the CUDA-graph accounting that reads
empty on the host (the graphs themselves run in tests/test_torch_cuda.py).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

import jax.numpy as jnp

import repro.conv as jconv
from repro.launch import batcher as jbatcher
from repro_torch.conv import (
    BucketedNetworkPlan, NetworkConv, clear_plan_cache,
    clear_prepared_cache, plan_cache_info, plan_network,
    prepared_cache_info,
)
from repro_torch.launch import batcher, serve
from repro_torch.launch.batcher import (
    BucketPolicy, RequestTooLarge, ServeEngine, TraceRequest, _percentile,
    run_trace, synthetic_trace,
)

RESULT_TOL = 1e-4          # scaled by max|y|, as tests/test_torch_plan.py


def _np(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _rand(shape, seed=0):
    return torch.from_numpy(_np(shape, seed))


def _layers(batch, image=8):
    return [
        NetworkConv("s1", (batch, 2, image, image), (4, 2, 3, 3),
                    padding=1),
        NetworkConv("s2", (batch, 4, image, image), (4, 4, 3, 3),
                    padding=1),
    ]


def _params():
    return {"s1": _rand((4, 2, 3, 3), 1), "s2": _rand((4, 4, 3, 3), 2)}


def _engine(**kw):
    kw.setdefault("policy", BucketPolicy(max_batch=4))
    kw.setdefault("backend", "fft-cuda")
    kw.setdefault("device", "cpu")
    return ServeEngine(_layers, _params(), **kw)


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


# --------------------------------------------------------------------------
# Bucket policy
# --------------------------------------------------------------------------

def test_batch_buckets_powers_of_two_max_included():
    assert BucketPolicy(max_batch=8).batch_buckets() == (1, 2, 4, 8)
    # non-power max is still its own bucket
    assert BucketPolicy(max_batch=6).batch_buckets() == (1, 2, 4, 6)
    assert BucketPolicy(max_batch=1).batch_buckets() == (1,)
    assert BucketPolicy(max_batch=8, min_batch=2).batch_buckets() == \
        (2, 4, 8)


def test_bucket_for_rounds_up():
    p = BucketPolicy(max_batch=8)
    assert [p.bucket_for(n) for n in (1, 2, 3, 5, 8)] == [1, 2, 4, 8, 8]


def test_bucket_for_rejects_oversize_with_clear_error():
    p = BucketPolicy(max_batch=4)
    with pytest.raises(RequestTooLarge, match="max_batch=4"):
        p.bucket_for(5)
    with pytest.raises(ValueError, match=">= 1"):
        p.bucket_for(0)


def test_bucket_policy_validates_bounds_and_image_sizes():
    with pytest.raises(ValueError):
        BucketPolicy(max_batch=0)
    with pytest.raises(ValueError):
        BucketPolicy(max_batch=2, min_batch=4)
    p = BucketPolicy(max_batch=4, image_sizes=(8, 16))
    assert p.bucket_for(2, image=8) == 2
    with pytest.raises(RequestTooLarge, match="image size"):
        p.bucket_for(2, image=32)


def test_percentile_nearest_rank():
    vals = [float(i) for i in range(1, 101)]
    assert _percentile(vals, 50) == pytest.approx(50.0, abs=1.0)
    assert _percentile(vals, 99) == pytest.approx(99.0, abs=1.0)
    assert _percentile([7.0], 99) == 7.0
    assert np.isnan(_percentile([], 50))
    # one percentile for the package: serve's is the batcher's
    assert serve._percentile is batcher._percentile


# --------------------------------------------------------------------------
# Engine edge cases
# --------------------------------------------------------------------------

def test_submit_oversize_rejected_and_counted():
    eng = _engine()
    with pytest.raises(RequestTooLarge):
        eng.submit(torch.zeros((5, 2, 8, 8)))
    rep = eng.report()
    assert rep["n_rejected"] == 1 and rep["n_requests"] == 0


def test_drain_empty_queue_is_noop():
    eng = _engine()
    assert eng.drain() == 0
    assert eng.drain(force=True) == 0
    assert eng.queue_depth == 0


def test_window_holds_partial_batch_until_timeout():
    clock = FakeClock()
    eng = _engine(window_s=1.0, clock=clock)
    eng.submit(_rand((1, 2, 8, 8)))
    assert eng.drain() == 0 and eng.queue_depth == 1   # window open
    clock.t = 0.5
    assert eng.drain() == 0                            # still open
    clock.t = 1.5
    assert eng.drain() == 1 and eng.queue_depth == 0   # timed out: flush


def test_full_bucket_launches_inside_window():
    clock = FakeClock()
    eng = _engine(window_s=60.0, clock=clock)
    for i in range(4):
        eng.submit(_rand((1, 2, 8, 8), seed=i))
    assert eng.drain() == 1                 # max_batch rows: no waiting
    assert eng.report()["buckets"]["b4"]["occupancy"] == 1.0


def test_force_drain_flushes_open_window():
    clock = FakeClock()
    eng = _engine(window_s=60.0, clock=clock)
    eng.submit(_rand((3, 2, 8, 8)))
    assert eng.drain() == 0
    assert eng.drain(force=True) == 1       # end-of-trace flush
    assert "b4" in eng.report()["buckets"]  # 3 rows pad to bucket 4


def test_pad_to_bucket_parity_with_unpadded_execution():
    """A padded+sliced bucketed result must equal running the request
    through a network planned for its exact (unpadded) shape."""
    eng = _engine()
    x = _rand((3, 2, 8, 8), seed=7)
    rid = eng.submit(x)
    eng.drain(force=True)                   # 3 rows -> bucket 4 (padded)
    y = eng.results[rid]
    assert y.shape[0] == 3
    assert eng.placements[rid] == ("b4", 0, 0)

    net = plan_network(_layers(3), backend="fft-cuda")
    prepared = net.prepare(_params(), weights_version=0)
    h = x
    for name in net.layer_names:
        h = prepared[name](h)
    np.testing.assert_allclose(y.numpy(), h.detach().numpy(),
                               rtol=1e-4, atol=1e-4)


def test_fifo_coalescing_packs_same_image_requests():
    eng = _engine()
    rids = [eng.submit(_rand((2, 2, 8, 8), seed=i)) for i in range(2)]
    assert eng.drain() == 1                 # 2+2 rows -> ONE b4 batch
    rep = eng.report()
    assert rep["buckets"]["b4"]["n_batches"] == 1
    assert rep["buckets"]["b4"]["n_requests"] == 2
    assert rep["occupancy"] == 1.0
    assert all(eng.results[r].shape[0] == 2 for r in rids)
    assert [eng.placements[r] for r in rids] == [("b4", 0, 0),
                                                 ("b4", 0, 2)]


def test_pad_max_baseline_never_coalesces():
    eng = _engine(mode="pad-max")
    for i in range(3):
        eng.submit(_rand((1, 2, 8, 8), seed=i))
    assert eng.drain(force=True) == 3       # one request per batch
    rep = eng.report()
    assert rep["buckets"]["b4"]["n_batches"] == 3
    assert rep["occupancy"] == pytest.approx(3 / 12)


def test_replan_baseline_pays_plan_misses_on_hot_path():
    clear_plan_cache()
    eng = _engine(mode="replan")
    for b in (1, 3, 1):
        eng.submit(_rand((b, 2, 8, 8), seed=b))
    eng.drain(force=True)
    rep = eng.report()
    # two distinct shapes planned on the hot path; the repeat hits
    assert rep["plan_cache_misses_after_warmup"] > 0


def test_bucketed_zero_plan_misses_after_warmup():
    eng = _engine()
    trace = synthetic_trace(n_requests=12, max_batch=4, rate_rps=1.0,
                            seed=0)
    rep = run_trace(eng, trace, realtime=False,
                    make_input=lambda b, img: _rand((b, 2, 8, 8), b))
    assert rep["plan_cache_misses_after_warmup"] == 0
    assert rep["n_requests"] == 12


def test_replica_round_robin_fairness():
    eng = _engine(policy=BucketPolicy(max_batch=2), replicas=2)
    for i in range(8):
        eng.submit(_rand((2, 2, 8, 8), seed=i))
    eng.drain(force=True)
    rep = eng.report()
    assert rep["replica_batches"] == [4, 4]
    assert rep["n_requests"] == 8


def test_prepared_cache_dedupe_across_engine_builds():
    """A second engine over the same params/policy re-plans and
    re-prepares entirely out of the shared caches: zero new plan misses,
    one prepared-cache hit per (bucket, layer)."""
    clear_plan_cache()
    clear_prepared_cache()
    params = _params()
    policy = BucketPolicy(max_batch=4)
    ServeEngine(_layers, params, policy=policy, backend="fft-cuda",
                device="cpu")
    plan_misses = plan_cache_info().misses
    hits_before = prepared_cache_info().hits

    eng2 = ServeEngine(_layers, params, policy=policy, backend="fft-cuda",
                       device="cpu")
    assert plan_cache_info().misses == plan_misses
    n_buckets = len(policy.batch_buckets())
    assert prepared_cache_info().hits >= hits_before + 2 * n_buckets
    assert eng2.report()["plan_cache_misses_after_warmup"] == 0


def test_update_weights_invalidates_once_per_bucket():
    eng = _engine(policy=BucketPolicy(max_batch=2))
    x = _rand((1, 2, 8, 8), seed=3)
    rid = eng.submit(x)
    eng.drain(force=True)
    y_old = eng.results[rid].numpy()

    new = {k: v * 2.0 for k, v in _params().items()}
    eng.update_weights(new, weights_version=1)
    rid2 = eng.submit(x)
    eng.drain(force=True)
    y_new = eng.results[rid2].numpy()
    assert not np.allclose(y_old, y_new)    # new weights took effect
    assert eng.report()["plan_cache_misses_after_warmup"] == 0


# --------------------------------------------------------------------------
# Trace + bench rows
# --------------------------------------------------------------------------

def test_synthetic_trace_is_deterministic_and_in_range():
    a = synthetic_trace(n_requests=16, max_batch=8, rate_rps=5.0, seed=3)
    b = synthetic_trace(n_requests=16, max_batch=8, rate_rps=5.0, seed=3)
    assert a == b and len(a) == 16
    assert all(1 <= tr.batch <= 8 for tr in a)
    assert all(a[i].t < a[i + 1].t for i in range(len(a) - 1))
    c = synthetic_trace(n_requests=16, max_batch=8, rate_rps=5.0, seed=4)
    assert c != a


def test_realtime_trace_replay_sleeps_to_offsets():
    eng = _engine(policy=BucketPolicy(max_batch=2))
    slept = []
    trace = (TraceRequest(t=0.05, batch=1), TraceRequest(t=0.10, batch=2))
    rep = run_trace(eng, trace, realtime=True, sleep=slept.append,
                    make_input=lambda b, img: _rand((b, 2, 8, 8), b))
    assert rep["n_requests"] == 2
    assert len(slept) >= 1 and all(dt > 0 for dt in slept)


def test_bench_rows_schema_valid_with_percentiles():
    from benchmarks.bench_schema import normalize
    eng = _engine()
    trace = synthetic_trace(n_requests=8, max_batch=4, rate_rps=1.0,
                            seed=1)
    run_trace(eng, trace, realtime=False,
              make_input=lambda b, img: _rand((b, 2, 8, 8), b))
    rows = normalize(eng.bench_rows())
    labels = {n.split("/")[1] for n in rows}
    assert labels <= {"b1", "b2", "b4"} and rows
    for name, entry in rows.items():
        metric = name.split("/")[2]
        assert metric in ("p50", "p99", "occupancy")
        if metric != "occupancy":
            assert entry["percentiles"]["p99"] >= \
                entry["percentiles"]["p50"]
        assert entry["config"]["mode"] == "bucketed"


# --------------------------------------------------------------------------
# netplan bucket helpers
# --------------------------------------------------------------------------

def test_plan_network_buckets_dedupe_report():
    nets = plan_network(_layers, buckets=(1, 2, 4), backend="fft-cuda")
    assert isinstance(nets, BucketedNetworkPlan)
    assert tuple(nets) == (1, 2, 4)
    rep = nets.report()
    assert rep["n_buckets"] == 3
    assert rep["n_layer_plans"] == 6
    # distinct batch -> distinct plans; within a bucket s2's geometry is
    # unique too, so no cross-bucket dedupe in this net
    assert rep["n_distinct_plans"] == 6
    with pytest.raises(ValueError, match="duplicate"):
        plan_network(_layers, buckets=(2, 2), backend="fft-cuda")
    # a callable layer factory needs buckets=
    with pytest.raises(TypeError, match="buckets"):
        plan_network(_layers, backend="fft-cuda")


def test_bucket_shims_warn_but_work():
    from repro_torch.conv import (bucket_report, plan_network_buckets,
                                  prepare_network_buckets)
    with pytest.warns(DeprecationWarning, match="plan_network_buckets"):
        nets = plan_network_buckets(_layers, (1, 2), backend="fft-cuda")
    assert tuple(nets) == (1, 2)
    with pytest.warns(DeprecationWarning, match="bucket_report"):
        rep = bucket_report(nets)
    assert rep["n_buckets"] == 2
    with pytest.warns(DeprecationWarning, match="prepare_network_buckets"):
        prepared = prepare_network_buckets(nets, _params(),
                                           weights_version=0)
    assert tuple(prepared) == (1, 2)
    with pytest.warns(DeprecationWarning, match="prepare_all"):
        nets[1].prepare_all(_params(), weights_version=0)


# --------------------------------------------------------------------------
# Parity with repro.launch.batcher on the same numpy inputs
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(n_requests=16, max_batch=8, rate_rps=5.0, seed=3),
    dict(n_requests=64, max_batch=8, rate_rps=1.0, seed=0),
    dict(n_requests=9, max_batch=6, rate_rps=200.0, seed=11,
         image_sizes=(32, 64)),
], ids=["rate5", "serve-default", "images"])
def test_synthetic_trace_equals_jax(kw):
    ours = synthetic_trace(**kw)
    theirs = jbatcher.synthetic_trace(**kw)
    assert [(r.t, r.batch, r.image) for r in ours] == \
        [(r.t, r.batch, r.image) for r in theirs]


def _jax_layers(batch, image=8):
    return [jconv.NetworkConv(l.name, l.x_shape, l.k_shape,
                              padding=l.padding)
            for l in _layers(batch, image)]


@pytest.mark.parametrize("replicas", [1, 2])
def test_engine_forms_the_batches_jax_forms(replicas):
    """The same requests, the same clock steps: JAX's engine (fft-xla)
    and the port's (fft-cuda on the CPU) pack the same batches and give
    each request the same result."""
    params = {"s1": _np((4, 2, 3, 3), 1), "s2": _np((4, 4, 3, 3), 2)}
    trace = synthetic_trace(n_requests=14, max_batch=4, rate_rps=4.0,
                            seed=5)
    xs = [_np((tr.batch, 2, 8, 8), 100 + i) for i, tr in enumerate(trace)]
    engines = {}
    for side in ("jax", "torch"):
        clock = FakeClock()
        common = dict(policy=BucketPolicy(max_batch=4), window_s=0.5,
                      clock=clock, replicas=replicas)
        if side == "jax":
            eng = jbatcher.ServeEngine(
                _jax_layers, {n: jnp.asarray(k) for n, k in params.items()},
                backend="fft-xla", **common)
            to_input = jnp.asarray
        else:
            eng = ServeEngine(
                _layers, {n: torch.from_numpy(k) for n, k in params.items()},
                backend="fft-cuda", device="cpu", **common)
            to_input = torch.from_numpy
        for tr, x in zip(trace, xs):
            clock.t = tr.t
            eng.submit(to_input(x))
            eng.drain()
        eng.drain(force=True)
        engines[side] = eng
    jrep, trep = (engines[s].report() for s in ("jax", "torch"))
    keys = ("n_requests", "n_batches", "occupancy")
    assert {label: {k: b[k] for k in keys}
            for label, b in trep["buckets"].items()} == \
        {label: {k: b[k] for k in keys}
         for label, b in jrep["buckets"].items()}
    assert trep["replica_batches"] == jrep["replica_batches"]
    assert trep["queue_depth_max"] == jrep["queue_depth_max"]
    assert len(trep["buckets"]) > 1            # more than one bucket ran
    jres, tres = engines["jax"].results, engines["torch"].results
    assert sorted(jres) == sorted(tres) == list(range(len(trace)))
    for rid in jres:
        yj = np.asarray(jres[rid])
        scale = np.abs(yj).max()
        np.testing.assert_allclose(tres[rid].numpy() / scale, yj / scale,
                                   atol=RESULT_TOL)


def test_bucket_report_equals_jax():
    ours = plan_network(_layers, buckets=(1, 2, 4), backend="fft-cuda")
    theirs = jconv.plan_network(_jax_layers, buckets=(1, 2, 4),
                                backend="fft-xla")
    keys = ("n_buckets", "n_layer_plans", "n_distinct_plans",
            "dedupe_ratio")
    assert {k: ours.report()[k] for k in keys} == \
        {k: theirs.report()[k] for k in keys}
    # a net whose two layers share one geometry dedupes the same way
    def same(batch):
        return [NetworkConv(n, (batch, 4, 8, 8), (4, 4, 3, 3), padding=1)
                for n in ("a", "b", "c")]

    def jsame(batch):
        return [jconv.NetworkConv(l.name, l.x_shape, l.k_shape, padding=1)
                for l in same(batch)]
    ours = plan_network(same, buckets=(1, 2), backend="fft-cuda").report()
    theirs = jconv.plan_network(jsame, buckets=(1, 2),
                                backend="fft-xla").report()
    assert {k: ours[k] for k in keys} == {k: theirs[k] for k in keys}
    assert ours["dedupe_ratio"] == pytest.approx(2 / 6)


# --------------------------------------------------------------------------
# The port's own: entry point, what is not ported, accounting on the host
# --------------------------------------------------------------------------

def test_serve_trace_entry_point_on_cpu(capsys, tmp_path):
    """``python -m repro_torch.launch.serve --serve-trace`` end to end on
    the host at a small size, with its bench rows and cold-start report;
    the trace is JAX's for the same flags."""
    bench, cold = tmp_path / "bench.json", tmp_path / "cold.json"
    res = serve.main(["--serve-trace", "--conv-backend", "fft-cuda",
                      "--image", "32", "--max-batch", "2",
                      "--trace-requests", "5", "--seed", "0",
                      "--bench-out", str(bench),
                      "--coldstart-out", str(cold), "--device", "cpu"])
    out = capsys.readouterr().out
    assert "serve-trace mode=bucketed" in out and "eager on cpu" in out
    rep = res.reports["bucketed"]
    assert rep["n_requests"] == 5 and rep["timing"] == "per-batch"
    assert rep["plan_cache_misses_after_warmup"] == 0
    assert [(r.t, r.batch) for r in res.trace] == [
        (r.t, r.batch) for r in jbatcher.synthetic_trace(
            n_requests=5, max_batch=2, rate_rps=1.0, seed=0)]
    eng = res.engines["bucketed"]
    for rid, tr in enumerate(res.trace):
        y = eng.results[rid]
        assert tuple(y.shape) == (tr.batch, 512, 1, 1)
        assert bool(torch.isfinite(y).all())
    assert bench.exists() and cold.exists()


@pytest.mark.parametrize("serve_trace", [False, True],
                         ids=["fixed", "serve-trace"])
def test_serve_tune_prints_the_layers_and_serves(capsys, tmp_path,
                                                 monkeypatch, serve_trace):
    """``serve --tune --device cpu``: the tuner measures every layer on the
    host while planning (the bucketed engine before its warm-up), prints
    the sweep, the cache path and one line per layer (per bucket with
    --serve-trace), and the tuned plans serve."""
    from repro_torch.conv import autotune
    cache = tmp_path / "tune.json"
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(cache))
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_BUDGET_MS", "1")
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_REPS", "1")
    monkeypatch.delenv("REPRO_TORCH_AUTOTUNE", raising=False)
    autotune.reset()
    try:
        if serve_trace:
            res = serve.main(["--tune", "--serve-trace", "--device", "cpu",
                              "--image", "32", "--max-batch", "2",
                              "--trace-requests", "4"])
            nets = res.engines["bucketed"].nets.values()
            assert res.reports["bucketed"]["n_requests"] == 4
        else:
            res = serve.main(["--tune", "--device", "cpu", "--smoke",
                              "--batch", "1", "--gen", "1"])
            nets = [res.net]
            assert bool(torch.isfinite(res.y).all())
        out = capsys.readouterr().out
        assert f"(cache: {cache})" in out and cache.exists()
        lines = [l for l in out.splitlines() if "[measured]" in l]
        assert len(lines) == 9 * len(nets)
        assert autotune.autotune_info().measured == 9 * len(nets)
        with autotune.measure_on("cpu"):
            for net in nets:
                assert {r["source"] for r in net.tuning_report().values()} \
                    == {"measured"}
    finally:
        autotune.reset()


@pytest.mark.parametrize("flag,item", [
    (["--export-plans", "p.rpa"], "item 7"),
    (["--load-plans", "p.rpa"], "item 7")])
def test_serve_refuses_what_is_not_ported(flag, item):
    with pytest.raises(NotImplementedError, match=item):
        serve.main(["--serve-trace", "--device", "cpu"] + flag)


def test_engine_refuses_what_is_not_ported():
    with pytest.raises(NotImplementedError, match="item 7"):
        _engine(load_plans="p.rpa")
    eng = _engine(policy=BucketPolicy(max_batch=1))
    with pytest.raises(NotImplementedError, match="item 7"):
        eng.export_plans("p.rpa")
    nets = plan_network(_layers, buckets=(1,), backend="fft-cuda")
    with pytest.raises(NotImplementedError, match="item 7"):
        nets.export("p.rpa")
    # item 6, plan-lint, is ported: the bucket's report runs
    assert nets[1].report()["n_layers"] == len(nets[1])


def test_engine_runs_on_the_gpu_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(_layers, _params(), policy=BucketPolicy(max_batch=1),
                    backend="fft-cuda")


def test_host_engine_runs_eager_and_reports_no_graphs():
    eng = _engine(policy=BucketPolicy(max_batch=2))
    rids = [eng.submit(_rand((1, 2, 8, 8), seed=i)) for i in range(3)]
    eng.drain(force=True)
    rep = eng.report()
    assert rep["executor"] == "eager" and rep["device"] == "cpu"
    assert rep["graph_replays"] == {} and rep["graph_pool_bytes"] is None
    assert rep["graph_pool_bytes_by_bucket"] == {}
    assert rep["startup_s"] >= rep["startup_plan_prepare_s"] >= 0
    # every result is a copy of its rows, not a view of a shared output
    assert all(eng.results[r]._base is None for r in rids)


def test_request_rows_must_match_the_bucket():
    eng = _engine(policy=BucketPolicy(max_batch=2))
    eng.submit(torch.zeros((1, 1, 8, 8)))     # one channel, not two
    with pytest.raises(ValueError, match="do not match"):
        eng.drain(force=True)
