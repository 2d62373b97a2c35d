"""repro_torch's plan artifacts (``repro_torch.conv.export``) and checkpoint
store (``repro_torch.checkpoint``), on the CPU.

Twins of the 20 tests of ``tests/test_export.py``: round-trip parity
(local, real spectrum and nfft on a (1, 1) gloo mesh, prepared and
unprepared), the loaded layers' calling convention, fresh-process bitwise
parity, the fallback on each stamp, ``verify`` naming a tampered layer,
bucket labels, the spec-first planner and tuner, the checkpoint keys, the
legacy layout and the plan artifact beside a checkpoint, and the serve
engine's ``export_plans``/``load_plans``.  The JAX package's test of its
native executables against its StableHLO modules becomes a test that a
tampered kernel-library digest falls back to live planning with equal
results (the port ships neither).

Beside the twins: checkpoints cross between the two packages in both
directions, bit for bit, with their key strings pinned; the port's
``plan_config`` equals the JAX package's but for the backend's name and
the mesh's form; an artifact loaded ahead of time plans nothing and
transforms no kernel; two spawned gloo ranks at (1, 2) and (2, 1) export
and load an nfft engine, agree on falling back when one rank's copy is
stale, and fall back together when the artifact is of another world size;
and ``serve --export-plans`` then ``--load-plans`` prints its
certification line.
"""
import collections
import json
import os
import subprocess
import sys
import zipfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

from repro_torch import checkpoint
from repro_torch.conv import (
    Epilogue, NetworkConv, autotune, load_network,
    plan_cache_info, plan_conv, plan_network, prepared_cache_info,
    stage_trace,
)
from repro_torch.conv import export as planx
from repro_torch.launch import mesh as tmesh
from repro_torch.launch.batcher import BucketPolicy, ServeEngine

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SRC = os.path.join(ROOT, "src")
TOL = 1e-5


def _np(shape, seed=0, s=0.5):
    return (s * np.random.default_rng(seed).standard_normal(shape)).astype(
        np.float32)


def _rand(shape, seed=0, s=0.5):
    return torch.from_numpy(_np(shape, seed, s))


def _layers(batch=2, image=8):
    return [
        NetworkConv("c1", (batch, 2, image, image), (4, 2, 3, 3),
                    padding=1, epilogue=Epilogue(bias=True,
                                                 activation="relu")),
        NetworkConv("c2", (batch, 4, image, image), (4, 4, 3, 3),
                    padding=1),
    ]


def _net(schedule="auto", mesh=None, spectrum="auto", backend="fft-cuda"):
    return plan_network(_layers(), backend=backend, schedule=schedule,
                        mesh=mesh, spectrum=spectrum)


def _params():
    return {"c1": _rand((4, 2, 3, 3), 1), "c2": _rand((4, 4, 3, 3), 2)}


def _run(net, x, bias):
    return net["c2"](net["c1"](x, bias=bias))


def _full(y):
    return y.full_tensor() if hasattr(y, "full_tensor") else y


def _tamper(path, out, **fields):
    with zipfile.ZipFile(path) as zin, \
            zipfile.ZipFile(out, "w", zipfile.ZIP_STORED) as zout:
        for m in zin.namelist():
            data = zin.read(m)
            if m == "manifest.json":
                man = json.loads(data)
                man.update(fields)
                data = json.dumps(man)
            zout.writestr(m, data)
    return out


@pytest.fixture(scope="module")
def mesh():
    """A (1, 1) mesh on a one-rank gloo group, for the whole module."""
    tmesh.start_process_group("gloo")
    try:
        yield tmesh.make_host_mesh(1, 1)
    finally:
        tmesh.destroy_process_group()


# --------------------------------------------------------------------------
# Round-trip parity: {local, real spectrum, nfft} x {prepared, raw}
# --------------------------------------------------------------------------

@pytest.mark.parametrize("schedule,spectrum", [
    ("local", "auto"), ("local", "real"), ("nfft", "auto"),
])
@pytest.mark.parametrize("prepared", [True, False])
def test_roundtrip_parity(request, tmp_path, schedule, spectrum, prepared):
    m = request.getfixturevalue("mesh") if schedule == "nfft" else None
    net = _net(schedule=schedule, mesh=m, spectrum=spectrum)
    params = _params()
    path = str(tmp_path / "net.rpa")
    net.export(path, params=params if prepared else None,
               weights_version=3, device="cpu")

    prep = net.prepare(params, weights_version=3)
    x = _rand((2, 2, 8, 8), 7, s=1.0)
    bias = _rand((4,), 9)
    want = _full(_run(prep, x, bias))

    loaded = load_network(path, device="cpu", mesh=m)
    assert loaded.source == "aot"
    assert loaded.weights_version == 3
    if prepared:
        got = loaded["c2"](loaded["c1"](x, bias=bias))
        for name in ("c1", "c2"):    # the live prepare's slabs, bit for bit
            for a, b in zip(loaded[name].state, prep[name].state):
                assert torch.equal(a, b) and a.stride() == b.stride()
    else:
        got = loaded["c2"](loaded["c1"](x, params["c1"], bias=bias),
                           params["c2"])
    # the plan built from the stored config is the live plan, mesh and all
    assert loaded["c1"].plan == net["c1"]
    assert loaded["c1"].plan.mesh is m
    assert not any(lc.native for lc in loaded.layers.values())
    torch.testing.assert_close(_full(got), want, rtol=TOL, atol=TOL)


def test_loaded_layer_arg_conventions(tmp_path):
    net = _net()
    params = _params()
    path = str(tmp_path / "net.rpa")
    net.export(path, params=params)
    loaded = load_network(path, device="cpu")
    x = _rand((2, 2, 8, 8), 3)
    with pytest.raises(TypeError, match="takes only x"):
        loaded["c1"](x, params["c1"], bias=_rand((4,), 1))
    with pytest.raises(ValueError, match="bias"):
        loaded["c1"](x)                     # epilogue declares bias
    with pytest.raises(ValueError, match="bias"):
        loaded["c2"](x, bias=_rand((4,), 1))   # c2 has no bias
    path2 = str(tmp_path / "raw.rpa")
    net.export(path2, device="cpu")
    raw = load_network(path2, device="cpu")
    with pytest.raises(TypeError, match=r"takes \(x, k\)"):
        raw["c2"](x)


# --------------------------------------------------------------------------
# A tampered kernel library falls back to live planning
# --------------------------------------------------------------------------

def test_tampered_kernel_library_falls_back_to_live(tmp_path):
    """The twin of the JAX package's native-executable test: the port
    ships no executable, and the stamp that stands for its compiled code
    is each kernel library's digest of source and flags."""
    net = _net()
    params = _params()
    path = str(tmp_path / "net.rpa")
    net.export(path, params=params)
    man = planx.read_manifest(path)
    assert set(man["kernels"]) == {"cgemm", "dft_tile"}
    assert all(v.endswith(".so") for v in man["kernels"].values())

    x = _rand((2, 2, 8, 8), 5, s=1.0)
    bias = _rand((4,), 6)
    aot = load_network(path, device="cpu")
    y_aot = _run(aot, x, bias)
    bad = _tamper(path, str(tmp_path / "lib.rpa"),
                  kernels=dict(man["kernels"], cgemm="cgemm-0.so"))
    with pytest.warns(UserWarning, match="kernels"):
        live = load_network(bad, device="cpu")
    assert live.source == "live"
    torch.testing.assert_close(_run(live, x, bias), y_aot, rtol=0, atol=0)


# --------------------------------------------------------------------------
# Fresh-process load (the fleet cold-start path)
# --------------------------------------------------------------------------

_SUBPROC = r"""
import json, sys
import numpy as np
import torch
from repro_torch.conv import load_network, plan_cache_info
loaded = load_network(sys.argv[1], device="cpu")
assert loaded.source == "aot", loaded.source
assert plan_cache_info().misses == 0
x = torch.from_numpy((0.5 * np.random.default_rng(7).standard_normal(
    (2, 2, 8, 8))).astype(np.float32))
bias = torch.from_numpy((0.5 * np.random.default_rng(9).standard_normal(
    (4,))).astype(np.float32))
y = loaded["c2"](loaded["c1"](x, bias=bias))
print("RESULT" + json.dumps(y.numpy().ravel().tolist()))
"""


def test_subprocess_bitwise_parity(tmp_path):
    net = _net()
    params = _params()
    path = str(tmp_path / "net.rpa")
    net.export(path, params=params)

    prep = net.prepare(params, weights_version=None)
    x, bias = _rand((2, 2, 8, 8), 7), _rand((4,), 9)
    want = _run(prep, x, bias).numpy()

    env = dict(os.environ, PYTHONPATH=SRC)
    r = subprocess.run([sys.executable, "-c", _SUBPROC, path],
                       env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    line = [ln for ln in r.stdout.splitlines()
            if ln.startswith("RESULT")][0]
    got = np.asarray(json.loads(line[len("RESULT"):]),
                     np.float32).reshape(want.shape)
    np.testing.assert_array_equal(got, want)   # same slabs, same kernels


# --------------------------------------------------------------------------
# Compatibility mismatch -> live fallback (or error)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("fields", [
    {"torch_version": "0.0.1"},
    {"cuda_version": "9.9"},
    {"device_name": "NVIDIA H100 80GB HBM3"},
    {"compute_capability": "9.0"},
    {"artifact_version": 0},
], ids=lambda f: next(iter(f)))
def test_mismatch_falls_back_to_live(tmp_path, fields):
    net = _net()
    params = _params()
    path = str(tmp_path / "net.rpa")
    net.export(path, params=params, weights_version=1)
    bad = _tamper(path, str(tmp_path / "bad.rpa"), **fields)
    stamp = next(iter(fields))
    assert [r.split()[0] for r in planx.compat_reasons(
        planx.read_manifest(bad), device="cpu")] == [stamp]

    with pytest.warns(UserWarning, match="falling back to live planning"):
        loaded = load_network(bad, device="cpu")
    assert loaded.source == "live"

    x = _rand((2, 2, 8, 8), 7, s=1.0)
    bias = _rand((4,), 9)
    prep = net.prepare(params, weights_version=1)
    torch.testing.assert_close(_run(loaded, x, bias), _run(prep, x, bias),
                               rtol=TOL, atol=TOL)

    with pytest.raises(planx.ArtifactMismatch, match=stamp):
        load_network(bad, on_mismatch="error", device="cpu")
    with pytest.raises(ValueError, match="on_mismatch"):
        load_network(bad, on_mismatch="explode", device="cpu")


def test_verify_fingerprints(tmp_path):
    net = _net()
    path = str(tmp_path / "net.rpa")
    net.export(path, params=_params())
    v = planx.verify(path)
    assert v["ok"] and v["n_checked"] == 2 and not v["mismatches"]

    # corrupt one stamp -> verify names the layer
    man = planx.read_manifest(path)
    man["nets"]["net"]["layers"]["c1"]["fingerprint"] = "sha256:bogus"
    bad = _tamper(path, str(tmp_path / "bad.rpa"), nets=man["nets"])
    v = planx.verify(bad)
    assert not v["ok"]
    assert [m["layer"] for m in v["mismatches"]] == ["c1"]


def test_bucketed_export_labels(tmp_path):
    def make_layers(b):
        return [NetworkConv("c1", (b, 2, 8, 8), (4, 2, 3, 3), padding=1)]
    nets = plan_network(make_layers, buckets=(1, 2), backend="fft-cuda")
    path = str(tmp_path / "b.rpa")
    nets.export(path, params={"c1": _rand((4, 2, 3, 3), 1)})
    loaded = load_network(path, device="cpu")
    assert sorted(loaded) == ["b1", "b2"]
    assert loaded["b2"]["c1"].x_shape == (2, 2, 8, 8)
    # equal slabs of the two buckets are stored once and loaded once
    man = planx.read_manifest(path)
    assert len(man["tensors"]) == 3            # Gr, Gi, the kernel
    assert all(a is b for a, b in zip(loaded["b1"]["c1"].state,
                                      loaded["b2"]["c1"].state))


# --------------------------------------------------------------------------
# Spec-first planner and tuner (plan_conv / tune take a ConvSpec)
# --------------------------------------------------------------------------

def test_plan_conv_spec_first():
    from repro_torch.core.conv_spec import ConvSpec
    spec = ConvSpec(B=2, C=2, Cout=4, H=8, W=8, kh=3, kw=3,
                    pad_h=1, pad_w=1)
    a = plan_conv(spec, backend="fft-torch")
    b = plan_conv((2, 2, 8, 8), (4, 2, 3, 3), padding=1,
                  backend="fft-torch")
    assert a is b                       # identical cache entry
    with pytest.raises(TypeError, match="already carries"):
        plan_conv(spec, (4, 2, 3, 3))
    with pytest.raises(TypeError, match="k_shape"):
        plan_conv((2, 2, 8, 8))


def test_tune_spec_first(tmp_path, monkeypatch):
    from repro_torch.core.conv_spec import ConvSpec
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE",
                       str(tmp_path / "tune.json"))
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_REPS", "1")
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_BUDGET_MS", "200")
    autotune.reset()
    try:
        spec = ConvSpec(B=1, C=2, Cout=2, H=8, W=8, kh=3, kw=3)
        cfg = autotune.tune(spec, reps=1, device="cpu")
        cfg2 = autotune.tune((1, 2, 8, 8), (2, 2, 3, 3), padding=(0, 0),
                             reps=1, device="cpu")
        assert cfg.backend == cfg2.backend
        assert cfg.schedule == cfg2.schedule
        with pytest.raises(TypeError, match="already carries"):
            autotune.tune(spec, (2, 2, 3, 3), device="cpu")
    finally:
        autotune.reset()


# --------------------------------------------------------------------------
# Checkpoint keys: keystr + legacy restore + plan artifacts
# --------------------------------------------------------------------------

Pair = collections.namedtuple("Pair", ["w", "b"])
KEYS = ["['a']['b']", "['a.b']", "['lst'][0]", "['lst'][1].b",
        "['lst'][1].w"]


def _tree(lib):
    """The reference test's tree, in numpy, built by ``lib``'s arrays."""
    return {
        "a": {"b": lib(np.arange(3.0, dtype=np.float32))},
        "a.b": lib(np.arange(4.0, dtype=np.float32)),  # collides if joined
        "lst": [lib(np.ones((2,), np.float32)),
                Pair(w=lib(np.zeros((2, 2), np.float32)),
                     b=lib(np.full((1,), 7.0, np.float32)))],
    }


def _leaves(tree):
    from torch.utils import _pytree
    return [np.asarray(x) for x in _pytree.tree_leaves(tree)]


def test_checkpoint_keystr_roundtrip(tmp_path):
    tree = _tree(torch.from_numpy)
    d = str(tmp_path / "ck")
    checkpoint.save(d, 1, tree, weights_version=5)
    like = _tree(lambda a: torch.zeros(a.shape))
    got, meta = checkpoint.restore(d, 1, like, device="cpu")
    assert meta["weights_version"] == 5
    assert meta["format"] == 2
    assert meta["keys"] == KEYS
    for x, y in zip(_leaves(tree), _leaves(got)):
        np.testing.assert_array_equal(x, y)


def test_checkpoint_legacy_layout_restores(tmp_path):
    tree = {"w": torch.arange(4.0), "inner": {"b": torch.ones((2,))}}
    d = str(tmp_path / "ck" / "step_00000003")
    os.makedirs(d)
    # hand-write the pre-keystr layout: <joined-key>.npy, no files map
    np.save(os.path.join(d, "w.npy"), np.arange(4.0, dtype=np.float32))
    np.save(os.path.join(d, "inner.b.npy"), np.ones((2,), np.float32))
    with open(os.path.join(d, "meta.json"), "w") as f:
        json.dump({"step": 3, "keys": ["inner.b", "w"], "extra": {}}, f)
    like = {"w": torch.zeros(4), "inner": {"b": torch.zeros(2)}}
    got, meta = checkpoint.restore(str(tmp_path / "ck"), 3, like,
                                   device="cpu")
    np.testing.assert_array_equal(got["w"].numpy(),
                                  np.arange(4.0, dtype=np.float32))
    np.testing.assert_array_equal(got["inner"]["b"].numpy(),
                                  np.ones((2,), np.float32))
    assert sorted(tree) == sorted(got)


def test_plan_artifact_rides_checkpoint(tmp_path):
    net = _net()
    params = _params()
    d = str(tmp_path / "ck")
    with pytest.raises(FileNotFoundError, match="save the weights"):
        checkpoint.save_plan_artifact(d, 2, net, params)
    checkpoint.save(d, 2, params, weights_version=2)
    assert not checkpoint.has_plan_artifact(d, 2)
    checkpoint.save_plan_artifact(d, 2, net, params)
    assert checkpoint.has_plan_artifact(d, 2)
    assert checkpoint.latest_step(d) == 2
    loaded = checkpoint.load_plan_artifact(d, 2, device="cpu")
    assert loaded.source == "aot"
    assert loaded.weights_version == 2      # defaults to the step
    with pytest.raises(FileNotFoundError, match="no plan artifact"):
        checkpoint.load_plan_artifact(d, 99)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoint_crosses_packages(tmp_path, writer):
    """A checkpoint written by either package restores in the other, bit
    for bit, under the same key strings."""
    import jax
    import jax.numpy as jnp
    from repro import checkpoint as jcheckpoint
    d = str(tmp_path / "ck")
    if writer == "jax":
        jcheckpoint.save(d, 4, _tree(jnp.asarray), weights_version=4)
        got, meta = checkpoint.restore(
            d, 4, _tree(lambda a: torch.zeros(a.shape)), device="cpu")
        assert all(isinstance(x, torch.Tensor)
                   for x in jax.tree_util.tree_leaves(
                       got, is_leaf=lambda x: isinstance(x, torch.Tensor)))
    else:
        checkpoint.save(d, 4, _tree(torch.from_numpy), weights_version=4)
        got, meta = jcheckpoint.restore(d, 4,
                                        _tree(lambda a: jnp.zeros(a.shape)))
    assert meta["keys"] == KEYS and meta["weights_version"] == 4
    for x, y in zip(_leaves(_tree(np.asarray)), _leaves(got)):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


def test_checkpoint_restores_a_dtensor_elsewhere(tmp_path, mesh):
    """A ``DTensor`` leaf is saved whole; ``shardings`` places it again."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    w = _rand((4, 6), 3)
    tree = {"w": distribute_tensor(w, mesh, [Shard(0), Shard(1)]),
            "b": torch.ones(2, dtype=torch.bfloat16)}
    d = str(tmp_path / "ck")
    checkpoint.save_async(d, 1, tree)
    checkpoint.wait_pending()
    like = {"w": torch.zeros(4, 6), "b": torch.zeros(2)}
    got, meta = checkpoint.restore(
        d, 1, like, shardings={"w": (mesh, [Replicate(), Replicate()]),
                               "b": None}, device="cpu")
    assert got["w"].placements == (Replicate(), Replicate())
    assert torch.equal(got["w"].full_tensor(), w)
    assert got["b"].dtype == torch.bfloat16 and meta["dtypes"] == {
        "['b']": "bfloat16"}


# --------------------------------------------------------------------------
# The port's plan config against the JAX package's; an ahead-of-time load
# plans nothing and transforms nothing
# --------------------------------------------------------------------------

def test_plan_config_matches_the_jax_package(mesh):
    import jax.numpy as jnp
    from repro.compat import make_mesh as jmake_mesh
    from repro.conv import export as jplanx
    from repro.conv import plan_conv as jplan_conv
    jmesh = jmake_mesh((1, 1), ("data", "model"))
    ep = Epilogue(bias=True, activation="relu")
    cases = [dict(), dict(spectrum="complex", three_m=False),
             dict(compute_dtype=(torch.bfloat16, jnp.bfloat16)),
             dict(schedule="nfft", mesh=(mesh, jmesh), overlap="slab:2"),
             dict(schedule="wfft", mesh=(mesh, jmesh),
                  replicate_kernel_transform=True)]
    for case in cases:
        tkw = {k: v[0] if isinstance(v, tuple) else v
               for k, v in case.items()}
        jkw = {k: v[1] if isinstance(v, tuple) else v
               for k, v in case.items()}
        t = planx.plan_config(plan_conv(
            (4, 2, 8, 8), (4, 2, 3, 3), padding=1, backend="fft-torch",
            epilogue=ep, **tkw))
        j = jplanx.plan_config(jplan_conv(
            (4, 2, 8, 8), (4, 2, 3, 3), padding=1, backend="fft-xla",
            epilogue=ep, **jkw))
        assert (t.pop("backend"), j.pop("backend")) == ("fft-torch",
                                                        "fft-xla")
        tm, jm = t.pop("mesh"), j.pop("mesh")
        if jm is not None:
            assert tm == dict(jm, device_type="cpu")
        assert tm is None or jm is not None
        assert t == j, case


def test_aot_load_plans_nothing_and_transforms_nothing(tmp_path,
                                                       monkeypatch):
    net = _net()
    params = _params()
    path = str(tmp_path / "net.rpa")
    net.export(path, params=params, weights_version=0)
    from repro_torch.conv import plan as plan_mod

    def no_planning(*a, **kw):
        raise AssertionError("an ahead-of-time load called plan_conv")
    monkeypatch.setattr(plan_mod, "plan_conv", no_planning)
    plans, prepared = plan_cache_info(), prepared_cache_info()
    with stage_trace() as counts:
        loaded = load_network(path, device="cpu")
    assert loaded.source == "aot"
    assert counts["kernel_transform"] == 0
    assert (plan_cache_info(), prepared_cache_info()) == (plans, prepared)
    with stage_trace() as counts:
        _run(loaded, _rand((2, 2, 8, 8), 4), _rand((4,), 5))
    assert (counts["input_transform"], counts["kernel_transform"]) == (2, 0)


def test_loaded_network_matches_the_jax_package(tmp_path):
    """The same numpy weights through the JAX package's artifact and the
    port's, each loaded ahead of time."""
    import jax.numpy as jnp
    from repro.conv import Epilogue as JEpilogue
    from repro.conv import NetworkConv as JNetworkConv
    from repro.conv import load_network as jload_network
    from repro.conv import plan_network as jplan_network
    ep = JEpilogue(bias=True, activation="relu")
    jnet = jplan_network([JNetworkConv(l.name, l.x_shape, l.k_shape,
                                       padding=1, epilogue=ep
                                       if l.epilogue.bias else JEpilogue())
                          for l in _layers()], backend="fft-xla")
    kern = {"c1": _np((4, 2, 3, 3), 1), "c2": _np((4, 4, 3, 3), 2)}
    x, bias = _np((2, 2, 8, 8), 7, 1.0), _np((4,), 9)
    jpath, tpath = str(tmp_path / "j.rpa"), str(tmp_path / "t.rpa")
    jnet.export(jpath, params={k: jnp.asarray(v) for k, v in kern.items()})
    _net().export(tpath, params={k: torch.from_numpy(v)
                                 for k, v in kern.items()})
    jl, tl = jload_network(jpath), load_network(tpath, device="cpu")
    want = np.asarray(_run(jl, jnp.asarray(x), jnp.asarray(bias)))
    got = _run(tl, torch.from_numpy(x), torch.from_numpy(bias)).numpy()
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


# --------------------------------------------------------------------------
# ServeEngine: export_plans / load_plans
# --------------------------------------------------------------------------

def _engine_bits():
    def make_layers(b):
        return [
            NetworkConv("s1", (b, 2, 8, 8), (4, 2, 3, 3), padding=1),
            NetworkConv("s2", (b, 4, 8, 8), (4, 4, 3, 3), padding=1),
        ]

    params = {"s1": _rand((4, 2, 3, 3), 1), "s2": _rand((4, 4, 3, 3), 2)}
    return make_layers, params


def test_engine_export_load_parity_zero_misses(tmp_path):
    make_layers, params = _engine_bits()
    policy = BucketPolicy(max_batch=2)
    live = ServeEngine(make_layers, params, policy=policy,
                       backend="fft-cuda", collect_results=True,
                       device="cpu")
    path = str(tmp_path / "plans.rpa")
    live.export_plans(path)

    plans = plan_cache_info()
    aot = ServeEngine(make_layers, params, policy=policy,
                      backend="fft-cuda", collect_results=True,
                      load_plans=path, device="cpu")
    assert aot.plan_source == "aot"
    assert plan_cache_info() == plans          # the load planned nothing
    with pytest.raises(RuntimeError, match="export_plans"):
        aot.export_plans(str(tmp_path / "again.rpa"))

    x = _rand((2, 2, 8, 8), 11, s=1.0)
    misses0 = plan_cache_info().misses
    ra = aot.submit(x)
    rl = live.submit(x)
    aot.drain()
    live.drain()
    assert plan_cache_info().misses == misses0   # nothing planned
    torch.testing.assert_close(aot.results[ra], live.results[rl],
                               rtol=TOL, atol=TOL)
    rep = aot.report()
    assert rep["plan_cache_misses_after_warmup"] == 0
    assert rep["plan_source"] == "aot"
    assert rep["startup_load_s"] > 0 == live.report()["startup_load_s"]

    # weight update drops the artifact and re-plans live
    params2 = {k: v + 0.01 for k, v in params.items()}
    aot.update_weights(params2, weights_version=1)
    assert aot.plan_source == "live"
    r2 = aot.submit(x)
    aot.drain()
    assert torch.isfinite(aot.results[r2]).all()


def test_engine_stale_artifact_falls_back(tmp_path):
    make_layers, params = _engine_bits()
    policy = BucketPolicy(max_batch=2)
    live = ServeEngine(make_layers, params, policy=policy,
                       backend="fft-cuda", device="cpu")
    path = str(tmp_path / "plans.rpa")
    live.export_plans(path)

    with pytest.warns(UserWarning, match="falling back to live"):
        eng = ServeEngine(make_layers, params, policy=policy,
                          backend="fft-cuda", load_plans=path,
                          weights_version=99, device="cpu")  # artifact: 0
    assert eng.plan_source == "live"
    rep = eng.report()
    assert rep["plan_source"] == "live"
    assert rep["startup_s"] > 0
    with pytest.warns(UserWarning, match="no bucket 'b4'"):
        eng = ServeEngine(make_layers, params,
                          policy=BucketPolicy(max_batch=4),
                          backend="fft-cuda", load_plans=path, device="cpu")
    assert eng.plan_source == "live"
    with pytest.raises(ValueError, match="bucketed"):
        ServeEngine(make_layers, params, policy=policy, mode="pad-max",
                    backend="fft-cuda", load_plans=path, device="cpu")


def test_serve_exports_then_loads_and_certifies(tmp_path):
    """``serve --serve-trace --export-plans`` then ``--load-plans`` in a
    fresh process: the certification line, and a cold-start report."""
    path, cs = str(tmp_path / "vgg.rpa"), str(tmp_path / "cs.json")
    base = [sys.executable, "-m", "repro_torch.launch.serve",
            "--serve-trace", "--device", "cpu", "--image", "32",
            "--max-batch", "2", "--trace-requests", "3",
            "--conv-backend", "fft-cuda"]
    env = dict(os.environ, PYTHONPATH=SRC)
    for extra in (["--export-plans", path],
                  ["--load-plans", path, "--coldstart-out", cs]):
        r = subprocess.run(base + extra, env=env, capture_output=True,
                           text=True, timeout=300)
        assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert "load-plans OK: 18 layer fingerprints match a live plan" \
        in r.stdout
    report = json.loads(open(cs).read())
    assert (report["source"], report["fingerprints_verified"],
            report["plan_cache_misses_after_warmup"]) == ("aot", True, 0)
    with pytest.raises(SystemExit):
        from repro_torch.launch import serve
        serve.main(["--load-plans", path, "--device", "cpu"])


# --------------------------------------------------------------------------
# Two spawned gloo ranks at (1, 2) and (2, 1)
# --------------------------------------------------------------------------

_RANK = r'''
import json, os, sys, warnings
import numpy as np
import torch
sys.path.insert(0, os.environ["TESTS"])
import test_torch_export as T
from repro_torch.conv import load_network, stage_trace
from repro_torch.launch import mesh as M
from repro_torch.launch.batcher import BucketPolicy, ServeEngine

rank = int(os.environ["RANK"])
shape = tuple(json.loads(os.environ["SHAPE"]))
tmp = os.environ["OUT"]
M.start_process_group("gloo", rank=rank, world_size=2,
                      store_path=os.environ["STORE"])
mesh = M.make_host_mesh(*shape)
make_layers, params = T._engine_bits()
x = T._rand((2, 2, 8, 8), 11, s=1.0)


def engine(**kw):
    return ServeEngine(make_layers, params, policy=BucketPolicy(max_batch=2),
                       mesh=mesh, schedule="nfft", backend="fft-cuda",
                       device="cpu", **kw)


def serve(eng):
    rid = eng.submit(x)
    eng.drain(force=True)
    return eng.results[rid].tolist()


def load(path):
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        eng = engine(load_plans=path)
    return eng, [str(m.message) for m in w
                 if "falling back" in str(m.message)]


out = {}
live = engine()
out["live"] = serve(live)
path = os.path.join(tmp, "plans.rpa")
live.export_plans(path)                     # rank 0 writes, all meet
with stage_trace() as counts:
    net = load_network(path, mesh=mesh)["b2"]
out["direct_load"] = dict(
    source=net.source, transforms=counts["kernel_transform"],
    same_mesh=all(l.plan.mesh is mesh for l in net.layers.values()),
    slabs_equal=all(
        torch.equal(a, b) for name, l in net.items()
        for a, b in zip(l.state, live.nets[(2, None)][name].prepare(
            params[name], weights_version=0).state)))
eng, warned = load(path)
out["aot"] = dict(source=eng.plan_source, y=serve(eng), warned=warned)
# rank 1 alone holds a stale copy: every rank falls back
mine = path
if rank == 1:
    mine = T._tamper(path, os.path.join(tmp, "stale.rpa"),
                     torch_version="0.0.1")
eng, warned = load(mine)
out["one_stale"] = dict(source=eng.plan_source, y=serve(eng), warned=warned)
# an artifact of a world of one rank: every rank falls back
eng, warned = load(os.environ["WORLD1"])
out["other_world"] = dict(source=eng.plan_source, y=serve(eng),
                          warned=warned)
with open(os.path.join(tmp, f"out{rank}.json"), "w") as fh:
    json.dump(out, fh)
M.destroy_process_group()
'''

SHAPES = [(1, 2), (2, 1)]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory, mesh):
    """Export an nfft engine's artifact on this process's one-rank mesh,
    then run every scenario once per mesh shape on two spawned gloo
    ranks, both shapes at once."""
    make_layers, params = _engine_bits()
    world1 = str(tmp_path_factory.mktemp("world1") / "plans.rpa")
    ServeEngine(make_layers, params, policy=BucketPolicy(max_batch=2),
                mesh=mesh, schedule="nfft", backend="fft-cuda",
                device="cpu").export_plans(world1)
    runs = {}
    for shape in SHAPES:
        tmp = tmp_path_factory.mktemp(f"export_{shape[0]}x{shape[1]}")
        base = dict(os.environ, PYTHONPATH=SRC,
                    TESTS=os.path.dirname(os.path.abspath(__file__)),
                    OUT=str(tmp), STORE=str(tmp / "store"), WORLD1=world1,
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
def test_ranks_export_and_load_ahead_of_time(two_ranks, shape):
    for r in two_ranks[shape]:
        assert r["direct_load"] == dict(source="aot", transforms=0,
                                        same_mesh=True, slabs_equal=True)
        assert r["aot"]["source"] == "aot" and not r["aot"]["warned"]
        np.testing.assert_allclose(r["aot"]["y"], r["live"], rtol=0,
                                   atol=TOL)


@pytest.mark.parametrize("shape", SHAPES, ids=["1x2", "2x1"])
def test_ranks_fall_back_together(two_ranks, shape):
    r0, r1 = two_ranks[shape]
    for case in ("one_stale", "other_world"):
        assert r0[case]["source"] == r1[case]["source"] == "live"
        assert r0[case]["warned"] and r1[case]["warned"]
        for r in (r0, r1):
            np.testing.assert_allclose(r[case]["y"], r["live"], rtol=0,
                                       atol=TOL)
    assert "another rank" in r0["one_stale"]["warned"][0]
    assert "torch_version" in r1["one_stale"]["warned"][0]
    assert "world_size" in r0["other_world"]["warned"][0]


def test_export_plans_example_twin():
    """``repro_torch.examples.export_plans`` on the host: its own asserts,
    loaded ahead of time, equal to the live network bit for bit."""
    from repro_torch.examples import export_plans
    res = export_plans.main(["--device", "cpu"])
    assert res.source == "aot" and res.max_abs_diff == 0.0
    assert res.verified == {"ok": True, "n_checked": 2, "mismatches": []}
    assert res.lines[-1] == ("verify: ok=True (2 layer fingerprints match "
                             "a live plan)")
    os.remove(res.path)
