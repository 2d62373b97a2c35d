"""repro_torch.conv.autotune, the port's measured autotuner, on the CPU:
twins of the local-schedule tests of tests/test_autotune.py (``fft-xla``
-> ``fft-torch``, ``fft-pallas`` -> ``fft-cuda``), the port's own key
(device name, torch and CUDA versions, the TF32 switches), its CGEMM tile
rows as the tuned axis, and parity with the JAX package's tuner on the
same numpy inputs: the cost-model fallback names the same backend on all
17 layers of Table I, and a seeded winner plans to outputs within 1e-4
(rtol and atol) of the JAX package's tuned plan.  On the CPU the
``fft-cuda`` kernels run their plain versions; the tuner measures there
only when asked (``device="cpu"`` / ``autotune.measure_on("cpu")``)."""
import contextlib
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

import jax.numpy as jnp

import repro.conv as jconv
from repro.conv import autotune as jautotune
from repro_torch.configs.paper_convs import TABLE1
from repro_torch.conv import (
    Epilogue, NetworkConv, TunedConfig, autotune, autotune_info,
    clear_plan_cache, plan_conv, plan_network)
from repro_torch.core.fftconv import conv2d_direct
from repro_torch.kernels.cgemm.ops import SHAPES

X_SHAPE = (1, 4, 16, 16)
K_SHAPE = (8, 4, 3, 3)
# (port backend, JAX backend, spectrum): direct has no spectrum
SEEDED = [("direct", "direct", "real"),
          ("fft-torch", "fft-xla", "real"),
          ("fft-torch", "fft-xla", "complex"),
          ("fft-cuda", "fft-pallas", "real"),
          ("fft-cuda", "fft-pallas", "complex")]


def _rand(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _t(a):
    return torch.from_numpy(a)


@pytest.fixture
def tune_env(tmp_path, monkeypatch):
    """Isolated tuning cache + small budget, measuring on the CPU; engine
    caches cleared."""
    path = tmp_path / "tune.json"
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(path))
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_BUDGET_MS", "400")
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_REPS", "1")
    monkeypatch.delenv("REPRO_TORCH_AUTOTUNE", raising=False)
    autotune.reset()
    clear_plan_cache()
    with autotune.measure_on("cpu"):
        yield path
    autotune.reset()
    clear_plan_cache()


@pytest.fixture
def jax_tune_env(tmp_path, monkeypatch):
    """The JAX package's tuner on its own isolated cache."""
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "jax.json"))
    monkeypatch.delenv("REPRO_AUTOTUNE", raising=False)
    jautotune.reset()
    jconv.clear_plan_cache()
    yield
    jautotune.reset()
    jconv.clear_plan_cache()


@contextlib.contextmanager
def _host_mesh():
    """A (1, 1) mesh on a one-rank gloo group, for the block."""
    from repro_torch.launch import mesh as tmesh
    tmesh.start_process_group("gloo")
    try:
        yield tmesh.make_host_mesh(1, 1)
    finally:
        tmesh.destroy_process_group()


# --------------------------------------------------------------------------
# Cache semantics
# --------------------------------------------------------------------------

def test_tune_miss_then_hit_and_persistence(tune_env):
    w1 = autotune.tune(X_SHAPE, K_SHAPE, padding=1)
    assert w1.source == "measured" and w1.us_per_call > 0
    info = autotune_info()
    assert info.misses == 1 and info.hits == 0 and info.measured == 1
    assert os.path.exists(tune_env)

    w2 = autotune.tune(X_SHAPE, K_SHAPE, padding=1)
    assert w2 == w1                              # in-memory hit
    assert autotune_info().hits == 1

    # round-trip: drop the in-memory store, reload from disk, same winner
    autotune.reset()
    w3 = autotune.tune(X_SHAPE, K_SHAPE, padding=1)
    assert w3 == w1
    info = autotune_info()
    assert info.hits == 1 and info.misses == 0 and info.measured == 0


def test_cache_file_schema(tune_env):
    autotune.tune(X_SHAPE, K_SHAPE, padding=1)
    raw = json.load(open(tune_env))
    assert raw["version"] == autotune.CACHE_VERSION
    (key, entry), = raw["entries"].items()
    assert "|dev=cpu|" in key
    assert f"|torch={torch.__version__}|" in key
    assert f"|cuda={torch.version.cuda}|" in key
    assert "|tf32=cudnn:" in key and ",matmul:" in key
    assert entry["source"] == "measured"
    assert TunedConfig.from_json(entry).backend in (
        "direct", "fft-torch", "fft-cuda")


@pytest.mark.parametrize("change", [
    "device", "torch", "cuda", "cudnn_tf32", "matmul_tf32"])
def test_key_invalidation(tune_env, change):
    """A new card, a torch or CUDA upgrade, or another TF32 setting never
    matches the old key: the tuner measures again; back on the real key
    the first winner is still warm."""
    autotune.tune(X_SHAPE, K_SHAPE, padding=1)
    assert autotune_info().misses == 1
    with pytest.MonkeyPatch.context() as mp:
        if change == "device":
            mp.setattr(autotune, "_device_kind", lambda device: "H200")
        elif change == "torch":
            mp.setattr(autotune, "_torch_version", lambda: "99.0.0")
        elif change == "cuda":
            mp.setattr(autotune, "_cuda_version", lambda: "99.9")
        elif change == "cudnn_tf32":
            mp.setattr(torch.backends.cudnn, "allow_tf32",
                       not torch.backends.cudnn.allow_tf32)
        else:
            mp.setattr(torch.backends.cuda.matmul, "allow_tf32",
                       not torch.backends.cuda.matmul.allow_tf32)
        autotune.tune(X_SHAPE, K_SHAPE, padding=1)
        assert autotune_info().misses == 2
    autotune.tune(X_SHAPE, K_SHAPE, padding=1)
    assert autotune_info().hits == 1


def test_spec_signature_separates_geometry_and_constraints(tune_env):
    s1 = autotune.spec_signature(X_SHAPE, K_SHAPE, padding=1)
    assert s1 == autotune.spec_signature(X_SHAPE, K_SHAPE, padding=(1, 1))
    assert s1 != autotune.spec_signature(X_SHAPE, K_SHAPE, padding=0)
    assert s1 != autotune.spec_signature((2, 4, 16, 16), K_SHAPE, padding=1)
    assert s1 != autotune.spec_signature(X_SHAPE, K_SHAPE, padding=1,
                                         schedule="local")
    assert s1 != autotune.spec_signature(X_SHAPE, K_SHAPE, padding=1,
                                         compute_dtype=torch.bfloat16)
    assert s1 != autotune.spec_signature(X_SHAPE, K_SHAPE, padding=1,
                                         three_m=False)
    # a pin-constrained sweep must never answer for an unconstrained one
    assert s1 != autotune.spec_signature(X_SHAPE, K_SHAPE, padding=1, bm=8)
    # a spectrum-pinned sweep must never answer for an unconstrained one
    assert s1 != autotune.spec_signature(X_SHAPE, K_SHAPE, padding=1,
                                         spectrum="complex")
    assert s1 != autotune.spec_signature(X_SHAPE, K_SHAPE, padding=1,
                                         dft_bt=16)
    # the mesh (by value), its axes and the kernel-transform placement
    for kw in (dict(data_axis="dp"), dict(model_axis="tp"),
               dict(replicate_kernel_transform=True),
               dict(overlap="auto")):
        assert s1 != autotune.spec_signature(X_SHAPE, K_SHAPE, padding=1,
                                             **kw)
    with _host_mesh() as mesh:
        s_mesh = autotune.spec_signature(X_SHAPE, K_SHAPE, padding=1,
                                         mesh=mesh)
        assert s_mesh != s1 and "|mesh=data:1,model:1;ranks[0];cpu|" \
            in s_mesh
        from repro_torch.launch import mesh as tmesh
        assert s_mesh == autotune.spec_signature(
            X_SHAPE, K_SHAPE, padding=1, mesh=tmesh.make_host_mesh(1, 1))


def test_corrupt_cache_file_is_tolerated(tune_env):
    tune_env.write_text("{not json!!")
    w = autotune.tune(X_SHAPE, K_SHAPE, padding=1)     # re-measures
    assert w.source == "measured"
    assert json.load(open(tune_env))["entries"]        # rewritten clean


def test_the_two_packages_keep_separate_caches(tune_env, jax_tune_env,
                                               monkeypatch):
    """Each tuner drops a file of another version, and would then
    overwrite it, so the port keeps its own file and env names: tuning
    with both packages leaves both files whole."""
    monkeypatch.delenv("REPRO_TORCH_AUTOTUNE_CACHE")
    monkeypatch.delenv("REPRO_AUTOTUNE_CACHE")
    assert autotune.cache_path() != jautotune.cache_path()
    assert os.path.basename(autotune.cache_path()) \
        == "repro_torch_autotune.json"
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tune_env))
    jpath = tune_env.with_name("jax.json")
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(jpath))
    jautotune.seed(X_SHAPE, K_SHAPE,
                   jautotune.TunedConfig("fft-xla", "local",
                                         source="seeded"), padding=(1, 1))
    autotune.tune(X_SHAPE, K_SHAPE, padding=1)
    assert json.load(open(jpath))["version"] == jautotune.CACHE_VERSION
    assert len(json.load(open(jpath))["entries"]) == 1
    assert json.load(open(tune_env))["version"] == autotune.CACHE_VERSION
    # a file of another version is not read (and the next write replaces
    # it): the port never takes the JAX package's winners for its own
    autotune.reset()
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(jpath))
    assert len(autotune._store()) == 0


# --------------------------------------------------------------------------
# Disabled / cold-cache fallback
# --------------------------------------------------------------------------

def test_disabled_falls_back_to_cost_model(tune_env, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE", "0")
    w = autotune.tune(X_SHAPE, K_SHAPE, padding=1)
    assert w.source == "cost-model" and w.us_per_call is None
    assert not os.path.exists(tune_env)     # fallbacks are never persisted
    assert autotune_info().fallbacks == 1

    # plan_conv(backend="tuned") resolves to exactly what "auto" picks
    p_tuned = plan_conv(X_SHAPE, K_SHAPE, padding=1, backend="tuned")
    p_auto = plan_conv(X_SHAPE, K_SHAPE, padding=1, backend="auto")
    assert (p_tuned.backend, p_tuned.schedule) \
        == (p_auto.backend, p_auto.schedule)
    x, k = _t(_rand(X_SHAPE)), _t(_rand(K_SHAPE, 1))
    np.testing.assert_allclose(p_tuned(x, k).numpy(), p_auto(x, k).numpy(),
                               rtol=0, atol=0)


def test_fallback_plan_is_not_frozen_in(tune_env, monkeypatch):
    """A cost-model fallback must not be memoized under the tuned key:
    once the tuning cache warms, the next plan adopts the winner."""
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE", "0")
    p_cold = plan_conv(X_SHAPE, K_SHAPE, padding=1, backend="tuned")
    assert p_cold.backend == "direct"          # cost-model pick
    autotune.seed(X_SHAPE, K_SHAPE,
                  TunedConfig("fft-torch", "local", source="seeded"),
                  padding=(1, 1))
    p_warm = plan_conv(X_SHAPE, K_SHAPE, padding=1, backend="tuned")
    assert p_warm.backend == "fft-torch"


def test_pinned_tune_does_not_poison_unpinned_cache(tune_env):
    """tune(bm=8) keys separately from tune(); plan-level pins overlay
    the unconstrained winner instead of constraining the sweep."""
    w_pinned = autotune.tune(X_SHAPE, K_SHAPE, padding=1, bm=8)
    w_free = autotune.tune(X_SHAPE, K_SHAPE, padding=1)
    assert autotune_info().misses == 2         # distinct cache entries
    assert w_pinned.source == w_free.source == "measured"
    assert autotune.cache_key(X_SHAPE, K_SHAPE, padding=(1, 1), bm=8) \
        != autotune.cache_key(X_SHAPE, K_SHAPE, padding=(1, 1))
    # the pinned sweep timed every candidate at the full row bm=8 names
    assert (w_pinned.bm, w_pinned.bn, w_pinned.bk) == SHAPES[2][:3]


def test_disabled_still_serves_warm_cache(tune_env, monkeypatch):
    w1 = autotune.tune(X_SHAPE, K_SHAPE, padding=1)
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE", "0")
    autotune.reset()
    w2 = autotune.tune(X_SHAPE, K_SHAPE, padding=1)
    assert w2 == w1 and autotune_info().hits == 1


@pytest.mark.parametrize("layer", TABLE1, ids=[l.name for l in TABLE1])
def test_cost_model_fallback_names_the_jax_backend(tune_env, jax_tune_env,
                                                   monkeypatch, layer):
    """With measurement disabled both tuners fall back to their cost
    model: the same backend (fft-xla <-> fft-torch) on every Table-I
    layer, at batch 32."""
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE", "0")
    monkeypatch.setenv("REPRO_AUTOTUNE", "0")
    x_shape = (32, layer.C, layer.H, layer.W)
    k_shape = (layer.Cout, layer.C, layer.kh, layer.kw)
    ours = autotune.tune(x_shape, k_shape, padding=layer.pad)
    theirs = jautotune.tune(x_shape, k_shape, padding=layer.pad)
    assert ours.source == theirs.source == "cost-model"
    assert ours.backend == {"direct": "direct",
                            "fft-xla": "fft-torch"}[theirs.backend]
    assert (ours.schedule, ours.spectrum) == (theirs.schedule,
                                              theirs.spectrum)


# --------------------------------------------------------------------------
# backend="tuned" through the planner
# --------------------------------------------------------------------------

def test_tuned_plan_resolves_and_matches_oracle(tune_env):
    plan = plan_conv(X_SHAPE, K_SHAPE, padding=1, backend="tuned")
    assert plan.backend in ("direct", "fft-torch", "fft-cuda")
    assert plan.schedule == "local"
    x, k = _t(_rand(X_SHAPE)), _t(_rand(K_SHAPE, 1))
    np.testing.assert_allclose(plan(x, k).numpy(),
                               conv2d_direct(x, k, padding=1).numpy(),
                               atol=2e-4)


@pytest.mark.parametrize("backend,jax_backend,spectrum", SEEDED)
def test_seeded_winner_matches_the_jax_tuned_plan(tune_env, jax_tune_env,
                                                  backend, jax_backend,
                                                  spectrum):
    """The same winner seeded into both tuners: the tuned plans resolve to
    the twin backends and agree within 1e-4 (bias+relu epilogue)."""
    blocks = SHAPES[4][:3] if backend == "fft-cuda" else (None,) * 3
    autotune.seed(X_SHAPE, K_SHAPE,
                  TunedConfig(backend, "local", *blocks, spectrum=spectrum,
                              source="seeded"), padding=(1, 1))
    jautotune.seed(X_SHAPE, K_SHAPE,
                   jautotune.TunedConfig(jax_backend, "local",
                                         spectrum=spectrum,
                                         source="seeded"), padding=(1, 1))
    ep = dict(bias=True, activation="relu")
    plan = plan_conv(X_SHAPE, K_SHAPE, padding=1, backend="tuned",
                     epilogue=Epilogue(**ep))
    jplan = jconv.plan_conv(X_SHAPE, K_SHAPE, padding=1, backend="tuned",
                            epilogue=jconv.Epilogue(**ep))
    assert (plan.backend, plan.spectrum) == (backend, spectrum)
    assert (jplan.backend, jplan.spectrum) == (jax_backend, spectrum)
    assert (plan.bm, plan.bn, plan.bk) == blocks
    x, k, b = _rand(X_SHAPE), _rand(K_SHAPE, 1), _rand((8,), 2)
    y = plan(_t(x), _t(k), bias=_t(b))
    yj = jplan(jnp.asarray(x), jnp.asarray(k), bias=jnp.asarray(b))
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), rtol=1e-4,
                               atol=1e-4)


def test_tuned_plan_carries_seeded_blocks(tune_env):
    autotune.seed(X_SHAPE, K_SHAPE,
                  TunedConfig("fft-cuda", "local", 16, 128, 16,
                              source="seeded"),
                  padding=(1, 1))
    plan = plan_conv(X_SHAPE, K_SHAPE, padding=1, backend="tuned")
    assert (plan.backend, plan.bm, plan.bn, plan.bk, plan.dft_bt) \
        == ("fft-cuda", 16, 128, 16, None)
    assert "blocks bm=16 bn=128 bk=16" in plan.describe()


def test_tuned_oversize_kernel_goes_direct(tune_env):
    plan = plan_conv((1, 2, 32, 32), (2, 2, 20, 20), backend="tuned")
    assert plan.backend == "direct"
    assert autotune_info() == (0, 0, 0, 0)     # no tuner involvement


def test_explicit_blocks_beat_tuned_blocks(tune_env):
    """An explicit pin replaces the tuned tile; since the knobs name one
    row of the kernel's table together, it replaces the whole row."""
    autotune.seed(X_SHAPE, K_SHAPE,
                  TunedConfig("fft-cuda", "local", 32, 128, 16,
                              source="seeded"),
                  padding=(1, 1))
    plan = plan_conv(X_SHAPE, K_SHAPE, padding=1, backend="tuned", bm=64)
    assert (plan.bm, plan.bn, plan.bk) == (64, 64, 16)
    plan = plan_conv(X_SHAPE, K_SHAPE, padding=1, backend="tuned")
    assert (plan.bm, plan.bn, plan.bk) == (32, 128, 16)


def test_tuned_plan_takes_a_dft_bt_pin(tune_env):
    """A seeded winner's dft_bt rides the tuned plan; an explicit pin
    beats it (field by field: the tuned tile stays); a pinned sweep times
    every candidate at the pin, under a key of its own; a value the
    inverse was not compiled at is the resolver's ValueError."""
    autotune.seed(X_SHAPE, K_SHAPE,
                  TunedConfig("fft-cuda", "local", *SHAPES[4][:3],
                              dft_bt=4, source="seeded"), padding=(1, 1))
    plan = plan_conv(X_SHAPE, K_SHAPE, padding=1, backend="tuned")
    assert (plan.backend, plan.dft_bt) == ("fft-cuda", 4)
    pinned = plan_conv(X_SHAPE, K_SHAPE, padding=1, backend="tuned",
                       dft_bt=16)
    assert (pinned.dft_bt, pinned.bm) == (16, SHAPES[4][0])
    w = autotune.tune(X_SHAPE, K_SHAPE, padding=1, dft_bt=16, budget=1e9)
    assert w.source == "measured" and w.dft_bt == 16
    (sweep,) = autotune.sweeps()
    assert {c.dft_bt for c in sweep["measured"]} == {16}
    for bad, match in ((64, r"\(4, 8, 16\)"), (0, "positive int")):
        with pytest.raises(ValueError, match=match):
            plan_conv(X_SHAPE, K_SHAPE, padding=1, backend="tuned",
                      dft_bt=bad)
        with pytest.raises(ValueError, match=match):
            autotune.tune(X_SHAPE, K_SHAPE, padding=1, dft_bt=bad)


# --------------------------------------------------------------------------
# dft_bt: the inverse tile DFT's tiles a block, pinned into the kernel
# --------------------------------------------------------------------------

def test_resolve_tiles_defaults_and_validation():
    """Twin of the reference's resolve_bt test: None is the kernel's
    default, a compiled value is taken verbatim, and a bool, a non-int or
    a value <= 0 is the reference's "positive int" ValueError; a positive
    int the kernel was not compiled at lists the compiled values."""
    from repro.kernels.dft_tile import resolve_bt
    from repro_torch.kernels.dft_tile import (
        DEFAULT_TILES, INVERSE_TILES, resolve_tiles)
    assert INVERSE_TILES == (4, 8, 16) and DEFAULT_TILES == 8
    assert resolve_tiles(None) == resolve_tiles() == DEFAULT_TILES
    for t in INVERSE_TILES:
        assert resolve_tiles(t) == t
    for bad in (0, -1, True, 1.5):
        with pytest.raises(ValueError, match="positive int") as ours:
            resolve_tiles(bad)
        with pytest.raises(ValueError) as theirs:
            resolve_bt(100, bad)
        assert str(ours.value) == str(theirs.value)
    for bad in (2, 32, 64):
        with pytest.raises(ValueError, match=r"\(4, 8, 16\)"):
            resolve_tiles(bad)


@pytest.mark.parametrize("residual", [False, True],
                         ids=["fused", "residual"])
def test_plan_dft_bt_reaches_fused_inverse(tune_env, monkeypatch, residual):
    """A plan's dft_bt reaches the inverse it launches: the fused tail
    (tile_irfft_epilogue) and, with a residual, the plain inverse
    (tile_irfft) before the stage-level epilogue.  On the CPU the
    wrappers run their plain versions, which take the value and ignore
    it."""
    from repro_torch.kernels import dft_tile as dft_pkg
    seen = []

    def spy(name):
        real = getattr(dft_pkg, name)

        def call(*args, **kw):
            seen.append((name, kw.get("tiles")))
            return real(*args, **kw)
        monkeypatch.setattr(dft_pkg, name, call)
    spy("tile_irfft_epilogue_cuda")
    spy("tile_irfft_cuda")
    ep = Epilogue(bias=True, activation="relu", residual=residual)
    plan = plan_conv(X_SHAPE, K_SHAPE, padding=1, backend="fft-cuda",
                     dft_bt=16, cache=False, epilogue=ep)
    kw = dict(bias=_t(_rand((K_SHAPE[0],), 2)))
    if residual:
        kw["residual"] = _t(_rand(plan.out_shape, 3))
    plan(_t(_rand(X_SHAPE)), _t(_rand(K_SHAPE, 1)), **kw)
    want = "tile_irfft_cuda" if residual else "tile_irfft_epilogue_cuda"
    assert seen == [(want, 16)]


def test_block_overrides_keep_numerics(jax_tune_env):
    """A pinned tile row and dft_bt change how the kernels run, not what
    they compute: the plan matches the unpinned one, and the JAX
    package's fft-pallas plan with the same pins."""
    clear_plan_cache()
    x, k = _rand(X_SHAPE), _rand(K_SHAPE, 1)
    base = plan_conv(X_SHAPE, K_SHAPE, padding=1, backend="fft-cuda",
                     cache=False)(_t(x), _t(k))
    odd = plan_conv(X_SHAPE, K_SHAPE, padding=1, backend="fft-cuda",
                    bm=8, dft_bt=16, cache=False)(_t(x), _t(k))
    np.testing.assert_allclose(base.numpy(), odd.numpy(), atol=1e-4)
    jodd = jconv.plan_conv(X_SHAPE, K_SHAPE, padding=1,
                           backend="fft-pallas", bm=8, bn=8, bk=8,
                           dft_bt=16, cache=False)(jnp.asarray(x),
                                                   jnp.asarray(k))
    np.testing.assert_allclose(odd.numpy(), np.asarray(jodd), atol=1e-4)


# --------------------------------------------------------------------------
# Candidate generation
# --------------------------------------------------------------------------

def test_candidates_cover_the_space_and_order_cheap_first(tune_env):
    spec = autotune._make_spec(X_SHAPE, K_SHAPE, (1, 1), 16)
    local = autotune.candidates(spec)
    assert all(c.schedule == "local" and c.overlap == "off" for c in local)
    assert {c.backend for c in local} == {"direct", "fft-torch", "fft-cuda"}
    assert local[0].backend == "direct"        # the cost model's pick
    kinds = [c.backend == "fft-cuda" for c in local]
    assert kinds == sorted(kinds)              # fft-cuda last
    assert any(c.bm for c in local)            # the CGEMM tile is an axis
    assert any(c.dft_bt for c in local)        # dft_tile tile is an axis
    assert {c.dft_bt for c in local} == {None, autotune.DFT_BT_ALT}

    pinned = autotune.candidates(spec, bm=8)
    assert all((c.bm, c.bn, c.bk) == SHAPES[2][:3] for c in pinned)
    # real at dft_bt None and the alternative, complex at None
    assert len([c for c in pinned if c.backend == "fft-cuda"]) == 3
    with pytest.raises(ValueError, match="tile table"):
        autotune.candidates(spec, bm=12)
    # a dft_bt pin merges field by field: every tile variant stays
    bt = autotune.candidates(spec, dft_bt=4)
    assert {c.dft_bt for c in bt} == {4}
    assert [c.bm for c in bt if (c.backend, c.spectrum)
            == ("fft-cuda", "real")] == [c.bm for c in local if (
                c.backend, c.spectrum, c.dft_bt) == ("fft-cuda", "real",
                                                     None)]
    with pytest.raises(ValueError, match=r"\(4, 8, 16\)"):
        autotune.candidates(spec, dft_bt=64)

    # the sharded half: on a (1, 1) gloo mesh, nfft and wfft, no direct,
    # fft-torch on nfft first (the cost model's pick), fft-cuda last
    with _host_mesh() as mesh:
        sharded = autotune.candidates(spec, mesh=mesh)
        assert {c.schedule for c in sharded} == {"nfft", "wfft"}
        assert "direct" not in {c.backend for c in sharded}
        assert (sharded[0].backend, sharded[0].schedule) \
            == ("fft-torch", "nfft")
        kinds = [c.backend == "fft-cuda" for c in sharded]
        assert kinds == sorted(kinds)
        assert {c.dft_bt for c in sharded} == {None}
        assert {c.overlap for c in sharded} == {"off"}
        overlapped = autotune.candidates(spec, mesh=mesh, overlap="auto")
        assert {c.overlap for c in overlapped} \
            == {"off", "slab:2", "slab:4"}
        # overlapped fft-cuda is timed at its unpinned tile only
        assert {c.bm for c in overlapped if c.backend == "fft-cuda"
                and c.overlap != "off"} == {None}
        wfft = autotune.candidates(spec, schedule="wfft", mesh=mesh)
        assert {c.schedule for c in wfft} == {"wfft"}
        assert 2 * len(wfft) == len(sharded)


def test_candidates_spectrum_axis(tune_env):
    spec = autotune._make_spec(X_SHAPE, K_SHAPE, (1, 1), 16)
    local = autotune.candidates(spec)
    for be in ("fft-torch", "fft-cuda"):
        assert {c.spectrum for c in local if c.backend == be} \
            == {"real", "complex"}
    assert all(c.spectrum == "real" for c in local if c.backend == "direct")
    assert local[0].spectrum == "real"         # cost-model pick stays first
    # complex fft-cuda is timed at its unpinned tile only
    assert [c.bm for c in local
            if (c.backend, c.spectrum) == ("fft-cuda", "complex")] == [None]
    pinned = autotune.candidates(spec, spectrum="complex")
    assert {c.spectrum for c in pinned} == {"complex"}
    assert "direct" not in {c.backend for c in pinned}


@pytest.mark.parametrize("M,rows", [
    (4, [None, 8]), (8, [None, 4, 16]), (16, [None, 8, 32]),
    (32, [None, 16, 64]), (64, [None, 32]), (1024, [None, 32])])
def test_candidate_rows_neighbour_the_chooser(tune_env, M, rows):
    """fft-cuda real is timed at its unpinned tile and at the full table
    rows whose bm is next smaller and next larger than the chooser's
    row for this M."""
    spec = autotune._make_spec((M, 4, 14, 14), K_SHAPE, (1, 1), 16)
    assert spec.M == M                         # one tile per image
    cands = [c for c in autotune.candidates(spec)
             if (c.backend, c.spectrum) == ("fft-cuda", "real")]
    # each row at dft_bt None, then at the alternative
    assert [c.bm for c in cands] == [bm for bm in rows for _ in range(2)]
    assert [c.dft_bt for c in cands] \
        == [None, autotune.DFT_BT_ALT] * len(rows)
    for c in cands[2:]:
        assert (c.bm, c.bn, c.bk) in [tuple(r[:3]) for r in SHAPES]


# --------------------------------------------------------------------------
# Measuring: device, refusals, kernel errors
# --------------------------------------------------------------------------

def test_tune_on_the_cpu_returns_a_measured_winner(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE",
                       str(tmp_path / "t.json"))
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_REPS", "1")
    autotune.reset()
    try:
        w = autotune.tune(X_SHAPE, K_SHAPE, padding=1, device="cpu")
        assert w.source == "measured" and w.us_per_call > 0
        assert autotune.lookup(X_SHAPE, K_SHAPE, padding=(1, 1),
                               device="cpu") == w
    finally:
        autotune.reset()


def test_tune_without_a_gpu_or_a_device_raises(tmp_path, monkeypatch):
    """The tuner measures on the GPU unless asked for the CPU."""
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE",
                       str(tmp_path / "t.json"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        autotune.tune(X_SHAPE, K_SHAPE, padding=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        plan_conv(X_SHAPE, K_SHAPE, padding=1, backend="tuned", cache=False)


def test_a_kernel_error_propagates(tune_env, monkeypatch):
    """A candidate whose kernel raises is not skipped: tune raises, so a
    broken fft-cuda cannot quietly lose to direct."""
    from repro_torch.kernels import cgemm

    def broken(*args, **kwargs):
        raise RuntimeError("cgemm kernel launch failed (test)")

    monkeypatch.setattr(cgemm, "cgemm_cuda", broken)
    with pytest.raises(RuntimeError, match="launch failed"):
        autotune.tune(X_SHAPE, K_SHAPE, padding=1, budget=1e9)
    assert not os.path.exists(tune_env)        # nothing was persisted


def test_a_planner_refusal_is_skipped(tune_env):
    """fft-cuda refuses delta 48 when the plan is made: its candidates are
    skipped, and the sweep crowns one of the others."""
    spec = autotune._make_spec((1, 4, 40, 40), K_SHAPE, (1, 1), 48)
    assert any(c.backend == "fft-cuda" for c in autotune.candidates(spec))
    w = autotune.tune((1, 4, 40, 40), K_SHAPE, padding=1, delta=48,
                      budget=1e9)
    assert w.source == "measured" and w.backend in ("direct", "fft-torch")


def test_no_measurement_inside_a_graph_capture(tune_env, monkeypatch):
    """A measurement synchronizes, which a CUDA graph capture forbids:
    tuning that would start one during a capture raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    with pytest.raises(RuntimeError, match="capture"):
        autotune.tune(X_SHAPE, K_SHAPE, padding=1)
    assert autotune_info().measured == 0


def test_measure_us_times_the_calls(tune_env):
    calls = []
    us = autotune.measure_us(lambda x: calls.append(x), _t(_rand((2,))),
                             reps=3)
    assert len(calls) == 4 and us >= 0         # one warm-up, three timed


def test_a_sweep_draws_its_inputs_once(tune_env, monkeypatch):
    """Every candidate of a sweep times the same x, k and bias, drawn once
    before the budget's clock starts (drawing a 224x224 input took most
    of a layer's budget on the card's host); none is kept after it."""
    seen, draws = [], []
    real_measure, real_rng = autotune._measure_plan, np.random.default_rng

    def measure(plan, reps, device):
        seen.append(autotune._inputs(plan.x_shape, plan.k_shape, device))
        return real_measure(plan, reps, device)

    def rng(*a):
        draws.append(a)
        return real_rng(*a)

    monkeypatch.setattr(autotune, "_measure_plan", measure)
    monkeypatch.setattr(np.random, "default_rng", rng)
    autotune.tune(X_SHAPE, K_SHAPE, padding=1, budget=1e9)
    assert len(seen) == autotune.sweeps()[-1]["candidates"] > 1
    assert len(draws) == 1
    assert all(all(a is b for a, b in zip(s, seen[0])) for s in seen)
    assert autotune._drawn == {}


def test_selfcheck_round_trips_on_the_cpu(tune_env, capsys):
    assert autotune.main(["--selfcheck", "--device", "cpu"]) == 0
    assert "selfcheck OK" in capsys.readouterr().out


# --------------------------------------------------------------------------
# Network sweep
# --------------------------------------------------------------------------

def test_plan_network_tuned_sweep_and_report(tune_env):
    layers = [
        NetworkConv("c1", X_SHAPE, K_SHAPE, padding=1),
        NetworkConv("c2", X_SHAPE, K_SHAPE, padding=1),   # same geometry
    ]
    net = plan_network(layers, backend="tuned")
    # one sweep: the duplicate geometry was tuned once, not twice
    assert autotune_info().misses == 1
    rep = net.tuning_report()
    assert set(rep) == {"c1", "c2"}
    for r in rep.values():
        assert r["source"] == "measured"
        assert r["us_per_call"] > 0
        assert r["backend"] in ("direct", "fft-torch", "fft-cuda")
    # a plan that was not tuned reports no timing
    plain = plan_network(layers, backend="fft-cuda")
    assert {r["source"] for r in plain.tuning_report().values()} \
        == {"unmeasured"}


def test_plan_network_buckets_tune_each_geometry_once(tune_env):
    def make_layers(batch):
        return [NetworkConv("c1", (batch,) + X_SHAPE[1:], K_SHAPE, 1),
                NetworkConv("c2", (batch,) + X_SHAPE[1:], K_SHAPE, 1)]
    nets = plan_network(make_layers, buckets=(1, 2), backend="tuned")
    info = autotune_info()
    assert (info.misses, info.measured) == (2, 2)
    for net in nets.values():
        assert {r["source"] for r in net.tuning_report().values()} \
            == {"measured"}
    plan_network(make_layers, buckets=(1, 2), backend="tuned")
    assert autotune_info().misses == 2         # all hits the second time
