"""The checks of chip_smoke.py that need no card, on the CPU: the training
step through recorded branches (the float64 reference its grads are held
to), the flip count, the forced generic forms, the launch counts that
refuse a generic-form launch, forward or inverse, on a main path, and
phase ``sharded``'s expected launches and collectives and its refusals
(a rehearsal of its forward on a one-rank gloo mesh), phase
``sharded_train``'s (a rehearsal of its training step there), phase
``sharded_serve``'s (the engine over that mesh: its launches and
collectives per pass and per batch, its result checks), and phase
``entry_points``'s (the shim's stage ops against its plan's, the example
twins' checks)."""
import collections
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

from repro_torch.kernels.dft_tile import ops as dft_ops  # noqa: E402

# a narrow trunk with the served trunk's layer names, so that its pools
# fall where serve's do (after Vconv1.2 and Vconv2.2)
Layer = collections.namedtuple("Layer", "name padding")
LAYERS = [Layer("Vconv1.1", 1), Layer("Vconv1.2", 1), Layer("Vconv2.1", 1),
          Layer("Vconv2.2", 1)]
CHANNELS = [3, 4, 4, 6, 6]


def _trunk(dtype, seed=0):
    """Weights, biases, input and loss weights of the narrow trunk on the
    CPU, made from a seed with numpy."""
    rng = np.random.default_rng(seed)

    def init(shape, s=0.3):
        return torch.as_tensor(s * rng.standard_normal(shape), dtype=dtype)
    kernels = {l.name: init((CHANNELS[i + 1], CHANNELS[i], 3, 3))
               for i, l in enumerate(LAYERS)}
    biases = {l.name: init((CHANNELS[i + 1],), 0.1)
              for i, l in enumerate(LAYERS)}
    x = init((2, 3, 16, 16), 1.0)
    r = init((2, CHANNELS[-1], 4, 4), 1.0)
    return kernels, biases, x, r


def _step(loss_fn, kernels, biases, dtype, **kw):
    ks = {n: k.to(dtype).requires_grad_() for n, k in kernels.items()}
    bs = {n: b.to(dtype).requires_grad_() for n, b in biases.items()}
    params = [ks[l.name] for l in LAYERS] + [bs[l.name] for l in LAYERS]
    loss = loss_fn(LAYERS, kernels=ks, biases=bs, **kw)
    return loss, torch.autograd.grad(loss, params)


def test_branch_loss_reproduces_the_step_it_follows():
    """On direct in float64, the step that takes recorded branches gives
    the recorded step's loss and grads."""
    kernels, biases, x, r = _trunk(torch.float64)
    branches = []
    loss, grads = _step(smoke.vgg_train_loss, kernels, biases, torch.float64,
                        backend="direct", x=x, r=r, branches=branches)
    assert len(branches) == len(LAYERS) + 2     # 4 ReLU masks, 2 pools
    loss_b, grads_b = _step(smoke.vgg_branch_loss, kernels, biases,
                            torch.float64, x=x, r=r, branches=branches)
    assert abs(loss_b.item() - loss.item()) <= 1e-12 * abs(loss.item())
    for g, gb in zip(grads, grads_b):
        assert torch.allclose(g, gb, rtol=0, atol=1e-12)


def test_fft_cuda_step_meets_the_smoke_gates():
    """The training-step gates of chip_smoke.py at a small size on the
    CPU: fft-cuda's float32 grads (kernels' plain versions) within
    GRAD_TOL of float64 direct through the same branches, and at most
    FLIP_LIMIT choices unlike float64's own."""
    kernels, biases, x, r = _trunk(torch.float32)
    branches, branches64 = [], []
    _, grads = _step(smoke.vgg_train_loss, kernels, biases, torch.float32,
                     backend="fft-cuda", x=x, r=r, branches=branches)
    _, grads64 = _step(smoke.vgg_branch_loss, kernels, biases,
                       torch.float64, x=x.double(), r=r.double(),
                       branches=branches)
    _step(smoke.vgg_train_loss, kernels, biases, torch.float64,
          backend="direct", x=x.double(), r=r.double(), branches=branches64)
    errs = smoke.rel_errs(LAYERS, grads, grads64)
    assert len(errs) == 2 * len(LAYERS)
    assert max(errs.values()) <= smoke.GRAD_TOL
    assert sum(smoke.flip_counts(branches, branches64)) <= smoke.FLIP_LIMIT


def test_flip_counts():
    a = [torch.tensor([True, False, True]), torch.tensor([[0, 1], [2, 3]])]
    b = [torch.tensor([True, True, False]), torch.tensor([[0, 1], [3, 3]])]
    assert smoke.flip_counts(a, b) == [2, 1]
    assert smoke.flip_counts(a, a) == [0, 0]


def test_forced_generic_form_restores_the_chooser():
    """Both choosers, forward and inverse, give the generic form within
    the block and are themselves again after it."""
    chooser = dft_ops.choose_form
    inverse_chooser = dft_ops.choose_inverse_form
    assert chooser(16, 0) == dft_ops.SPECIALISED
    assert inverse_chooser(16, (0, 0, 0), 130) == dft_ops.SPECIALISED
    with smoke.forced_generic_form():
        assert dft_ops.choose_form(16, 0) == dft_ops.GENERIC
        assert dft_ops.choose_inverse_form(16, (0, 0, 0),
                                           130) == dft_ops.GENERIC
    assert dft_ops.choose_form is chooser
    assert dft_ops.choose_inverse_form is inverse_chooser


def test_expect_counts_refuses_a_generic_launch():
    """Every main path's forward launches must take the specialised form:
    a count of generic launches is a launch nobody asked for."""
    smoke.zero_counts()
    counts = smoke.read_counts()
    assert counts["tile_rfft generic"] == counts["tile_fft generic"] == 0
    smoke.expect_counts("path", counts, {})
    counts["tile_rfft"] = counts["tile_rfft generic"] = 1
    with pytest.raises(AssertionError, match="tile_rfft generic"):
        smoke.expect_counts("path", counts, {"tile_rfft": 1})


@pytest.mark.parametrize("kernel", ["tile_irfft_epilogue", "tile_irfft",
                                    "tile_ifft", "tile_ifft_epilogue"])
def test_expect_counts_refuses_a_generic_inverse_launch(kernel):
    """The inverse wrappers count by form too: a main path whose inverse
    launched the generic form fails its launch check, and the counts
    start from 0 for every form."""
    smoke.zero_counts()
    counts = smoke.read_counts()
    assert counts[f"{kernel} generic"] == 0
    assert smoke.FORMS[kernel].form_launches == {"generic": 0,
                                                 "specialised": 0}
    counts[kernel] = counts[f"{kernel} generic"] = 1
    with pytest.raises(AssertionError, match=f"{kernel} generic"):
        smoke.expect_counts("path", counts, {kernel: 1})
    counts[f"{kernel} generic"] = 0
    smoke.expect_counts("path", counts, {kernel: 1})


def test_serve_checks_hold_a_request_to_eager_and_direct():
    """``serve_checks`` of phase ``serve_trace`` on a host engine: a
    request's rows pass against the eager forward of its bucket and
    against direct, and a result that is off by more than ``GRAPH_TOL``
    is refused."""
    import types

    from repro_torch.conv import Epilogue, NetworkConv
    from repro_torch.launch import batcher

    ep = Epilogue(bias=True, activation="relu")

    def make_layers(batch):
        return [NetworkConv("a", (batch, 3, 16, 16), (4, 3, 3, 3),
                            padding=1, epilogue=ep)]
    rng = np.random.default_rng(0)
    kernels = {"a": torch.as_tensor(rng.standard_normal((4, 3, 3, 3)),
                                    dtype=torch.float32)}
    bias = torch.as_tensor(rng.standard_normal(4), dtype=torch.float32)

    def forward(prepared, x):
        return prepared["a"](x, bias=bias)
    eng = batcher.ServeEngine(make_layers, kernels,
                              policy=batcher.BucketPolicy(max_batch=4),
                              forward=forward, backend="fft-cuda",
                              device="cpu")
    xs = [torch.as_tensor(rng.standard_normal((b, 3, 16, 16)),
                          dtype=torch.float32) for b in (1, 2)]
    rids = [eng.submit(x) for x in xs]
    eng.drain(force=True)                       # one b4 batch, rows 0 and 1
    res = types.SimpleNamespace(make_layers=make_layers, forward=forward)
    out = smoke.serve_checks(eng, res, rids[1], xs[1], kernels)
    assert (out["bucket"], out["rows"], out["offset"]) == ("b4", 2, 1)
    assert out["rel_err_vs_eager"] <= smoke.GRAPH_TOL
    assert out["rel_err_vs_cudnn"] <= smoke.SLICE_TOL
    eng.results[rids[0]] = eng.results[rids[0]] * (1 + 1e-3)
    with pytest.raises(AssertionError, match="not within"):
        smoke.serve_checks(eng, res, rids[0], xs[0], kernels)


# --------------------------------------------------------------------------
# Phase tune: its gates, fed fake counts (on the CPU nothing launches)
# --------------------------------------------------------------------------

def _served_specs():
    from repro_torch.configs.paper_convs import network_convs
    from repro_torch.conv import plan_network
    from repro_torch.launch import serve
    net = plan_network(network_convs(serve._vgg_scale(224), 4),
                       backend="fft-cuda")
    return [p.spec for p in net.plans.values()]


def test_tune_sweep_launches_count_every_fft_cuda_candidate():
    """On the served trunk the sweep times 5 fft-cuda candidates a layer
    (unpinned real and one or two neighbouring rows, each at dft_bt None
    and the alternative; complex), except the layers whose chooser row has
    one neighbour: 5 (M = 1024, 256, 64, 4) or 7 (M = 16).  Each is a
    warm-up and ``reps`` calls; the fused inverse runs half the real
    ones' calls at each dft_bt."""
    specs = _served_specs()
    counts, tiles = smoke.tune_sweep_launches(specs, 3)
    n_cands = [5, 5, 5, 5, 5, 5, 7, 7, 5]
    assert [s.M for s in specs] == [1024, 1024, 256, 256, 64, 64, 16, 16, 4]
    assert counts["cgemm"] == 4 * sum(n_cands)
    assert counts["tile_irfft_epilogue"] == 4 * (sum(n_cands) - 9)
    assert counts["tile_rfft"] == 2 * counts["tile_irfft_epilogue"]
    assert sum(tiles.values()) == counts["cgemm"]
    # the pinned rows: small-32 next to the large tile, 8 and 32 next to
    # small-16, 8 next to small-4; each at two dft_bt values
    assert tiles["small-32x128"] == 4 * 2 * (6 + 2)
    assert tiles["small-8x128"] == 4 * 2 * (2 + 1)
    assert tiles["large-64x64"] == 4 * 3 * 6   # unpinned real x 2, complex
    from repro_torch.conv import autotune
    bts = smoke.inverse_tiles_launches(
        [c for spec in specs for c in autotune.candidates(spec)], 4)
    want = {4: 0, 8: 0, 16: 0}
    want[8] = want[autotune.DFT_BT_ALT] = counts["tile_irfft_epilogue"] // 2
    assert bts == want


def _info(hits, misses, fallbacks, measured):
    from repro_torch.conv.autotune import AutotuneInfo
    return AutotuneInfo(hits, misses, fallbacks, measured)


def test_check_tune_sweep_wants_every_candidate_measured():
    specs = _served_specs()
    want, want_tiles = smoke.tune_sweep_launches(specs, 3)
    smoke.zero_counts()
    got = {**smoke.read_counts(), **want}
    smoke.check_tune_sweep(_info(0, 9, 0, 9), 9, got, want,
                           dict(want_tiles), want_tiles)
    # a layer that stopped at its budget before a pinned row
    short = dict(want_tiles, **{"small-32x128":
                                want_tiles["small-32x128"] - 4})
    with pytest.raises(AssertionError, match="unmeasured"):
        smoke.check_tune_sweep(_info(0, 9, 0, 9), 9, got, want, short,
                               want_tiles)
    fewer = dict(got, cgemm=got["cgemm"] - 4)
    with pytest.raises(AssertionError, match="tune sweep: launches"):
        smoke.check_tune_sweep(_info(0, 9, 0, 9), 9, fewer, want,
                               want_tiles, want_tiles)
    # a warm cache measures nothing: the sweep must miss on every layer
    with pytest.raises(AssertionError, match="9 misses"):
        smoke.check_tune_sweep(_info(1, 8, 0, 8), 9, got, want,
                               want_tiles, want_tiles)


def test_check_pinned_rows_wants_the_pinned_row_launched():
    """A tuned forward whose Vconv4.1 won the small-32 row must launch
    small-32 there, not the chooser's small-16."""
    import dataclasses
    from repro_torch.conv import plan_conv
    specs = _served_specs()
    plans = [plan_conv(s, backend="direct") for s in specs[:6]]
    plans.append(plan_conv(specs[6], backend="fft-cuda", bm=32))
    plans.append(plan_conv(specs[7], backend="fft-cuda"))
    plans.append(dataclasses.replace(
        plan_conv(specs[8], backend="fft-cuda"), spectrum="complex"))
    counts, tiles = smoke.tuned_forward_launches(plans, 10, 1)
    assert counts == {"cgemm": 30, "tile_rfft": 22,
                      "tile_irfft_epilogue": 20}
    assert tiles == {"small-32x128": 10, "small-16x128": 10,
                     "small-4x128": 10}
    smoke.check_pinned_rows(plans, dict(tiles), tiles)
    chooser = {"small-16x128": 20, "small-4x128": 10}
    with pytest.raises(AssertionError, match=r"pinned rows \(M, bm\): "
                                             r"\[\(16, 32\)\]"):
        smoke.check_pinned_rows(plans, chooser, tiles)


def test_tiles_of_merges_the_load_forms():
    from repro_torch.kernels.cgemm import cgemm_cuda
    launches = dict.fromkeys(cgemm_cuda.variant_launches, 0)
    launches.update({"large-64x64": 5, "large-64x64-scalar": 1,
                     "small-4x128": 2})
    assert smoke.tiles_of(launches) == {"large-64x64": 6, "small-4x128": 2}
    smoke.zero_counts()
    assert not any(cgemm_cuda.variant_launches.values())


def test_check_tune_round_trip():
    winners = {"a": ("fft-cuda", "real", 32, 128, 16),
               "b": ("direct", "real", None, None, None)}
    version = smoke.autotune.CACHE_VERSION
    smoke.check_tune_round_trip(_info(2, 0, 0, 0), 2, winners,
                                dict(winners), version)
    for info, again, v in (
            (_info(1, 1, 0, 1), winners, version),     # one re-measured
            (_info(2, 0, 0, 0), {**winners, "a": ("direct", "real", None,
                                                  None, None)}, version),
            (_info(2, 0, 0, 0), winners, version + 1)):
        with pytest.raises(AssertionError, match="tune round trip"):
            smoke.check_tune_round_trip(info, 2, winners, again, v)


def test_sharded_launch_and_collective_arithmetic():
    assert smoke.sharded_launches(9, 2, 1, 0) == {
        "tile_rfft": 18, "cgemm": 18, "tile_irfft_epilogue": 18}
    assert smoke.sharded_launches(9, 1, 10, 1) == {
        "tile_rfft": 99, "cgemm": 90, "tile_irfft_epilogue": 90}
    assert smoke.sharded_launches(1, 2, 1, 0, one_shot=True) == {
        "tile_rfft": 3, "cgemm": 2, "tile_irfft_epilogue": 2}
    assert smoke.sharded_collectives("nfft", 2) == {"all_to_all": 4,
                                                    "all_reduce": 0}
    assert smoke.sharded_collectives("nfft", 1, one_shot=True) == {
        "all_to_all": 3, "all_reduce": 0}
    assert smoke.sharded_collectives("nfft", 2, one_shot=True,
                                     replicate=True)["all_to_all"] == 4
    assert smoke.sharded_collectives("wfft", 2) == {"all_to_all": 0,
                                                    "all_reduce": 2}


def _trace(a2a, ar, boundary=None):
    return collections.Counter({
        ("collective", "all_to_all"): a2a, ("collective", "all_reduce"): ar,
        "boundary_a2a": a2a if boundary is None else boundary})


def test_check_collectives_refuses_a_wrong_count():
    want = smoke.sharded_collectives("nfft", 2)
    assert smoke.check_collectives("t", _trace(36, 0), want, 9, 1) == {
        "all_to_all": 36, "all_reduce": 0}
    for trace in (_trace(35, 0), _trace(36, 1), _trace(36, 0, 35)):
        with pytest.raises(AssertionError, match="collectives"):
            smoke.check_collectives("t", trace, want, 9, 1)
    with pytest.raises(AssertionError, match="collectives"):
        smoke.check_collectives("t", _trace(1, 18),
                                smoke.sharded_collectives("wfft", 2), 9, 1)


def test_check_one_row_refuses_two_rows_across_slabs():
    smoke.check_one_row("t", {"a": {"small-8x128": 2},
                              "b": {"large-64x64": 1,
                                    "large-64x64-scalar": 1}}, 2)
    for bad in ({"small-8x128": 1, "small-16x128": 1},   # two rows
                {"small-8x128": 3}):                      # a slab too many
        with pytest.raises(AssertionError, match="one tile row"):
            smoke.check_one_row("t", {"a": bad}, 2)


def test_sharded_expect_counts_refuses_a_generic_launch():
    counts = smoke.read_counts()
    counts.update(smoke.sharded_launches(9, 2, 1, 0))
    smoke.expect_counts("sharded", counts, smoke.sharded_launches(9, 2, 1,
                                                                  0))
    counts["tile_irfft_epilogue generic"] = 1
    with pytest.raises(AssertionError, match="generic"):
        smoke.expect_counts("sharded", counts,
                            smoke.sharded_launches(9, 2, 1, 0))


@pytest.mark.parametrize("schedule", ["nfft", "wfft"])
def test_sharded_forward_rehearsal_on_a_host_mesh(schedule):
    """The phase's forward and collective gate on a one-rank gloo mesh at
    narrow widths: the DTensor chain through the pools equals the local
    trunk, and the collectives are exactly the expected ones."""
    from repro_torch.conv import Epilogue, NetworkConv, plan_network, stages
    from repro_torch.launch import mesh as tmesh
    kernels, biases, x, _ = _trunk(torch.float32)
    convs = [NetworkConv(l.name, (2, CHANNELS[i], 16 >> (i // 2),
                                  16 >> (i // 2)),
                         (CHANNELS[i + 1], CHANNELS[i], 3, 3), padding=1,
                         epilogue=Epilogue(bias=True, activation="relu"))
             for i, l in enumerate(LAYERS)]
    tmesh.start_process_group("gloo")
    try:
        mesh = tmesh.make_host_mesh(1, 1)
        net = plan_network(convs, backend="fft-cuda", mesh=mesh,
                           schedule=schedule, overlap="slab:2")
        with torch.inference_mode():
            prepared = net.prepare(kernels)
            with stages.stage_trace() as trace:
                y = smoke.sharded_forward(prepared, x, biases, {})
            local = plan_network(convs, backend="fft-cuda").prepare(kernels)
            y_local = smoke.sharded_forward(local, x, biases)
            got = smoke.check_collectives(
                "rehearsal", trace, smoke.sharded_collectives(schedule, 2),
                len(convs), 1)
            assert sum(got.values()) == len(convs) * (
                4 if schedule == "nfft" else 2)
            assert smoke.rel_err(y.full_tensor(), y_local) <= \
                smoke.GRAPH_TOL
    finally:
        tmesh.destroy_process_group()


def test_slab_cgemm_cases_are_the_sharded_forwards_cgemms(monkeypatch):
    """The CGEMM cases the phase holds against the plain version before
    the trunks are the (P, M, C, N) and tile rows that the sharded
    forwards of ``SHARDED`` give the CGEMM, slab by slab (a one-rank gloo
    mesh at narrow widths)."""
    import repro_torch.kernels.cgemm as cgemm_pkg
    from repro_torch.conv import (
        Epilogue, NetworkConv, clear_plan_cache, clear_prepared_cache,
        plan_network)
    from repro_torch.kernels.cgemm.ops import choose_variant
    from repro_torch.launch import mesh as tmesh

    def case(P, M, C, N, row):
        return (P, M, C, N,
                choose_variant(P, M, C, N, torch.float32, True, row).name)

    launched, held = set(), set()
    real = cgemm_pkg.cgemm_cuda

    def recording(Dr, Di, Gr, Gi, *, three_m=True, shape=None):
        launched.add(case(*Dr.shape, Gr.shape[2], shape))
        return real(Dr, Di, Gr, Gi, three_m=three_m, shape=shape)
    monkeypatch.setattr(cgemm_pkg, "cgemm_cuda", recording)
    monkeypatch.setattr(smoke, "cgemm_row", lambda name, P, M, C, N, dtype,
                        three_m, spectrum, gen, shape=None, **extra:
                        held.add(case(P, M, C, N, shape)))
    kernels, biases, x, r = _trunk(torch.float32)
    x, r = torch.cat([x, x]), torch.cat([r, r])  # batch 4: slabs of 2
    convs = _convs(4)
    tmesh.start_process_group("gloo")
    try:
        clear_plan_cache()
        clear_prepared_cache()
        mesh = tmesh.make_host_mesh(1, 1)
        with torch.inference_mode():
            for schedule, overlap in smoke.SHARDED:
                net = plan_network(convs, backend="fft-cuda", mesh=mesh,
                                   schedule=schedule, overlap=overlap)
                smoke.sharded_forward(net.prepare(kernels), x, biases)
        forwards = set(launched)
        for schedule, overlap in smoke.SHARDED:
            _sharded_step(mesh, schedule, overlap, kernels, biases, x, r,
                          convs)
        smoke.check_slab_cgemm(mesh, convs, None, set())
    finally:
        tmesh.destroy_process_group()
    # the forwards' CGEMMs and the dx plans' that the training steps add
    assert held == launched and len(forwards) == 2 * len(LAYERS)
    assert launched > forwards


def _convs(batch):
    """The narrow trunk's layers as a plan_network takes them."""
    from repro_torch.conv import Epilogue, NetworkConv
    return [NetworkConv(l.name, (batch, CHANNELS[i], 16 >> (i // 2),
                                 16 >> (i // 2)),
                        (CHANNELS[i + 1], CHANNELS[i], 3, 3), padding=1,
                        epilogue=Epilogue(bias=True, activation="relu"))
            for i, l in enumerate(LAYERS)]


def _sharded_step(mesh, schedule, overlap, kernels, biases, x, r, convs,
                  branches=None):
    """One phase-12 training step of the narrow trunk on ``mesh``."""
    plans = smoke.sharded_train_plans(mesh, convs, schedule, overlap)
    return _step(smoke.vgg_train_loss, kernels, biases, torch.float32,
                 backend=None, x=x, r=r, branches=branches, plans=plans)


@pytest.mark.parametrize("kernel", ["tile_rfft", "tile_irfft_epilogue",
                                    "tile_irfft"])
def test_slab_dft_cases_are_the_sharded_plans_launches(monkeypatch, kernel):
    """The compact tile DFT cases the phase holds against the plain
    versions are, beside those held before it at the local trunk's shapes
    (``check_forward``, ``check_inverse``, ``check_plain_inverse``), the
    tile counts (and activations) that the sharded forwards and training
    steps of ``SHARDED`` give each kernel, slab by slab; none is held
    twice (a one-rank gloo mesh at narrow widths)."""
    import repro_torch.kernels.dft_tile as dft_pkg
    from repro_torch.conv import (
        autodiff, clear_plan_cache, clear_prepared_cache, plan_network)
    from repro_torch.launch import mesh as tmesh
    launched = set()
    real_rfft, real_irfft = dft_pkg.tile_rfft_cuda, dft_pkg.tile_irfft_cuda
    real_epilogue = dft_pkg.tile_irfft_epilogue_cuda

    def rfft(x, *, delta):
        out = real_rfft(x, delta=delta)
        launched.add(("tile_rfft", x.shape[0], out[0].shape[1], None))
        return out

    def irfft(Zr, Zi, *, delta, tiles=None):
        launched.add(("tile_irfft", *Zr.shape, None))
        return real_irfft(Zr, Zi, delta=delta, tiles=tiles)

    def epilogue(Zr, Zi, bias, *, activation="none", delta=16, tiles=None):
        launched.add(("tile_irfft_epilogue", *Zr.shape, activation))
        return real_epilogue(Zr, Zi, bias, activation=activation,
                             delta=delta, tiles=tiles)
    monkeypatch.setattr(dft_pkg, "tile_rfft_cuda", rfft)
    monkeypatch.setattr(dft_pkg, "tile_irfft_cuda", irfft)
    monkeypatch.setattr(dft_pkg, "tile_irfft_epilogue_cuda", epilogue)
    P = dft_ops.num_freq_real(16)
    monkeypatch.setattr(smoke, "forward_row", lambda name, n, gen, **extra:
                        dict(kernel="tile_rfft", shape=[n, 16, P]))
    monkeypatch.setattr(smoke, "epilogue_row",
                        lambda name, n, P, act, gen, **extra:
                        dict(kernel="tile_irfft_epilogue", shape=[n, P, 16],
                             activation=act))
    monkeypatch.setattr(smoke, "plain_inverse_row",
                        lambda name, n, P, gen, **extra:
                        dict(kernel="tile_irfft", shape=[n, P, 16]))
    kernels, biases, x, r = _trunk(torch.float32)
    x, r = torch.cat([x, x]), torch.cat([r, r])  # batch 4: slabs of 2
    convs = _convs(4)
    net = plan_network(convs, backend="fft-cuda")
    layers = [(name, plan.spec) for name, plan in net.items()]
    dx_layers = [(name, autodiff._transposed_plan(plan).spec)
                 for name, plan in list(net.items())[1:]]
    before = {smoke.dft_key(row) for row in
              smoke.check_forward(layers, None)
              + smoke.check_inverse(layers, None)
              + smoke.check_plain_inverse(dx_layers, None)}
    tmesh.start_process_group("gloo")
    try:
        clear_plan_cache()
        clear_prepared_cache()
        mesh = tmesh.make_host_mesh(1, 1)
        for schedule, overlap in smoke.SHARDED:
            with torch.inference_mode():
                trunk = plan_network(convs, backend="fft-cuda", mesh=mesh,
                                     schedule=schedule, overlap=overlap)
                smoke.sharded_forward(trunk.prepare(kernels), x, biases)
            _sharded_step(mesh, schedule, overlap, kernels, biases, x, r,
                          convs)
        rows = smoke.check_slab_dft(mesh, convs, None, set(before))
    finally:
        tmesh.destroy_process_group()
    held = [smoke.dft_key(row) for row in rows if row["kernel"] == kernel]
    launched = {c for c in launched if c[0] == kernel}
    before = {c for c in before if c[0] == kernel}
    assert len(held) == len(set(held)) and before.isdisjoint(held)
    assert launched <= before | set(held)
    assert held and set(held) <= launched


def test_sharded_train_launch_and_collective_arithmetic():
    # per step 9 forward plans and 8 dx plans, each stage 2 once and
    # stage 1 a slab
    assert smoke.sharded_train_launches(9, 1, 1) == {
        "tile_rfft": 34, "cgemm": 17, "tile_irfft_epilogue": 9,
        "tile_irfft": 8}
    assert smoke.sharded_train_launches(9, 2, 5) == {
        "tile_rfft": 255, "cgemm": 170, "tile_irfft_epilogue": 90,
        "tile_irfft": 80}
    assert smoke.sharded_train_collectives("nfft", 2, 9) == {
        "all_to_all": 85, "all_reduce": 0, "grad_all_reduce": 18,
        "grad_all_gather": 26, "grad_full": 0}
    assert smoke.sharded_train_collectives("wfft", 1, 9) == {
        "all_to_all": 0, "all_reduce": 17, "grad_all_reduce": 18,
        "grad_all_gather": 26, "grad_full": 0}


@pytest.mark.parametrize("schedule,overlap", [("nfft", "slab:2"),
                                              ("wfft", "off")])
def test_sharded_train_step_rehearsal_on_a_host_mesh(schedule, overlap):
    """Phase 12's step on a one-rank gloo mesh at narrow widths: plain
    grads equal to the local fft-cuda step's within SHARDED_GRAD_TOL and
    within GRAD_TOL of float64 direct through the same branches, the
    same branches as the local step, and exactly the collectives the
    phase expects."""
    from repro_torch.conv import clear_plan_cache, stages
    from repro_torch.launch import mesh as tmesh
    kernels, biases, x, r = _trunk(torch.float32)
    x, r = torch.cat([x, x]), torch.cat([r, r])
    convs = _convs(4)
    branches, branches_local = [], []
    _, local = _step(smoke.vgg_train_loss, kernels, biases, torch.float32,
                     backend="fft-cuda", x=x, r=r, branches=branches_local)
    tmesh.start_process_group("gloo")
    try:
        clear_plan_cache()
        mesh = tmesh.make_host_mesh(1, 1)
        with stages.stage_trace() as trace:
            _, grads = _sharded_step(mesh, schedule, overlap, kernels,
                                     biases, x, r, convs, branches)
        slabs = 2 if overlap == "slab:2" else 1
        got = smoke.check_collectives(
            "rehearsal", trace,
            smoke.sharded_train_collectives(schedule, slabs, len(LAYERS)),
            1, 1)
        with pytest.raises(AssertionError, match="collectives"):
            smoke.check_collectives(
                "rehearsal", trace,
                smoke.sharded_train_collectives(schedule, 3 - slabs,
                                                len(LAYERS)), 1, 1)
    finally:
        tmesh.destroy_process_group()
    assert got["grad_all_gather"] == 3 * len(LAYERS) - 1
    assert all(type(g) is torch.Tensor for g in grads)
    assert max(smoke.rel_errs(LAYERS, grads, local).values()) \
        <= smoke.SHARDED_GRAD_TOL
    assert smoke.flip_counts(branches, branches_local) == \
        [0] * len(branches)
    _, grads64 = _step(smoke.vgg_branch_loss, kernels, biases,
                       torch.float64, x=x.double(), r=r.double(),
                       branches=branches)
    assert max(smoke.rel_errs(LAYERS, grads, grads64).values()) \
        <= smoke.GRAD_TOL


# --------------------------------------------------------------------------
# Phase sharded_tune: the sweep's launches, rehearsed on a host mesh
# --------------------------------------------------------------------------

def test_sharded_tune_launches_are_the_measured_candidates(monkeypatch,
                                                           tmp_path):
    """The tuner over the sharded schedules on a one-rank gloo mesh at
    narrow widths, measuring on the CPU with spies on the kernels'
    wrappers: the calls each kernel gets during the sweep are exactly
    ``sharded_tune_launches`` of the ``fft-cuda`` candidates it measured
    (``sweep_plans``: slabbed and not, real and complex), and the fused
    inverse's by tiles a block ``inverse_tiles_launches``'; then the
    prepared tuned trunk's, per prepare and forward."""
    import repro_torch.kernels.cgemm as cgemm_pkg
    import repro_torch.kernels.dft_tile as dft_pkg
    from repro_torch.conv import autotune, clear_plan_cache, plan_network
    from repro_torch.launch import mesh as tmesh
    calls = collections.Counter()
    bts = collections.Counter()

    def spy(pkg, attr, kernel):
        real = getattr(pkg, attr)

        def call(*args, **kw):
            calls[kernel] += 1
            if kernel == "tile_irfft_epilogue":
                bts[dft_ops.resolve_tiles(kw.get("tiles"))] += 1
            return real(*args, **kw)
        monkeypatch.setattr(pkg, attr, call)
    spy(cgemm_pkg, "cgemm_cuda", "cgemm")
    spy(dft_pkg, "tile_rfft_cuda", "tile_rfft")
    spy(dft_pkg, "tile_irfft_epilogue_cuda", "tile_irfft_epilogue")
    spy(dft_pkg, "tile_irfft_cuda", "tile_irfft")
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path / "t.json"))
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_REPS", "1")
    # every candidate measured, however loaded the host
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_BUDGET_MS", "1e9")
    convs = _convs(4)[:2]
    kernels, biases, x, _ = _trunk(torch.float32)
    x = torch.cat([x, x])
    autotune.reset()
    tmesh.start_process_group("gloo")
    try:
        clear_plan_cache()
        mesh = tmesh.make_host_mesh(1, 1)
        with autotune.measure_on("cpu"):
            net = plan_network(convs, mesh=mesh, backend="tuned",
                               overlap="auto")
        sweeps = autotune.sweeps()
        measured = smoke.sweep_plans(mesh, sweeps)
        assert len(sweeps) == 2 and measured
        assert {p.num_slabs for p in measured} >= {1, 2}
        assert {p.spectrum for p in measured} == {"real", "complex"}
        assert dict(calls) == smoke.sharded_tune_launches(measured, 2)
        want_bt = smoke.inverse_tiles_launches(measured, 2)
        assert {t: bts[t] for t in want_bt} == want_bt
        calls.clear()
        with torch.inference_mode():
            prepared = net.prepare({c.name: kernels[c.name] for c in convs})
            h = x
            for c in convs:
                h = prepared[c.name](h, bias=biases[c.name])
        assert dict(calls) == smoke.sharded_tune_launches(
            list(net.plans.values()), 1, 1, False)
    finally:
        autotune.reset()
        tmesh.destroy_process_group()


def test_inverse_tiles_rows_cover_every_pass():
    """Phase 3 times each inverse at the tiles a block other than the
    default over its main-path pass: kernels 2, 6 and 7 at the served
    forward's nine output tile counts, kernel 4 at the eight dx plans';
    each row's bound counts what the kernel's default row counts."""
    from repro_torch.configs.paper_convs import network_convs
    from repro_torch.conv import autodiff, plan_network
    from repro_torch.launch import serve
    net = plan_network(network_convs(serve._vgg_scale(224), 4),
                       backend="fft-cuda")
    layers = [(n, p.spec) for n, p in net.items()]
    dx = [(n, autodiff._transposed_plan(p).spec)
          for n, p in list(net.items())[1:]]
    passes = smoke.inverse_passes(layers, dx)
    assert smoke.OTHER_TILES == (4, 16)
    assert collections.Counter(k for k, _, _ in passes) == {
        "tile_irfft_epilogue": 9, "tile_irfft": 8, "tile_ifft": 9,
        "tile_ifft_epilogue": 9}
    n = 1000
    assert smoke.inverse_bytes_flops("tile_irfft_epilogue", n) == (
        4 * (2 * n * 130 + n + n * 256), n * (8 * 16 * 9 * 16
                                              + 4 * 16 * 16 * 9))
    assert smoke.inverse_bytes_flops("tile_irfft", n)[0] \
        == 4 * (2 * n * 130 + n * 256)
    assert smoke.inverse_bytes_flops("tile_ifft_epilogue", n) \
        == smoke.rect_bytes_flops(n, 16, tail=True)
    assert smoke.inverse_bytes_flops("tile_ifft", n) \
        == smoke.rect_bytes_flops(n, 16)


# --------------------------------------------------------------------------
# Phase sharded_serve: its arithmetic and gates, rehearsed on a one-rank
# gloo mesh (the host engine is eager: one warm-up forward a bucket where
# the card runs WARMUP_PASSES and a capture)
# --------------------------------------------------------------------------

def _serve_rig():
    """A narrow two-layer bias+ReLU trunk for the engine, made from a seed
    with numpy: (make_layers, kernels, forward)."""
    from repro_torch.conv import Epilogue, NetworkConv
    ep = Epilogue(bias=True, activation="relu")

    def make_layers(batch):
        return [NetworkConv("a", (batch, 3, 16, 16), (4, 3, 3, 3),
                            padding=1, epilogue=ep),
                NetworkConv("b", (batch, 4, 16, 16), (4, 4, 3, 3),
                            padding=1, epilogue=ep)]
    rng = np.random.default_rng(3)
    kernels = {n: torch.as_tensor(rng.standard_normal((4, c, 3, 3)),
                                  dtype=torch.float32)
               for n, c in (("a", 3), ("b", 4))}
    biases = {n: torch.as_tensor(rng.standard_normal(4), dtype=torch.float32)
              for n in kernels}

    def forward(prepared, x):
        for name in prepared:
            x = prepared[name](x, bias=biases[name])
        return x
    return make_layers, kernels, forward


@pytest.fixture(scope="module")
def gloo_mesh():
    from repro_torch.launch import mesh as tmesh
    tmesh.start_process_group("gloo")
    try:
        yield tmesh.make_host_mesh(1, 1)
    finally:
        tmesh.destroy_process_group()


@pytest.mark.parametrize("schedule,overlap", smoke.SERVE_SHARDED,
                         ids=[f"{s}-{o}" for s, o in smoke.SERVE_SHARDED])
def test_sharded_serve_counts_are_the_engines_per_pass(gloo_mesh, schedule,
                                                       overlap):
    """``serve_capture_counts`` is ``WARMUP_PASSES + 1`` times what one
    pass of the engine's buckets issues (the host's eager warm-up runs one
    pass), with a prepare's stage 2 a bucket; each batch of a trace issues
    its bucket's collectives and one output gather."""
    from repro_torch.conv import stages
    from repro_torch.launch import batcher
    make_layers, kernels, forward = _serve_rig()
    with stages.stage_trace() as trace:
        eng = batcher.ServeEngine(
            make_layers, kernels, policy=batcher.BucketPolicy(max_batch=4),
            forward=forward, backend="fft-cuda", device="cpu",
            mesh=gloo_mesh, schedule=schedule, overlap=overlap)
    slabs = smoke.serve_bucket_slabs(eng, "rehearsal")
    assert slabs == {(1, None): 1, (2, None): 1 + (overlap != "off"),
                     (4, None): 1 + (overlap != "off")}
    launches, want = smoke.serve_capture_counts(eng, schedule, 2,
                                                "rehearsal")
    passes = batcher.WARMUP_PASSES + 1
    one_pass = smoke.check_serve_collectives(
        "rehearsal", trace, {k: n // passes for k, n in want.items()})
    assert {k: n * passes for k, n in one_pass.items()} == {
        k: n for k, n in want.items() if n}
    per_fwd = 2 * sum(slabs.values())
    assert launches == {**dict.fromkeys(smoke.KERNELS, 0),
                        "tile_rfft": passes * per_fwd + 2 * len(slabs),
                        "cgemm": passes * per_fwd,
                        "tile_irfft_epilogue": passes * per_fwd}
    rng = np.random.default_rng(4)
    with stages.stage_trace() as trace:
        for b in (1, 3, 2):
            eng.submit(torch.as_tensor(rng.standard_normal((b, 3, 16, 16)),
                                       dtype=torch.float32))
        eng.drain(force=True)                   # b4 (1 + 3 rows), b2
    # the host runs each batch eagerly: its bucket's collectives, and one
    # output gather (on the card a replay issues none from the host)
    want_trace = collections.Counter(output_gather=2)
    for key in ((4, None), (2, None)):
        for kind, n in smoke.sharded_collectives(schedule,
                                                 slabs[key]).items():
            want_trace[kind] += 2 * n
    smoke.check_serve_collectives("trace", trace, want_trace)


def test_check_serve_collectives_refuses_a_wrong_count():
    counts = collections.Counter({("collective", "all_reduce"): 3,
                                  ("collective", "output_gather"): 1})
    assert smoke.check_serve_collectives(
        "x", counts, {"all_reduce": 3, "output_gather": 1,
                      "all_to_all": 0}) == {"all_reduce": 3,
                                            "output_gather": 1}
    for want in ({"all_reduce": 2, "output_gather": 1}, {"all_reduce": 3},
                 {}):
        with pytest.raises(AssertionError, match="collectives"):
            smoke.check_serve_collectives("x", counts, want)
    # an all-to-all counts one boundary all-to-all too
    counts = collections.Counter({("collective", "all_to_all"): 2,
                                  "boundary_a2a": 1})
    with pytest.raises(AssertionError, match="boundary"):
        smoke.check_serve_collectives("x", counts, {"all_to_all": 2})


def test_check_replay_activity_refuses_other_operations():
    """A replay must run the eager callable's device operations, name by
    name and count by count: one copy fewer (a lost one-rank
    all-to-all), a kernel more or another name fails.  A reading that
    lost a run of records passes only beside a complete one; one that
    holds an operation more fails beside a complete one too."""
    eager = {"Memcpy DtoD (Device -> Device)": 19, "cgemm_kernel": 9,
             "rinv16_kernel": 9}
    assert smoke.check_replay_activity("x", eager, [dict(eager)]) == 37
    dropped = {"Memcpy DtoD (Device -> Device)": 6, "rinv16_kernel": 3}
    assert smoke.check_replay_activity(
        "x", eager, [dropped, dict(eager)]) == 37
    for change in ({"Memcpy DtoD (Device -> Device)": 18},
                   {"cgemm_kernel": 10}, {"ncclDevKernel_SendRecv": 1}):
        with pytest.raises(AssertionError, match="differ|did not"):
            smoke.check_replay_activity("x", eager, [dict(eager, **change)])
    for change in ({"cgemm_kernel": 10}, {"ncclDevKernel_SendRecv": 1}):
        with pytest.raises(AssertionError, match="did not"):
            smoke.check_replay_activity(
                "x", eager, [dict(eager), dict(eager, **change)])
    for replays in ([{}], [dropped] * smoke.READINGS, []):
        with pytest.raises(AssertionError, match="differ"):
            smoke.check_replay_activity("x", eager, replays)


def test_replay_readings_stop_at_agreement():
    """The eager side is read until two readings agree, the replay side
    until one equals theirs, each at most ``READINGS`` times."""
    def reader(values):
        it = iter(values)
        return lambda: next(it)
    full, cut = {"k": 9, "copy": 3}, {"k": 2}
    reads = smoke.readings_until(reader([cut, full, full, cut]),
                                 lambda rs: smoke.agreed(rs) is not None)
    assert reads == [cut, full, full] and smoke.agreed(reads) == full
    reads = smoke.readings_until(reader([{"k": i} for i in range(9)]),
                                 lambda rs: smoke.agreed(rs) is not None)
    assert len(reads) == smoke.READINGS and smoke.agreed(reads) is None
    reads = smoke.readings_until(reader([cut, full, cut]),
                                 lambda rs: rs[-1] == full)
    assert reads == [cut, full]


def _readings(*counts):
    """A reader of ``device_activity``-shaped readings: ``counts`` in
    turn, then the last of them again."""
    it = iter(counts)
    last = []

    def read():
        last[:] = [next(it, last[0] if last else None)]
        return (last[0], {}, {})
    return read


def test_replay_gate_reference_only_grows():
    """The eager reference is the per-name maximum of the eager readings:
    a replay that misses an operation fails though eager readings that
    dropped the same operation agree, or a re-read one equals it; a replay
    that holds more than two agreeing eager readings that both dropped
    records passes once an eager reading holds them too; one that runs an
    operation the eager callable never does fails."""
    full = {"cgemm_kernel": 8, "rinv16_kernel": 1, "Memcpy DtoD": 3}
    dropped = {"cgemm_kernel": 8, "rinv16_kernel": 1, "Memcpy DtoD": 1}
    missing = {"cgemm_kernel": 8, "Memcpy DtoD": 3}
    assert smoke.fullest([(dropped, {}, {}), (missing, {"r": 1}, {})]) == (
        full, {"r": 1}, {})
    # two dropped sessions agree after a complete one: the replay must
    # still hold every operation
    with pytest.raises(AssertionError, match="differ"):
        smoke.replay_gate("x", _readings(full, missing, missing),
                          _readings(missing))
    # the eager readings agree on one that dropped copies; the replay
    # holds them but misses a kernel, and a re-read eager session drops
    # that same kernel
    with pytest.raises(AssertionError, match="differ"):
        smoke.replay_gate("x", _readings(dropped, dropped, missing),
                          _readings(missing))
    n, eager, eager_reads, replays = smoke.replay_gate(
        "x", _readings(dropped, dropped, full), _readings(missing, full))
    assert n == 12 and eager[0] == full
    assert len(eager_reads) == 3 and len(replays) == smoke.READINGS
    n, eager, eager_reads, replays = smoke.replay_gate(
        "x", _readings(full, full), _readings(dropped, full))
    assert n == 12 and len(eager_reads) == 2 and len(replays) == 2
    with pytest.raises(AssertionError, match="did not"):
        smoke.replay_gate("x", _readings(full, full),
                          _readings(dict(full, nccl_kernel=1)))
    with pytest.raises(AssertionError, match="agree"):
        smoke.replay_gate("x", _readings(*({"k": i} for i in range(9))),
                          _readings(full))


def test_serve_checks_on_a_mesh_hold_the_local_result(gloo_mesh):
    """``serve_checks`` with ``local=``: a plain result of the engine on
    the mesh passes against its gathered eager forward, direct, and the
    local engine's result for the same request; one off by more than
    ``GRAPH_TOL`` from the local result, or a ``DTensor``, is refused."""
    import types

    from repro_torch.launch import batcher
    make_layers, kernels, forward = _serve_rig()
    rng = np.random.default_rng(5)
    xs = [torch.as_tensor(rng.standard_normal((b, 3, 16, 16)),
                          dtype=torch.float32) for b in (1, 2)]
    engines = {}
    for kw in (dict(), dict(mesh=gloo_mesh, schedule="wfft",
                            overlap="slab:2")):
        eng = batcher.ServeEngine(
            make_layers, kernels, policy=batcher.BucketPolicy(max_batch=4),
            forward=forward, backend="fft-cuda", device="cpu", **kw)
        rids = [eng.submit(x) for x in xs]
        eng.drain(force=True)
        engines["mesh" if kw else "local"] = eng
    eng, local = engines["mesh"], engines["local"]
    assert eng.placements == local.placements
    res = types.SimpleNamespace(make_layers=make_layers, forward=forward)
    out = smoke.serve_checks(eng, res, rids[1], xs[1], kernels,
                             local=local.results[rids[1]])
    assert out["rel_err_vs_local_engine"] <= smoke.GRAPH_TOL
    with pytest.raises(AssertionError, match="not within"):
        smoke.serve_checks(eng, res, rids[1], xs[1], kernels,
                           local=local.results[rids[1]] * (1 + 1e-3))
    net = eng.nets[(4, None)]
    eng.results[rids[0]] = forward(net.prepare(kernels), torch.cat(
        xs + [torch.zeros((1, 3, 16, 16))]))   # a DTensor, not gathered
    with pytest.raises(AssertionError, match="plain tensor"):
        smoke.serve_checks(eng, res, rids[0], xs[0], kernels)


# --------------------------------------------------------------------------
# Phase entry_points: its gates, rehearsed on the host
# --------------------------------------------------------------------------

def test_engine_launches_arithmetic():
    """A local engine's start-up launches: per bucket a prepare and
    ``WARMUP_PASSES + 1`` forwards (as the card test
    ``test_replays_launch_no_kernel`` counts them for two buckets)."""
    from repro_torch.launch import batcher
    forwards = 2 * (batcher.WARMUP_PASSES + 1)
    assert smoke.engine_launches(2, 2) == {
        "tile_rfft": 2 * (2 + forwards), "cgemm": 2 * forwards,
        "tile_irfft_epilogue": 2 * forwards}


def test_pallas_shim_runs_what_its_one_shot_plan_runs():
    """The phase's launch gate on the host: ``fft_conv2d_pallas`` on a
    narrow layer runs exactly the stage ops of the layer's one-shot
    ``fft-cuda`` plan, with the plain inverse (no epilogue), and warns."""
    from repro_torch.conv import plan_conv, stages
    rng = np.random.default_rng(6)
    x = torch.as_tensor(rng.standard_normal((4, 8, 28, 28)),
                        dtype=torch.float32)
    k = torch.as_tensor(rng.standard_normal((16, 8, 3, 3)),
                        dtype=torch.float32)
    plan = plan_conv(tuple(x.shape), tuple(k.shape), padding=1,
                     backend="fft-cuda")
    with stages.stage_trace() as want:
        y_plan = plan(x, k)
    with stages.stage_trace() as got, \
            pytest.warns(DeprecationWarning, match="fft_conv2d_pallas"):
        y = smoke.fft_conv2d_pallas(x, k, padding=1)
    assert got == want and got["cgemm"] == 1
    assert smoke.rel_err(y, y_plan) <= smoke.GRAPH_TOL
    y0 = torch.nn.functional.conv2d(x, k, padding=1)
    assert smoke.rel_err(y, y0) <= smoke.SLICE_TOL


def test_entry_point_checks_hold_the_example_twins():
    """``check_quickstart`` and ``check_serve_batcher`` pass the twins'
    runs on the host (eager executor: no replay) and refuse a run that
    is off."""
    import dataclasses

    from repro_torch.examples import quickstart, serve_batcher
    quick = quickstart.main(["--device", "cpu"])
    smoke.check_quickstart(quick)
    for bad in (dict(rel_err=2 * smoke.SLICE_TOL),
                dict(prepared_matches=False)):
        with pytest.raises(AssertionError, match="quickstart"):
            smoke.check_quickstart(dataclasses.replace(quick, **bad))
    sb = serve_batcher.main(["--device", "cpu"])
    assert smoke.check_serve_batcher(sb, "eager") == (10, 0)
    with pytest.raises(AssertionError, match="serve_batcher"):
        smoke.check_serve_batcher(sb, "cuda-graph")
    for bad in (dict(rejected=False), dict(updated_shape=(4, 16, 32, 32))):
        with pytest.raises(AssertionError, match="serve_batcher"):
            smoke.check_serve_batcher(dataclasses.replace(sb, **bad),
                                      "eager")
