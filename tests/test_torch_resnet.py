"""ResNet-50 v1.5 on the port's normal path: the planned network (batch
norm folded at prepare, the 13 unit-stride 3x3 convs on the FFT backend,
the other 40 on ``direct``) against the plain reference, eagerly and
through the serving engine, at the full topology with every width / 8;
and the plan's ``stride``, which only ``direct`` runs."""
import ast
import pathlib

import pytest
import torch
import torch.nn.functional as F

from repro_torch.conv import (
    Epilogue, NetworkConv, plan_conv, plan_network, stage_trace)
from repro_torch.conv import autotune
from repro_torch.conv import export as planx
from repro_torch.core import conv2d_direct
from repro_torch.models import resnet
from repro_torch.models import resnet_reference as reference

ROOT = pathlib.Path(__file__).resolve().parents[1]
SMALL = dict(image=64, width_div=8)
SEED = 2 ** 33 + 35


@pytest.fixture(scope="module")
def small():
    """Unfolded params, folded params and a batch of 2 at width / 8."""
    params = resnet.init_params(SEED, width_div=8)
    x = torch.randn((2, 3, 64, 64),
                    generator=torch.Generator().manual_seed(SEED))
    return params, resnet.fold_batchnorm(params), x


def _scaled_err(y, y_ref):
    return ((y - y_ref).abs().max() / y_ref.abs().max()).item()


def test_topology():
    cs = resnet.convs()
    assert len(cs) == 53 and len(resnet.blocks()) == 16
    assert sum(c.fft for c in cs) == 13
    assert {(c.C, c.H) for c in cs if c.fft} == {
        (64, 56), (128, 28), (256, 14), (512, 7)}
    # v1.5: each downsampling block's stride on its 3x3 conv
    strided = [c for c in cs if c.stride == 2]
    assert [(c.role, c.k) for c in strided] == [("stem", 7)] + [
        (r, k) for _ in range(3) for r, k in (("3x3", 3), ("projection", 1))]
    assert sum(c.Cout * c.C * c.k * c.k + 4 * c.Cout for c in cs) \
        + 2048 * 1000 + 1000 == 25_610_152      # torchvision's count
    assert cs[-1].H == 7 and cs[-1].Cout == 2048


@pytest.mark.parametrize("fft_backend", ["fft-cuda", "fft-torch"])
def test_eager_forward_matches_reference(small, fft_backend):
    params, folded, x = small
    net = plan_network(resnet.network_convs(2, fft_backend=fft_backend,
                                            **SMALL))
    prepared = net.prepare(folded.kernels, weights_version=0)
    with torch.no_grad():
        y = resnet.forward(prepared, x, folded)
    assert _scaled_err(y, reference.forward(params, x)) < 2e-6


def test_serve_engine_matches_reference(small):
    from repro_torch.launch.batcher import BucketPolicy, ServeEngine
    params, folded, x = small
    eng = ServeEngine(lambda b: resnet.network_convs(b, **SMALL),
                      folded.kernels,
                      policy=BucketPolicy(max_batch=2, min_batch=2),
                      forward=resnet.make_forward(folded), device="cpu",
                      backend="auto")
    rid = eng.submit(x)
    eng.drain()
    eng.finish()
    assert _scaled_err(eng.results[rid],
                       reference.forward(params, x)) < 2e-6
    net = eng.nets[(2, None)]
    assert sum(net[n].backend == "fft-cuda" for n in net) == 13


def test_fold_matches_unfolded_batch_norm(small):
    params, folded, _ = small
    name = "layer2.0.conv2"
    x = torch.randn((2, 16, 8, 8), generator=torch.Generator().manual_seed(1))
    want = F.batch_norm(F.conv2d(x, params[f"{name}.weight"], stride=2,
                                 padding=1),
                        params["layer2.0.bn2.running_mean"],
                        params["layer2.0.bn2.running_var"],
                        params["layer2.0.bn2.weight"],
                        params["layer2.0.bn2.bias"], training=False,
                        eps=resnet.BN_EPS)
    got = F.conv2d(x, folded.kernels[name], folded.biases[name], stride=2,
                   padding=1)
    assert _scaled_err(got, want) < 1e-6
    assert set(folded.kernels) == {c.name for c in resnet.convs()}
    assert resnet._bn_of("layer3.0.downsample.0") == "layer3.0.downsample.1"


def test_routing_counters_at_published_widths():
    """Planned at the published widths and run on fake tensors (nothing
    executes): a forward calls 13 ``fft-cuda`` convs, all 3x3 at unit
    stride, and 40 ``direct`` ones."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    net = plan_network(resnet.network_convs(1))
    with FakeTensorMode(), torch.no_grad():
        folded = resnet.fold_batchnorm(resnet.init_params(0))
        prepared = net.prepare(folded.kernels)
        with stage_trace() as counts:
            y = resnet.forward(prepared, torch.empty(1, 3, 224, 224), folded)
    assert tuple(y.shape) == (1, 1000)
    convs = {k: v for k, v in counts.items()
             if isinstance(k, tuple) and k[0] in ("backend", "conv")}
    assert convs == {("backend", "fft-cuda"): 13,
                     ("conv", "fft-cuda", 1, 3): 13,
                     ("backend", "direct"): 40,
                     ("conv", "direct", 2, 7): 1,
                     ("conv", "direct", 1, 1): 33,
                     ("conv", "direct", 2, 1): 3,
                     ("conv", "direct", 2, 3): 3}
    assert counts["cgemm"] == 13


def test_expand_conv_fuses_the_residual(small):
    """The shortcut enters the expand conv's epilogue: the plan refuses to
    run without it, and with it gives relu(conv + bias + shortcut)."""
    _, folded, _ = small
    net = plan_network(resnet.network_convs(2, **SMALL))
    p = net["layer1.1.conv3"]
    assert p.epilogue == Epilogue(bias=True, residual=True,
                                  activation="relu")
    x = torch.randn(p.x_shape)
    r = torch.randn(p.out_shape)
    k, b = folded.kernels["layer1.1.conv3"], folded.biases["layer1.1.conv3"]
    want = F.relu(F.conv2d(x, k, b) + r)
    assert torch.allclose(p(x, k, bias=b, residual=r), want, atol=1e-5)
    with pytest.raises(ValueError, match="residual"):
        p(x, k, bias=b)


@pytest.mark.parametrize("backend", ["fft-cuda", "fft-torch"])
def test_fft_backends_refuse_stride(backend):
    with pytest.raises(ValueError, match="unit-stride"):
        plan_conv((2, 8, 16, 16), (8, 8, 3, 3), padding=1, stride=2,
                  backend=backend)


def test_auto_and_tuner_keep_stride_on_direct(monkeypatch):
    """``auto`` and ``tuned`` resolve a strided geometry to ``direct``, the
    tuner without measuring or even enumerating a candidate."""
    def no_tuning(*a, **k):
        raise AssertionError("a strided plan reached the tuner")
    monkeypatch.setattr(autotune, "tune", no_tuning)
    monkeypatch.setattr(autotune, "candidates", no_tuning)
    kw = dict(padding=1, stride=(2, 2), cache=False)
    assert plan_conv((2, 64, 56, 56), (64, 64, 3, 3), backend="auto",
                     **kw).backend == "direct"
    for stride, want in ((2, (2, 2)), ((2, 1), (2, 1))):
        kw["stride"] = stride
        plan = plan_conv((2, 64, 56, 56), (64, 64, 3, 3), backend="tuned",
                         **kw)
        assert (plan.backend, plan.stride) == ("direct", want)


@pytest.mark.parametrize("stride", [2, (2, 1), 3])
def test_strided_direct_plan_matches_conv2d(stride):
    g = torch.Generator().manual_seed(7)
    x, k = torch.randn((2, 5, 15, 13), generator=g), \
        torch.randn((6, 5, 3, 3), generator=g)
    b, ep = torch.randn((6,), generator=g), Epilogue(bias=True,
                                                     activation="relu")
    plan = plan_conv(x.shape, k.shape, padding=1, stride=stride,
                     backend="direct", epilogue=ep)
    want = F.relu(F.conv2d(x, k, b, stride=stride, padding=1))
    assert plan.out_shape == tuple(want.shape)
    assert torch.allclose(plan(x, k, bias=b), want, atol=1e-5)
    assert torch.allclose(plan.prepare(k)(x, bias=b), want, atol=1e-5)
    s = plan.stride
    assert plan.flops() == 2 * 2 * 6 * 5 * 9 * want.shape[2] * \
        want.shape[3] and f"stride={s}" in plan.describe()


def test_conv2d_direct_passes_stride_with_compute_dtype():
    g = torch.Generator().manual_seed(8)
    x, k = torch.randn((1, 4, 9, 9), generator=g), \
        torch.randn((3, 4, 3, 3), generator=g)
    got = conv2d_direct(x, k, padding=1, stride=2,
                        compute_dtype=torch.bfloat16)
    want = F.conv2d(x.bfloat16().float(), k.bfloat16().float(), stride=2,
                    padding=1)
    assert got.shape == (1, 3, 5, 5) and torch.equal(got, want)


def test_analyze_profiles_the_strided_output():
    """plan-lint runs a strided direct plan with a residual of the
    strided output's shape; its live bytes hold that output."""
    ep = Epilogue(bias=True, residual=True, activation="relu")
    plan = plan_conv((4, 64, 56, 56), (256, 64, 1, 1), stride=2,
                     backend="direct", epilogue=ep)
    prof = plan.analyze(device="cpu")
    assert not prof.check().violations
    assert prof.peak_live_bytes >= 4 * 4 * 256 * 28 * 28


def test_unit_stride_plan_unchanged():
    """A unit-stride plan is the plan it always was: the same cached
    object whether ``stride=1`` is said or not, the same 19-field cache
    key, no stride in ``describe()`` or in its artifact record."""
    from repro_torch.conv import plan as planmod
    a = plan_conv((2, 8, 16, 16), (8, 8, 3, 3), padding=1,
                  backend="fft-cuda")
    assert plan_conv((2, 8, 16, 16), (8, 8, 3, 3), padding=1, stride=1,
                     backend="fft-cuda") is a
    assert plan_conv((2, 8, 16, 16), (8, 8, 3, 3), padding=1,
                     stride=(1, 1), backend="fft-cuda") is a
    keys = [k for k, v in planmod._plan_cache.items() if v is a]
    assert keys and all(len(k) == 19 for k in keys)
    assert "stride" not in a.describe()
    cfg = planx.plan_config(a)
    assert "stride" not in cfg and list(cfg) == [
        "x_shape", "k_shape", "padding", "delta", "backend", "schedule",
        "three_m", "bm", "bn", "bk", "dft_bt", "compute_dtype", "mesh",
        "data_axis", "model_axis", "replicate_kernel_transform",
        "epilogue", "spectrum", "overlap"]
    s = plan_conv((2, 8, 16, 16), (8, 8, 3, 3), padding=1, stride=2)
    assert s is not a and planx.plan_config(s)["stride"] == [2, 2]


def test_strided_network_round_trips_through_export(tmp_path):
    g = torch.Generator().manual_seed(9)
    layers = [NetworkConv("a", (2, 4, 16, 16), (8, 4, 3, 3), padding=1,
                          stride=2, overrides=(("backend", "direct"),),
                          epilogue=Epilogue(bias=True, activation="relu")),
              NetworkConv("b", (2, 8, 8, 8), (8, 8, 3, 3), padding=1,
                          overrides=(("backend", "fft-cuda"),))]
    net = plan_network(layers)
    params = {n: torch.randn(net[n].k_shape, generator=g) for n in net}
    bias = torch.randn((8,), generator=g)
    path = net.export(str(tmp_path / "net.rpa"), params,
                      weights_version=3, device="cpu")
    loaded = planx.load_network(path, device="cpu")
    assert loaded.source == "aot"
    assert loaded["a"].plan.stride == (2, 2)
    assert loaded["a"].plan.out_shape == net["a"].out_shape == (2, 8, 8, 8)
    x = torch.randn((2, 4, 16, 16), generator=g)
    prepared = net.prepare(params, weights_version=3)
    want = prepared["b"](prepared["a"](x, bias=bias))
    got = loaded["b"](loaded["a"](x, bias=bias))
    assert torch.allclose(got, want, atol=1e-5)
    assert planx.rebuild_plan(loaded["a"].config) == net["a"]
    assert planx.verify(path)["ok"]


def test_reference_imports_nothing_of_the_port():
    path = ROOT / "src" / "repro_torch" / "models" / "resnet_reference.py"
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            assert node.level == 0
            tops.add(node.module.split(".")[0])
    assert tops <= {"__future__", "contextlib", "torch"}


def test_reference_leaves_tf32_as_it_found_it(small):
    params, _, x = small
    saved = torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cudnn.allow_tf32 = True
        reference.forward(params, x)
        assert torch.backends.cudnn.allow_tf32 is True
    finally:
        torch.backends.cudnn.allow_tf32 = saved


def test_serve_cli_resnet50():
    from repro_torch.launch.serve import main
    out = main(["--convnet", "resnet50", "--smoke", "--batch", "2",
                "--gen", "1", "--device", "cpu", "--seed", "5"])
    assert tuple(out.y.shape) == (2, 1000)
    params = resnet.init_params(5, width_div=8)
    assert _scaled_err(out.y, reference.forward(params, out.x)) < 2e-6


def test_spans_name_the_direct_convs_blocks_and_fold(small, tmp_path):
    """Under a profiler the forward marks each bottleneck, each direct
    conv and its unfused tail, and the fold at prepare, as ``rt:`` spans;
    the stride-1 3x3 convs' stage ops stay under their own."""
    import json
    from torch.profiler import ProfilerActivity, profile
    params, _, x = small
    net = plan_network(resnet.network_convs(2, **SMALL))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        folded = resnet.fold_batchnorm(params)
        with torch.no_grad():
            resnet.forward(net.prepare(folded.kernels), x, folded)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    names = [e["name"] for e in json.loads(path.read_text())["traceEvents"]
             if e.get("ph") == "X" and e["name"].startswith("rt:")]
    assert names.count("rt:resnet/fold") == 1
    assert names.count("rt:resnet/block") == 16
    assert names.count("rt:conv/direct") == 40
    assert names.count("rt:epilogue/direct") == 40
    assert names.count("rt:stage/cgemm") == 13


# --------------------------------------------------------------------------
# On the card ('-m cuda'): cuDNN's fused ReLU epilogue and the whole net
# --------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: cuDNN's fused conv and the CUDA "
                    "kernels have no CPU mode")
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = saved


@pytest.mark.cuda
@pytest.mark.parametrize("stride,residual", [(1, False), (1, True),
                                             (2, False), (2, True)])
def test_direct_relu_epilogue_in_cudnns_fused_call(cuda, stride, residual):
    from repro_torch.conv import backends
    g = torch.Generator(device=cuda).manual_seed(11)
    x = torch.randn((4, 32, 28, 28), generator=g, device=cuda)
    k = torch.randn((64, 32, 3, 3), generator=g, device=cuda)
    b = torch.randn((64,), generator=g, device=cuda)
    ep = Epilogue(bias=True, residual=residual, activation="relu")
    plan = plan_conv(x.shape, k.shape, padding=1, stride=stride,
                     backend="direct", epilogue=ep)
    r = torch.randn(plan.out_shape, generator=g, device=cuda) \
        if residual else None
    want = F.conv2d(x, k, b, stride=stride, padding=1)
    want = F.relu(want + r if residual else want)
    with torch.no_grad():
        fused = backends._cudnn_fused(plan, x, k, b, r)
        assert fused is not None
        assert _scaled_err(fused, want) < 1e-6
        assert _scaled_err(plan.prepare(k)(x, bias=b, residual=r),
                           want) < 1e-6
    # under autograd the unfused path runs, and differentiates
    xg = x.clone().requires_grad_()
    assert backends._cudnn_fused(plan, xg, k, b, r) is None
    y = plan(xg, k, bias=b, residual=r)
    assert _scaled_err(y.detach(), want) < 1e-6
    y.sum().backward()
    assert xg.grad is not None and torch.isfinite(xg.grad).all()


@pytest.mark.cuda
def test_resnet50_on_the_card_matches_reference(cuda):
    """The published widths at batch 8 through the engine's CUDA graph."""
    from repro_torch.launch.batcher import BucketPolicy, ServeEngine
    params = resnet.init_params(SEED, device=cuda)
    folded = resnet.fold_batchnorm(params)
    eng = ServeEngine(lambda b: resnet.network_convs(b), folded.kernels,
                      policy=BucketPolicy(max_batch=8, min_batch=8),
                      forward=resnet.make_forward(folded), device=cuda,
                      backend="fft-cuda")
    x = torch.randn((8, 3, 224, 224),
                    generator=torch.Generator(device=cuda).manual_seed(5),
                    device=cuda)
    rid = eng.submit(x)
    eng.drain()
    eng.finish()
    assert eng._exec[0][(8, None)].graph is not None
    assert _scaled_err(eng.results[rid], reference.forward(params, x)) < 1e-5
