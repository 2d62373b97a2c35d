"""The ResNet-50 v1.5 cell and the bursty open-loop cell on the host at a
small size: a sound run is correct, the control and a planted fault are
not; the configuration's work count, its reference's independence, and
the burst schedule's draw."""
import ast
import json
import pathlib
import time

import pytest
import torch

from chipbench import harness, reference_resnet, run

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
RESNET = "resnet50-v1.5.infer-b128"
BURSTY = "vgg16-t1.open-bursty"
CPU = torch.device("cpu")
SEED = 2 ** 33 + 303


@pytest.fixture
def small_resnet(small):
    """The ResNet cell shrunk as every cell is (1/7 of the image side,
    widths / 8, batch 2), its classifier's input with it."""
    cell, cfg = small(RESNET)
    cfg["classifier"]["in"] = cfg["layers"][-1]["Cout"]
    return cell, cfg


def _window(cell, cfg, seconds=0.3):
    drv = harness.driver_for(cell)
    ctx = harness.Context(cell=cell, cfg=cfg, seed=SEED, seconds=seconds,
                          device=CPU)
    state = drv.setup(ctx)
    ctx.deadline = time.perf_counter() + seconds
    rec = drv.window(ctx, state)
    drv.free(state)
    return drv, ctx, state, rec


def test_resnet_sound_run_is_correct(small_resnet):
    out = run.execute(*small_resnet, BENCH, seed=SEED, seconds=0.3,
                      trace=0, device=CPU)
    assert out["correct"], out["checks"]
    assert out["metrics"]["infer_img_s"]["value"] > 0


def test_resnet_control_and_fault_fail(small_resnet, monkeypatch):
    cell, cfg = small_resnet
    drv, ctx, state, rec = _window(cell, cfg)
    limit = cell["limits"]["out_err"]
    assert drv.check(ctx, state, rec)["out_err"] < limit
    assert drv.control(ctx, state, rec)["out_err"] > limit
    assert rec["attempted"] >= 1 and len(rec["calls"]) == 13
    assert all(c["layer"]["stride"] == 1 and c["layer"]["k"] == 3
               for c in rec["calls"])

    from repro_torch.conv.plan import PreparedConv
    call = PreparedConv.__call__

    def altered(self, x, **kw):          # the last conv's answer moved
        y = call(self, x, **kw)
        if self.plan.epilogue.residual and self.plan.spec.Cout == \
                cfg["layers"][-1]["Cout"]:
            y = y.clone()
            y.view(-1)[0] += 1e-3 * y.abs().max()
        return y
    monkeypatch.setattr(PreparedConv, "__call__", altered)
    drv, ctx, state, rec = _window(cell, cfg)
    assert drv.check(ctx, state, rec)["out_err"] > limit


def test_program_is_the_configuration(small_resnet):
    from repro_torch.models import resnet
    drv = harness.driver_for(harness.load_cell(RESNET)[0])
    cfg = harness.load_json("configs", "resnet50-v1.5")
    drv._check_topology(cfg, resnet)
    drv._check_topology(small_resnet[1], resnet)
    cfg["layers"][10]["stride"] = 2
    with pytest.raises(RuntimeError, match="conv 10"):
        drv._check_topology(cfg, resnet)


def test_resnet_flops():
    """4.1 GMACs an image (He et al.'s 3.8 GFLOPs counts multiply-adds
    once and leaves out the classifier and the projections' share)."""
    cfg = harness.load_json("configs", "resnet50-v1.5")
    macs = reference_resnet.model_flops(cfg, 1) / 2
    assert abs(macs / 4.1e9 - 1) < 0.02
    assert reference_resnet.model_flops(cfg, 128) == 128 * 2 * macs
    assert len(reference_resnet.fft_layers(cfg)) == 13


def test_resnet_reference_matches_the_ports():
    """Two independent plain references, the benchmark's (walked from the
    configuration file) and the port's tests' (walked from torchvision's
    names), agree on the same parameters."""
    from conftest import shrink
    from repro_torch.models import resnet_reference
    cell, cfg = shrink(*harness.load_cell(RESNET))
    cfg["classifier"]["in"] = cfg["layers"][-1]["Cout"]
    p = reference_resnet.make_params(cfg, SEED, CPU)
    x = torch.randn(2, 3, 32, 32, generator=torch.Generator().manual_seed(3))
    a = reference_resnet.forward(cfg, p, x)
    b = resnet_reference.forward(p, x)
    assert ((a - b).abs().max() / b.abs().max()).item() < 1e-6


def test_resnet_reference_imports_nothing_of_the_program():
    tree = ast.parse((ROOT / "chipbench" / "reference_resnet.py")
                     .read_text())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            tops.add(node.module.split(".")[0])
    assert tops <= {"__future__", "math", "torch", "chipbench"}


def test_direct_share_reads_cudnn_kernels_only():
    conv = ("sm80_xmma_fprop_implicit_gemm_f32f32_f32f32_f32_nchwkcrs_nchw"
            "_tilesize128x128x8_stage3_execute_kernel__5x_cudnn")
    events = [
        {"cat": "user_annotation", "name": "cb:window", "ts": 0, "dur": 100},
        {"cat": "kernel", "name": conv, "ts": 0, "dur": 30},
        {"cat": "kernel", "name": "void cgemm_kernel<float, 64>(float*)",
         "ts": 30, "dur": 20},
        {"cat": "kernel", "name": "void at::native::elementwise_kernel<>()",
         "ts": 50, "dur": 10}]
    tr = harness.trace_from_events(events)
    r = harness.reader_for("direct_share.resnet")
    assert r(harness.Run(cell={}, cfg={}, rec={}, trace=tr)) == \
        pytest.approx(50.0)
    tr = harness.trace_from_events(events[:1] + events[2:])
    assert r(harness.Run(cell={}, cfg={}, rec={}, trace=tr)) is None


# --------------------------------------------------------------------------
# The bursty open loop
# --------------------------------------------------------------------------

def bursty():
    return harness.load_module("traffic", "open_bursty")


def test_burst_schedule_offers_the_same_requests_for_every_seed():
    cell, _ = harness.load_cell(BURSTY)
    a = bursty().schedule(cell["traffic"], 10.0, SEED)
    b = bursty().schedule(cell["traffic"], 10.0, SEED + 1)
    assert a == bursty().schedule(cell["traffic"], 10.0, SEED)
    assert a != b and len(a) == len(b)
    assert sorted(n for _, n in a) == sorted(n for _, n in b)
    in_burst = [sum((t % 0.5) < 0.05 for t, _ in s) for s in (a, b)]
    assert in_burst[0] == in_burst[1]
    assert all(0 <= t < 10.0 and 1 <= n <= 8 for t, n in a)


def test_bursts_at_their_rates():
    """Within the bursts the rate is ``burst_factor`` times that between
    them, and the mean over the window is ``rate_rps``."""
    tr = dict(harness.load_cell(BURSTY)[0]["traffic"], rate_rps=200.0)
    s = bursty().schedule(tr, 50.0, SEED)
    low, high = bursty().rates(200.0, 0.5, 0.05, 10.0)
    assert high == pytest.approx(10 * low)
    n_burst = sum((t % 0.5) < 0.05 for t, _ in s)
    assert abs(n_burst / (100 * 0.05) / high - 1) < 0.1
    assert abs((len(s) - n_burst) / (100 * 0.45) / low - 1) < 0.1
    assert abs(len(s) / 50.0 / 200.0 - 1) < 0.06


def test_bursty_cell_reads_the_sustained_rate():
    t = harness.load_cell(BURSTY)[0]["traffic"]
    assert t["rate_rps"] == pytest.approx(t["load"] * t["sustained_rps"])
    ragged = harness.load_cell("vgg16-t1.open-ragged")[0]["traffic"]
    for k in ("max_batch", "batch_window_ms", "sample"):
        assert t[k] == ragged[k]


def test_bursty_sound_run_is_correct(small):
    cell, cfg = small(BURSTY)
    out = run.execute(cell, cfg, BENCH, seed=SEED, seconds=0.5, trace=0,
                      device=CPU)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert out["metrics"]["req_p95_ms"]["value"] > 0
