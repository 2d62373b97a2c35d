"""chipbench.spans on recorded events: device operations named by the
program's ``rt:`` span that launched them, through the runtime call's
correlation id and thread; the readings it gives; and the harness's own
reduction of the same window unchanged by the program's events."""
import pytest

from chipbench import harness, spans
from chipbench.metrics import glue_share, idle_share

MAIN, BWD = 11, 22          # the host thread and autograd's device thread


def _x(name, cat, ts, dur, tid=MAIN, **args):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
         "pid": 1, "tid": tid}
    if args:
        e["args"] = args
    return e


def _span(name, ts, dur, tid=MAIN):
    return _x(name, "user_annotation", ts, dur, tid)


def _launch(corr, ts, tid=MAIN, name="cudaLaunchKernel"):
    return _x(name, "cuda_runtime", ts, 2, tid, correlation=corr)


def _kernel(name, corr, ts, dur):
    return _x(name, "kernel", ts, dur, tid=7, correlation=corr)


COPY = "void at::native::elementwise_kernel_128<direct_copy_kernel_cuda>"

# the harness's window and spans, and the device operations: what a
# program without spans leaves in a trace
BASE = [
    _span("cb:window", 0, 1000),
    _span("cb:forward", 5, 90),
    _span("cb:backward", 100, 500),
    _span("cb:drain", 700, 200),
    _kernel(COPY, 9, 120, 5),                    # copy/kernel
    _kernel(COPY, 7, 130, 25),                   # copy/planes
    _kernel(COPY, 8, 160, 15),                   # copy/assemble
    _kernel(COPY, 1, 400, 50),                   # copy/tiles in vjp/dx
    _kernel(COPY, 2, 460, 30),                   # copy/spectra in vjp/dx
    _kernel("rfwd16_kernel<true>", 3, 500, 20),  # stage/input in vjp/dx
    _kernel("sm80_xmma_gemm_f32", 4, 530, 40),   # vjp/dk
    _kernel("cgemm_kernel<1>", 5, 750, 60),      # a graph replay
    _kernel(COPY, 5, 820, 20),                   # the same replay
    _kernel(COPY, 6, 60, 10),                    # launched under no span
    _kernel(COPY, 99, 1200, 10),                 # after the window
]
# what the program adds: its spans and the runtime calls
PROGRAM = [
    _span("rt:stage/kernel", 8, 10),
    _span("rt:copy/kernel", 10, 5),
    _span("rt:stage/inverse", 20, 30),
    _span("rt:copy/planes", 20, 8),
    _span("rt:copy/assemble", 40, 5),
    _span("rt:vjp/dx", 100, 200, BWD),
    _span("rt:stage/input", 110, 40, BWD),
    _span("rt:copy/tiles", 112, 8, BWD),
    _span("rt:copy/spectra", 130, 10, BWD),
    _span("rt:vjp/dk", 300, 50, BWD),
    _span("rt:vjp/act", 700, 60, BWD),         # another thread at 725
    _span("rt:serve/batch", 700, 200),
    _span("rt:serve/form", 700, 10),
    _span("rt:serve/copy_in", 710, 10),
    _span("rt:serve/replay", 720, 10),
    _span("rt:serve/copy_out", 730, 10),
    _span("rt:serve/sync", 740, 150),
    _span("rt:serve/batch", 905, 5),           # a turn without a batch
    _span("rt:serve/form", 905, 5),
    _launch(9, 12), _launch(7, 25), _launch(8, 42),
    _launch(1, 115, BWD), _launch(2, 135, BWD), _launch(3, 145, BWD),
    _launch(4, 320, BWD), _launch(5, 725, name="cudaGraphLaunch"),
    _launch(6, 55),
]
TOTAL = 5 + 25 + 15 + 50 + 30 + 20 + 40 + 60 + 20 + 10    # 275 us


@pytest.fixture
def sites():
    return spans.sites_from_events(BASE + PROGRAM)


def test_self_against_inclusive(sites):
    own = spans.self_seconds(sites)
    assert own["copy/tiles"] == pytest.approx(50e-6)
    assert own["stage/input"] == pytest.approx(20e-6)
    assert "vjp/dx" not in own           # it launched nothing itself
    assert own["none"] == pytest.approx(10e-6)
    inc = spans.inclusive_seconds(sites)
    assert inc["vjp/dx"] == pytest.approx((50 + 30 + 20) * 1e-6)
    assert inc["stage/input"] == pytest.approx(100e-6)
    assert inc["stage/inverse"] == pytest.approx(40e-6)
    assert sum(own.values()) == pytest.approx(TOTAL * 1e-6)


def test_a_graph_launch_names_its_span_on_its_own_thread(sites):
    # vjp/act covers 725 on the backward thread, not on the launching one
    own = spans.self_seconds(sites)
    assert own["serve/replay"] == pytest.approx(80e-6)
    assert "vjp/act" not in own
    assert [s.name for s in sites.launched_under[7]] == [
        "rt:serve/batch", "rt:serve/replay"]


def test_readings(sites):
    r = spans.readings(sites)
    assert r["in_copy_share"] == pytest.approx(100 * 80 / TOTAL)
    assert r["out_copy_share"] == pytest.approx(100 * 40 / TOTAL)
    assert r["kernel_copy_share"] == pytest.approx(100 * 5 / TOTAL)
    assert r["dx_ms"] == pytest.approx(100e-3)        # one step
    assert r["dk_ms"] == pytest.approx(40e-3)
    assert r["batch_host_ms"] == pytest.approx((200 - 150) * 1e-3)
    assert r["attributed_share"] == pytest.approx(100 * (TOTAL - 10) / TOTAL)


def test_copy_kernels_by_site(sites):
    ck = spans.copy_kernels(sites)
    assert ck["share"] == pytest.approx(100 * 155 / TOTAL)
    assert ck["by_site"]["copy/tiles"] == pytest.approx(50e-6)
    assert ck["by_site"]["serve/replay"] == pytest.approx(20e-6)


def test_idle_program(sites):
    # device busy 60-70, 120-125, 130-155, 160-175, 400-450, 460-490,
    # 500-520, 530-570, 750-810, 820-840 of 0-1000; a gap is named at its
    # middle, the backward's by the spans of the backward's thread
    assert dict(spans.idle_program(sites)) == pytest.approx({
        "forward/stage/inverse": 60e-6, "forward": 50e-6,
        "backward/stage/input": 5e-6, "backward/vjp/dx": 230e-6,
        "backward": 30e-6, "idle": 340e-6, "drain/serve/sync": 10e-6})


def test_traced_images_s(sites):
    cell = {"traffic": {"driver": "train_step", "batch": 32}}
    assert spans.traced_images_s(sites, cell, {}) == pytest.approx(
        32 / 1000e-6)


def test_harness_reads_the_window_alike_with_the_program_events():
    alone, full = (harness.trace_from_events(BASE),
                   harness.trace_from_events(BASE + PROGRAM))
    assert alone == full
    assert alone.top_ops() == full.top_ops()
    assert alone.idle_gaps() == full.idle_gaps()
    for reader in (glue_share.read, idle_share.read):
        assert reader(harness.Run({}, {}, {}, alone)) == \
            reader(harness.Run({}, {}, {}, full))


def test_a_program_without_spans_reads_nothing():
    sites = spans.sites_from_events(BASE)
    assert set(spans.readings(sites).values()) == {None}
    idle = spans.idle_program(sites)
    assert sorted(idle) == sorted(
        harness.trace_from_events(BASE).idle_gaps())
