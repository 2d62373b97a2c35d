"""The trace reduction and every per-layer reader's arithmetic on a small
recorded trace."""
import pytest

from chipbench import harness, work

CG = "void cgemm_kernel<float, 128, 64, 16, 8, 4, true>(float const*)"
FW = "void rfwd16_kernel<true>(float const*, float*, float*)"
INV = "void rinv16_kernel<8, true, true>(float const*, float const*)"
CP = "void at::native::elementwise_kernel<128, 4>(int, Foo)"

# a window of 100 us: [10, 30) cgemm, [25, 40) copy (overlapping on a
# second stream), [50, 60) forward DFT, [70, 75) inverse DFT, one kernel
# before the window and one host span over each gap
EVENTS = [
    {"cat": "user_annotation", "name": "cb:window", "ts": 1000, "dur": 100},
    {"cat": "kernel", "name": CG, "ts": 1010, "dur": 20},
    {"cat": "kernel", "name": CP, "ts": 1025, "dur": 15},
    {"cat": "kernel", "name": FW, "ts": 1050, "dur": 10},
    {"cat": "gpu_memcpy", "name": "Memcpy DtoD", "ts": 1070, "dur": 5},
    {"cat": "kernel", "name": INV, "ts": 1070, "dur": 5},
    {"cat": "kernel", "name": CG, "ts": 900, "dur": 50},
    {"cat": "gpu_user_annotation", "name": "cb:window", "ts": 1000,
     "dur": 100},
    {"cat": "user_annotation", "name": "cb:drain", "ts": 1000, "dur": 45},
    {"cat": "user_annotation", "name": "cb:submit", "ts": 1040, "dur": 3},
    {"cat": "user_annotation", "name": "cb:make input", "ts": 1060,
     "dur": 20},
    {"cat": "cpu_op", "name": "aten::mm", "ts": 1001, "dur": 2},
]


@pytest.fixture
def tr():
    return harness.trace_from_events(EVENTS)


def test_union_not_sum(tr):
    assert tr.window_s == pytest.approx(100e-6)
    assert tr.intervals() == [(1010, 40 + 1000), (1050, 1060),
                              (1070, 1075)]
    assert tr.busy_s() == pytest.approx(45e-6)       # not 20 + 15 + ...
    assert tr.op_seconds() == pytest.approx(55e-6)


def test_idle_gaps_labelled_by_innermost_span(tr):
    gaps = dict(tr.idle_gaps())
    # gaps [1000,1010) and [1040,1050) under drain (its end, 1045, is the
    # second's middle; submit ends before it); [1060,1070) under make
    # input; the middle of [1075,1100) under no span
    assert gaps["drain"] == pytest.approx(20e-6)
    assert gaps["make input"] == pytest.approx(10e-6)
    assert gaps["idle"] == pytest.approx(25e-6)
    assert sum(gaps.values()) == pytest.approx(tr.window_s - tr.busy_s())


def test_top_ops(tr):
    top = tr.top_ops()
    assert top[0] == [CG[:120], pytest.approx(20e-6)]
    assert len(top) == 5


def run_of(tr, rec=None):
    layer = {"name": "v", "C": 64, "Cout": 64, "H": 224, "W": 224, "k": 3,
             "pad": 1}
    rec = rec or {"calls": [{"layer": layer, "batch": 2, "n": 1,
                             "pass": "fwd"}], "model_flops": 4.95e9}
    return harness.Run(cell={}, cfg={}, rec=rec, trace=tr), layer


def test_idle_and_glue_shares(tr):
    run, _ = run_of(tr)
    assert harness.reader_for("idle_share.infer")(run) == pytest.approx(55)
    # 15 us of copy and 5 of memcpy among 55 us of operations
    assert harness.reader_for("glue_share.infer")(run) == \
        pytest.approx(100 * 20 / 55)


def test_rooflines(tr):
    run, layer = run_of(tr)
    cg = work.least_s(*work.cgemm_work(layer, 2))
    assert harness.reader_for("cgemm_roofline.train")(run) == \
        pytest.approx(100 * cg / 20e-6)
    dft = work.least_s(*work.dft_forward_work(layer, 2)) + \
        work.least_s(*work.dft_inverse_work(layer, 2))
    assert harness.reader_for("dft_roofline.layers")(run) == \
        pytest.approx(100 * dft / 15e-6)


def test_mfu(tr):
    run, _ = run_of(tr)
    assert harness.reader_for("mfu.infer")(run) == \
        pytest.approx(100 * 4.95e9 / (100e-6 * 495e12))


def test_missing_kernels_read_nothing(capsys):
    tr = harness.trace_from_events([e for e in EVENTS
                                    if e["name"] not in (CG, FW, INV)])
    run, _ = run_of(tr)
    assert harness.reader_for("cgemm_roofline.infer")(run) is None
    assert harness.reader_for("dft_roofline.infer")(run) is None
    assert "no CGEMM kernel" in capsys.readouterr().err
    empty = harness.Run(cell={}, cfg={}, rec={}, trace=None)
    for m in ("idle_share.x", "glue_share.x", "mfu.x", "queue_wait_ms.x",
              "occupancy.x", "bwd_ms.x", "cgemm_roofline.x"):
        assert harness.reader_for(m)(empty) is None


def test_batcher_and_backward_readers():
    run = harness.Run(cell={}, cfg={}, trace=None, rec={
        "queue_wait_s": [0.001, 0.003, 0.002], "real_rows": 30,
        "padded_rows": 40, "bwd_ms": [70.0, 80.0]})
    assert harness.reader_for("queue_wait_ms.open")(run) == \
        pytest.approx(2.0)
    assert harness.reader_for("occupancy.open")(run) == pytest.approx(75.0)
    assert harness.reader_for("bwd_ms.train")(run) == pytest.approx(75.0)


def test_hand_kernel_names():
    assert harness.is_kernel("cgemm")(CG)
    assert harness.is_kernel("dft")(FW) and harness.is_kernel("dft")(INV)
    assert not harness.is_kernel("hand")(CP)
    assert harness.is_kernel("dft")("void rinv_kernel<float>(float*)")
    assert not harness.is_kernel("dft")("void rinv16_kernelx()")


def test_open_loop_readers():
    run = harness.Run(cell={}, cfg={}, trace=None, rec={
        "latency_s": [0.010, 0.030, 0.020, 0.040],
        "late_s": [0.0] * 19 + [0.005]})
    assert harness.reader_for("req_p50_ms.open")(run) == pytest.approx(25.0)
    # nearest rank: the 19th of 20
    assert harness.reader_for("late_ms.open")(run) == pytest.approx(0.0)
    run.rec["late_s"] = [0.0] * 18 + [0.004, 0.005]
    assert harness.reader_for("late_ms.open")(run) == pytest.approx(4.0)
