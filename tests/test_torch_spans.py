"""repro_torch.core.trace's spans: each region of the port that launches
device work is named ``rt:<site>`` in a ``torch.profiler`` trace, on the
thread that runs it, and costs one check while no profiler records.

A small ``fft-cuda`` plan (the kernels' plain versions on the CPU), its
plan-level VJP, AdamW and a CPU ``ServeEngine`` run under the profiler
(CPU activity); the Chrome trace it exports is read back as a user of
the profiler would read it.
"""
import json

import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

from repro_torch.conv import Epilogue, NetworkConv, plan_conv, stages
from repro_torch.core import trace
from repro_torch.launch.batcher import BucketPolicy, ServeEngine
from repro_torch.optim import adamw

EP = Epilogue(bias=True, activation="relu")
STAGES = ("stage/input", "stage/kernel", "stage/cgemm", "stage/inverse")
COPIES = ("copy/tiles", "copy/spectra", "copy/kernel", "copy/planes",
          "copy/assemble")
VJP = ("vjp/act", "vjp/dx", "vjp/dk", "vjp/dbias")
SERVE = ("serve/form", "serve/copy_in", "serve/replay", "serve/copy_out",
         "serve/sync")


def _rand(shape, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g)


def _operands(seed=0, grad=False):
    x, k, b = (_rand((2, 3, 12, 12), seed), _rand((4, 3, 3, 3), seed + 1),
               _rand((4,), seed + 2))
    return [t.requires_grad_(grad) for t in (x, k, b)]


def _plan():
    return plan_conv((2, 3, 12, 12), (4, 3, 3, 3), padding=1,
                     backend="fft-cuda", epilogue=EP)


def _profiled(fn, tmp_path):
    """(fn's result, the Chrome trace's complete events) of ``fn`` run
    under the profiler."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X"]
    return out, events


def _spans(events, name=None):
    return [e for e in events if e["name"].startswith("rt:")
            and (name is None or e["name"] == "rt:" + name)]


def _inside(inner, outer) -> bool:
    return (inner["tid"] == outer["tid"] and outer["ts"] <= inner["ts"]
            and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"])


def _train_step():
    x, k, b = _operands(grad=True)
    y = _plan()(x, k, bias=b)
    (y * _rand(y.shape, 9)).sum().backward()
    return y.detach(), x.grad, k.grad, b.grad


def test_stage_and_copy_sites_are_named(tmp_path):
    x, k, b = _operands()
    _, ev = _profiled(lambda: _plan()(x, k, bias=b), tmp_path)
    names = {e["name"][3:] for e in _spans(ev)}
    assert names == set(STAGES) | set(COPIES)
    by = {n: _spans(ev, n) for n in names}
    # each copy site inside the stage op it serves
    for copy, stage in (("copy/tiles", "stage/input"),
                        ("copy/spectra", "stage/input"),
                        ("copy/kernel", "stage/kernel"),
                        ("copy/planes", "stage/inverse"),
                        ("copy/assemble", "stage/inverse")):
        for e in by[copy]:
            assert any(_inside(e, s) for s in by[stage]), copy
    # the fused inverse: two plane transposes and the tile bias
    assert len(by["copy/planes"]) == 3
    assert len(by["copy/kernel"]) == 2       # the pad, then the permute
    # the stage ops of one forward, once each
    assert [len(by[s]) for s in STAGES] == [1, 1, 1, 1]


def test_vjp_spans_run_on_the_backward_thread(tmp_path):
    _, ev = _profiled(_train_step, tmp_path)
    node = [e for e in ev if e["name"].startswith(
        "autograd::engine::evaluate_function: _PipelineConvBackward")]
    assert len(node) == 1
    for name in VJP:
        (s,) = _spans(ev, name)
        assert _inside(s, node[0]), name
    # the dx plan runs the stage graph: its stage ops nest in vjp/dx
    (dx,) = _spans(ev, "vjp/dx")
    inner = {e["name"][3:] for e in _spans(ev) if _inside(e, dx)}
    assert set(STAGES) <= inner
    (dk,) = _spans(ev, "vjp/dk")
    assert not any(_inside(e, dk) for e in _spans(ev, "stage/cgemm"))


def test_optimizer_span(tmp_path):
    params = {"w": _rand((3, 3), 0), "b": _rand((3,), 1)}
    grads = {"w": _rand((3, 3), 2), "b": _rand((3,), 3)}
    cfg = adamw.AdamWConfig(warmup_steps=0)
    state = adamw.adamw_init(params)
    _, ev = _profiled(lambda: adamw.adamw_update(grads, state, params, cfg),
                      tmp_path)
    assert [e["name"] for e in _spans(ev)] == ["rt:optim/adamw"]


def test_pack_span(tmp_path):
    a, b = _rand((5, 2, 3), 0), _rand((5, 2, 3), 1)
    out, ev = _profiled(lambda: stages._pack((a, b), 4), tmp_path)
    assert out.shape == (2, 8, 2, 3)
    assert [e["name"] for e in _spans(ev)] == ["rt:copy/pack"]


def _layers(batch):
    return [NetworkConv("s1", (batch, 2, 8, 8), (4, 2, 3, 3), padding=1),
            NetworkConv("s2", (batch, 4, 8, 8), (4, 4, 3, 3), padding=1)]


def _engine():
    return ServeEngine(_layers, {"s1": _rand((4, 2, 3, 3), 1),
                                 "s2": _rand((4, 4, 3, 3), 2)},
                       policy=BucketPolicy(max_batch=4), backend="fft-cuda",
                       device="cpu")


def _serve(eng):
    for i, rows in enumerate((1, 2, 3, 1)):
        eng.submit(_rand((rows, 2, 8, 8), 10 + i))
    eng.drain(force=True)
    eng.drain()                       # an empty queue: a turn, no batch
    return dict(eng.results)


def test_engine_batch_spans(tmp_path):
    eng = _engine()
    _, ev = _profiled(lambda: _serve(eng), tmp_path)
    batches = [b for b in _spans(ev, "serve/batch")
               if any(_inside(r, b) for r in _spans(ev, "serve/replay"))]
    # rows 1+2 go in a bucket of 4 (3 would overflow it), then 3+1
    assert len(batches) == sum(
        st.n_batches for st in eng._stats.values()) == 2
    for b in batches:
        held = sorted(e["name"][3:] for e in _spans(ev) if _inside(e, b)
                      and e["name"][3:] in SERVE)
        assert held == sorted(SERVE)
    # a turn that forms no batch holds its form alone
    (idle,) = [b for b in _spans(ev, "serve/batch") if b not in batches]
    assert [e["name"] for e in _spans(ev)
            if _inside(e, idle) and e is not idle] == ["rt:serve/form"]
    # the stage graph of a replay runs under it
    for b in _spans(ev, "serve/replay"):
        assert any(_inside(s, b) for s in _spans(ev, "stage/cgemm"))


def test_no_profiler_enters_no_record_function(monkeypatch):
    entered = []
    real = torch._C._profiler._RecordFunctionFast

    def counting(*a, **kw):
        entered.append(a[0])
        return real(*a, **kw)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", counting)
    _train_step()
    _serve(_engine())
    params = {"w": _rand((3,), 0)}
    adamw.adamw_update({"w": _rand((3,), 1)}, adamw.adamw_init(params),
                       params, adamw.AdamWConfig())
    assert entered == []
    assert trace.span("stage/input") is trace.span("serve/batch")
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]):
        _train_step()
    assert "rt:vjp/dx" in entered and "rt:stage/cgemm" in entered


def test_outputs_bit_equal_with_and_without_profiler(tmp_path):
    plain = _train_step()
    profiled, _ = _profiled(_train_step, tmp_path)
    for a, b in zip(plain, profiled):
        assert torch.equal(a, b)
    served = _serve(_engine())
    served_p, _ = _profiled(lambda: _serve(_engine()), tmp_path)
    assert served.keys() == served_p.keys()
    assert all(torch.equal(served[r], served_p[r]) for r in served)


def test_counters_are_reexported_not_copied():
    import repro_torch.conv as conv
    for name in ("_tls", "_count", "stage_trace", "isolated_trace",
                 "active_traces", "counted_in"):
        assert getattr(stages, name) is getattr(trace, name)
    assert conv.stage_trace is trace.stage_trace
    with stages.stage_trace() as counts:
        x, k, b = _operands()
        _plan()(x, k, bias=b)
    assert counts["input_transform"] == counts["cgemm"] == 1


@pytest.mark.cuda
def test_vjp_spans_name_launches_on_the_device_thread(tmp_path):
    """On the card autograd runs the plan's backward in a thread of its
    own: the VJP's spans are on that thread, and the kernels launched
    there fall inside them (joined by the runtime call's correlation)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: only a CUDA backward runs in "
                    "autograd's device thread")
    from torch.profiler import ProfilerActivity, profile
    dev = torch.device("cuda")

    def step():
        x, k, b = [t.to(dev).requires_grad_() for t in _operands()]
        y = _plan()(x, k, bias=b)
        (y * _rand(y.shape, 9).to(dev)).sum().backward()
        torch.cuda.synchronize()
    step()                                   # builds and loads the kernels
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    ev = [e for e in json.loads(path.read_text())["traceEvents"]
          if e.get("ph") == "X"]
    fwd = min(_spans(ev, "stage/input"), key=lambda e: e["ts"])
    (dx,) = _spans(ev, "vjp/dx")
    assert dx["tid"] != fwd["tid"]
    for name in VJP:
        assert _spans(ev, name)[0]["tid"] == dx["tid"], name
    kernels = {e["args"]["correlation"] for e in ev
               if e.get("cat") == "kernel"}
    launched = [e for e in ev if e.get("cat") == "cuda_runtime"
                and _inside(e, dx)
                and e["args"].get("correlation") in kernels]
    assert launched
