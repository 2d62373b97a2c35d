"""The program's own spans in a traced window: which ``rt:`` span of the
port launched each device operation, and the per-layer readings that
follow from it.

A device operation is tied to the runtime call that launched it by the
``correlation`` id both carry in the Chrome trace; the operations of a
CUDA graph carry the id of the ``cudaGraphLaunch`` that replayed them.
An operation is named by the innermost ``rt:`` span covering that call
on the launching thread (self attribution), and counted under every span
covering it (inclusive attribution).

    python3 -m chipbench.spans --workload <cell> --seed <n> --seconds <s>

runs the cell once, traced, as ``chipbench.run`` does, and prints its
result line with one more object, ``program_spans``: the readings below,
the device seconds by site, and the share of device time launched under
some span.  On a program without ``rt:`` spans every reading is null.

Imports nothing of the program at module level, as ``harness``.
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import json
import statistics
import sys
from typing import Optional

from chipbench import harness

PREFIX = "rt:"
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
SPAN_CATS = ("cpu_op", "user_annotation")     # the program's fast ranges
IN_COPIES = ("copy/tiles", "copy/spectra")
OUT_COPIES = ("copy/planes", "copy/assemble")
KERNEL_COPIES = ("copy/kernel",)


@dataclasses.dataclass
class Span:
    name: str
    ts: float
    dur: float
    tid: object

    @property
    def end(self) -> float:
        return self.ts + self.dur


@dataclasses.dataclass
class Op:
    """A device operation of the window and the runtime call that
    launched it (``launch_ts`` None where the trace holds none)."""
    name: str
    ts: float
    dur: float
    launch_ts: Optional[float] = None
    launch_tid: object = None


@dataclasses.dataclass
class Sites:
    """A traced window as ``harness.trace_from_events`` reads it, with the
    program's spans, the harness's spans with their threads, and each
    device operation with its launch."""
    trace: harness.Trace
    spans: list            # rt: spans
    host: list             # cb: spans
    ops: list              # Op, the trace's device operations in order

    def covering(self, points, spans=None) -> list:
        """For each ``(tid, t)`` the ``rt:`` spans (or ``spans``) of that
        thread that cover ``t``, outermost first."""
        by_tid = collections.defaultdict(list)
        for s in self.spans if spans is None else spans:
            by_tid[s.tid].append(s)
        out = [()] * len(points)
        order = sorted(range(len(points)), key=lambda i: (
            str(points[i][0]), points[i][1]))
        stacks: dict = {}
        for tid, group in by_tid.items():
            group.sort(key=lambda s: (s.ts, -s.dur))
            stacks[tid] = [group, 0, []]        # spans, next, open stack
        for i in order:
            tid, t = points[i]
            if t is None or tid not in stacks:
                continue
            group, nxt, stack = stacks[tid]
            while nxt < len(group) and group[nxt].ts <= t:
                s = group[nxt]
                while stack and stack[-1].end < s.ts:
                    stack.pop()
                stack.append(s)
                nxt += 1
            while stack and stack[-1].end < t:
                stack.pop()
            stacks[tid][1] = nxt
            out[i] = tuple(s for s in stack if s.ts <= t <= s.end)
        return out

    def innermost(self, spans, ts) -> list:
        """For each time of ``ts`` the shortest of ``spans`` covering it,
        on any thread (None where none does)."""
        best = [None] * len(ts)
        for tid in {s.tid for s in spans}:
            for i, cov in enumerate(self.covering([(tid, t) for t in ts],
                                                  spans)):
                if cov and (best[i] is None or cov[-1].dur < best[i].dur):
                    best[i] = cov[-1]
        return best

    @functools.cached_property
    def launched_under(self) -> list:
        """For each operation the spans covering its launch, outermost
        first."""
        return self.covering([(o.launch_tid, o.launch_ts) for o in self.ops])


def sites_from_events(events: list) -> Sites:
    tr = harness.trace_from_events(events)
    launch = {}
    for e in events:
        if e.get("cat") in LAUNCH_CATS and "ts" in e:
            c = (e.get("args") or {}).get("correlation")
            if c is not None:
                launch[c] = (float(e["ts"]), e.get("tid"))
    ops, spans, host = [], [], []
    for e in events:
        cat, ts = e.get("cat"), e.get("ts")
        if ts is None or "dur" not in e:
            continue
        ts, dur = float(ts), float(e["dur"])
        name = str(e.get("name", "?"))
        if cat in harness.DEVICE_CATS and tr.t0 <= ts < tr.t1:
            c = (e.get("args") or {}).get("correlation")
            lt, tid = launch.get(c, (None, None))
            ops.append(Op(name, ts, dur, lt, tid))
        elif cat in SPAN_CATS and name.startswith(PREFIX):
            spans.append(Span(name, ts, dur, e.get("tid")))
        elif cat == "user_annotation" and name.startswith("cb:"):
            host.append(Span(name, ts, dur, e.get("tid")))
    return Sites(trace=tr, spans=spans, host=host, ops=ops)


# --------------------------------------------------------------------------
# Attribution
# --------------------------------------------------------------------------

def self_seconds(sites: Sites) -> dict:
    """Device seconds by the innermost span that launched them (``none``
    for operations launched under no span)."""
    by: dict = collections.Counter()
    for o, cov in zip(sites.ops, sites.launched_under):
        by[cov[-1].name[len(PREFIX):] if cov else "none"] += o.dur * 1e-6
    return dict(by)


def inclusive_seconds(sites: Sites) -> dict:
    """Device seconds by every span covering their launch (a span's name
    counted once an operation, however deep it nests)."""
    by: dict = collections.Counter()
    for o, cov in zip(sites.ops, sites.launched_under):
        for name in {s.name[len(PREFIX):] for s in cov}:
            by[name] += o.dur * 1e-6
    return dict(by)


def _total(sites: Sites) -> float:
    return sum(o.dur for o in sites.ops) * 1e-6


def _has_spans(sites: Sites) -> bool:
    return bool(sites.spans) and bool(sites.ops)


def copy_share(sites: Sites, names) -> Optional[float]:
    """Device time launched directly under the copy sites ``names``, over
    all device operation time of the window, in %."""
    if not _has_spans(sites):
        return None
    by = self_seconds(sites)
    return 100.0 * sum(by.get(n, 0.0) for n in names) / _total(sites)


def attributed_share(sites: Sites) -> Optional[float]:
    """Device time launched under some ``rt:`` span, in %."""
    if not _has_spans(sites):
        return None
    under = sum(o.dur for o, cov in zip(sites.ops, sites.launched_under)
                if cov) * 1e-6
    return 100.0 * under / _total(sites)


def _in_window(sites: Sites, spans, name: str) -> list:
    tr = sites.trace
    return [s for s in spans if s.name == name and tr.t0 <= s.ts < tr.t1]


def per_step_ms(sites: Sites, name: str) -> Optional[float]:
    """Device ms a step launched under span ``name`` (inclusive), over the
    window's ``cb:backward`` spans."""
    steps = len(_in_window(sites, sites.host, "cb:backward"))
    if not steps or not any(s.name == PREFIX + name for s in sites.spans):
        return None
    return inclusive_seconds(sites).get(name, 0.0) * 1e3 / steps


def batch_host_ms(sites: Sites) -> Optional[float]:
    """Median over the window's ``serve/batch`` spans that ran a batch (a
    ``serve/replay`` inside) of their duration less their ``serve/sync``:
    the host's time a batch while it does not wait for the device, ms."""
    batches = _in_window(sites, sites.spans, PREFIX + "serve/batch")
    inner = [s for s in sites.spans
             if s.name in (PREFIX + "serve/replay", PREFIX + "serve/sync")]
    ran, sync = set(), collections.Counter()
    for s, cov in zip(inner, sites.covering([(s.tid, s.ts) for s in inner],
                                            batches)):
        if not cov:
            continue
        if s.name.endswith("serve/replay"):
            ran.add(id(cov[-1]))
        else:
            sync[id(cov[-1])] += s.dur
    vals = [(b.dur - sync[id(b)]) * 1e-3 for b in batches if id(b) in ran]
    return statistics.median(vals) if vals else None


def idle_program(sites: Sites, n: int = 10) -> list:
    """Idle device time in the window, summed by the innermost ``cb:``
    span covering the middle of each gap and the innermost ``rt:`` span
    covering it, on any thread (``drain/serve/sync``; the backward's spans
    run in a thread of their own), as ``harness.Trace.idle_gaps`` sums by
    the first alone."""
    tr = sites.trace
    edges, prev = [], tr.t0
    for s, e in tr.intervals():
        if s > prev:
            edges.append((prev, s))
        prev = e
    if tr.t1 > prev:
        edges.append((prev, tr.t1))
    mids = [(a + b) / 2 for a, b in edges]
    outer = sites.innermost(
        [s for s in sites.host if s.name != harness.WINDOW_SPAN], mids)
    inner = sites.innermost(sites.spans, mids)
    by: dict = collections.Counter()
    for (a, b), o, i in zip(edges, outer, inner):
        label = "idle" if o is None else o.name[3:]
        if o is not None and i is not None:
            label += "/" + i.name[len(PREFIX):]
        by[label] += (b - a) * 1e-6
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def traced_images_s(sites: Sites, cell: dict, cfg: dict) -> Optional[float]:
    """Images a second of the traced window, counted from the harness's
    own spans: a training step is a ``cb:backward``, a sweep the last
    layer's span."""
    t = cell["traffic"]
    if t["driver"] == "train_step":
        span = "cb:backward"
    elif t["driver"] == "layer_sweep":
        span = "cb:" + cfg["layers"][-1]["name"]
    else:
        return None
    n = len(_in_window(sites, sites.host, span))
    return n * t["batch"] / sites.trace.window_s


def readings(sites: Sites) -> dict:
    """Every reading of the window (None where it finds nothing)."""
    return {"in_copy_share": copy_share(sites, IN_COPIES),
            "out_copy_share": copy_share(sites, OUT_COPIES),
            "kernel_copy_share": copy_share(sites, KERNEL_COPIES),
            "dx_ms": per_step_ms(sites, "vjp/dx"),
            "dk_ms": per_step_ms(sites, "vjp/dk"),
            "batch_host_ms": batch_host_ms(sites),
            "attributed_share": attributed_share(sites)}


def copy_kernels(sites: Sites) -> dict:
    """Device seconds of the copy kernels (a name holding ``copy``) by the
    site that launched them, and their share of device time in %."""
    by: dict = collections.Counter()
    for o, cov in zip(sites.ops, sites.launched_under):
        if "copy" in o.name.lower():
            by[cov[-1].name[len(PREFIX):] if cov else "none"] += o.dur * 1e-6
    total = _total(sites)
    return {"share": 100.0 * sum(by.values()) / total if total else None,
            "by_site": dict(by)}


def summary(sites: Sites, cell: dict, cfg: dict) -> dict:
    def ranked(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])]
    return {"readings": readings(sites),
            "self_s": ranked(self_seconds(sites)),
            "inclusive_s": ranked(inclusive_seconds(sites)),
            "copy_kernels": copy_kernels(sites),
            "idle_program": idle_program(sites),
            "traced_images_s": traced_images_s(sites, cell, cfg),
            "device_s": _total(sites),
            "window_s": sites.trace.window_s}


# --------------------------------------------------------------------------
# One traced run
# --------------------------------------------------------------------------

def main(argv=None) -> int:
    from chipbench import run
    args = run.parse(argv)
    cell, cfg = harness.load_cell(args.workload)
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    try:
        device = run.card(cell["chips"])
    except run.NoCard as e:
        harness.log(f"chipbench.spans: {e}")
        return 2
    kept = {}
    reduce = harness.trace_from_events

    def keep(events):
        kept["events"] = events
        return reduce(events)
    harness.trace_from_events = keep
    try:
        out = run.execute(cell, cfg, bench, seed=args.seed,
                          seconds=args.seconds, trace=1, device=device)
    finally:
        harness.trace_from_events = reduce
    out["program_spans"] = summary(sites_from_events(kept.pop("events")),
                                   cell, cfg)
    out["card"] = harness.power_limit()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
