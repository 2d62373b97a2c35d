"""What every cell shares: finding its files by name, the run's context,
spans, the device's description, and the reduction of a profiler trace to
device busy time, device operations and idle gaps.

Imports nothing of the program at module level: the CPU tests import this
module, and ``run.py`` puts the program's ``src`` on the path first.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import math
import pathlib
import subprocess
import sys
import time
from typing import Any, Optional

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")   # whole top-level names


def load_json(kind: str, name: str) -> dict:
    """``chipbench/<kind>/<name>.json``: a configuration or a workload."""
    path = HERE / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    return json.loads(path.read_text())


def load_cell(name: str) -> tuple:
    """(workload, configuration) of the cell ``name``."""
    cell = load_json("workloads", name)
    if cell["name"] != name:
        raise ValueError(f"{name}: the file names {cell['name']!r}")
    return cell, load_json("configs", cell["config"])


def load_module(kind: str, name: str):
    """``chipbench/<kind>/<name>.py`` as a module (names may hold dots and
    dashes, so it is loaded from its path)."""
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} module {name!r} ({path})")
    key = f"chipbench.{kind}.{name}"
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


def reader_for(metric: str):
    """The reader of a per-layer metric ``<base>`` or ``<base>.<cells>``:
    ``metrics/<base>.py``'s ``read(run)``."""
    return load_module("metrics", metric.split(".")[0]).read


def driver_for(cell: dict):
    return load_module("traffic", cell["traffic"]["driver"])


class ForbiddenModule(RuntimeError):
    """The run loaded JAX or the JAX package."""


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


# --------------------------------------------------------------------------
# The run's context
# --------------------------------------------------------------------------

@dataclasses.dataclass
class Context:
    """What a traffic driver is given: its cell, configuration, seed,
    window length, device, and whether the window is traced."""
    cell: dict
    cfg: dict
    seed: int
    seconds: float
    device: Any
    trace: bool = False
    deadline: float = math.inf      # set when the window opens
    t_start: float = dataclasses.field(default_factory=time.perf_counter)

    @property
    def traffic(self) -> dict:
        return self.cell["traffic"]

    def span(self, name: str):
        """A host span around a call into the program, recorded in the
        profiler's trace when the window is traced."""
        if not self.trace:
            return contextlib.nullcontext()
        import torch
        return torch.profiler.record_function(f"cb:{name}")

    def stamp(self, label: str) -> None:
        """Log how far set-up has come: seconds since ``t_start``."""
        log(f"setup: {label} at {time.perf_counter() - self.t_start:.3f} s")

    def sync(self) -> None:
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def time_left(self) -> bool:
        return time.perf_counter() < self.deadline


def mix_seed(seed: int, *salt: int) -> int:
    """A 63-bit seed from the run's seed and a salt: the same pair gives
    the same stream on every device."""
    h = seed & (2 ** 64 - 1)
    for s in salt:
        h = (h * 6364136223846793005 + 1442695040888963407 + s) \
            & (2 ** 64 - 1)
    return h & (2 ** 63 - 1)


# --------------------------------------------------------------------------
# The device
# --------------------------------------------------------------------------

def power_limit() -> Optional[str]:
    """The card's power limit as ``nvidia-smi`` reads it, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip() or None


def device_record(device, peak_bytes: int) -> dict:
    import torch
    return {"platform": "gpu" if device.type == "cuda" else device.type,
            "kind": (torch.cuda.get_device_name(device)
                     if device.type == "cuda" else "cpu"),
            "count": 1, "memory_peak_bytes": int(peak_bytes)}


# --------------------------------------------------------------------------
# The traced window
# --------------------------------------------------------------------------

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW_SPAN = "cb:window"


@dataclasses.dataclass
class Trace:
    """A traced window: device operations ``(name, start_us, dur_us)`` that
    started inside it, host spans ``(name, start_us, dur_us)``, and its
    bounds in the trace's microseconds."""
    ops: list
    spans: list
    t0: float
    t1: float

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def intervals(self) -> list:
        """The union of the device operations' intervals, clipped to the
        window, as sorted disjoint ``(start, end)`` pairs."""
        ivs = sorted((max(s, self.t0), min(s + d, self.t1))
                     for _, s, d in self.ops)
        out = []
        for s, e in ivs:
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [tuple(iv) for iv in out]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.intervals()) * 1e-6

    def op_seconds(self, match=None) -> float:
        """Summed device time of the operations whose name ``match``
        accepts (all of them by default)."""
        return sum(d for n, _, d in self.ops
                   if match is None or match(n)) * 1e-6

    def top_ops(self, n: int = 10) -> list:
        by: dict = {}
        for name, _, d in self.ops:
            by[name] = by.get(name, 0.0) + d * 1e-6
        return [[k[:120], v] for k, v in
                sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> list:
        """Idle device time inside the window, summed by what the host was
        doing: the innermost harness span covering the middle of each gap
        (``idle`` where none did)."""
        edges, prev = [], self.t0
        for s, e in self.intervals():
            if s > prev:
                edges.append((prev, s))
            prev = e
        if self.t1 > prev:
            edges.append((prev, self.t1))
        spans = sorted((s for s in self.spans if s[0] != WINDOW_SPAN),
                       key=lambda s: s[1])
        by: dict = {}
        for a, b in edges:
            mid, label, width = (a + b) / 2, "idle", math.inf
            for name, s, d in spans:
                if s > mid:
                    break
                if s + d >= mid and d < width:
                    label, width = name[3:], d
            by[label] = by.get(label, 0.0) + (b - a) * 1e-6
        return [[k, v] for k, v in
                sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def trace_from_events(events: list) -> Trace:
    """A ``Trace`` from the ``traceEvents`` of a Chrome trace that holds one
    ``cb:window`` span."""
    wins = [e for e in events if e.get("name") == WINDOW_SPAN
            and e.get("cat") == "user_annotation"]
    if len(wins) != 1:
        raise RuntimeError(f"the trace holds {len(wins)} window spans")
    t0 = float(wins[0]["ts"])
    t1 = t0 + float(wins[0]["dur"])
    ops, spans = [], []
    for e in events:
        cat, ts = e.get("cat"), e.get("ts")
        if ts is None or "dur" not in e:
            continue
        ts, dur = float(ts), float(e["dur"])
        if cat in DEVICE_CATS and t0 <= ts < t1:
            ops.append((e.get("name", "?"), ts, dur))
        elif cat == "user_annotation" and \
                str(e.get("name", "")).startswith("cb:"):
            spans.append((e["name"], ts, dur))
    return Trace(ops=ops, spans=spans, t0=t0, t1=t1)


def read_chrome_trace(prof, tmpdir: pathlib.Path) -> Trace:
    """Export the profiler's trace to a file under ``tmpdir``, read it
    back, and delete it."""
    tmpdir.mkdir(parents=True, exist_ok=True)
    path = tmpdir / f"chipbench-trace-{time.time_ns()}.json"
    try:
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    finally:
        path.unlink(missing_ok=True)
    return trace_from_events(events)


@dataclasses.dataclass
class Run:
    """What a per-layer metric's reader reads: the cell, its
    configuration, the driver's records of the window, and the trace."""
    cell: dict
    cfg: dict
    rec: dict
    trace: Optional[Trace]


# the hand kernels' device names, by role (the program's kernel names)
HAND_KERNELS = {
    "cgemm": ("cgemm_kernel",),
    "dft": ("rfwd_kernel", "rfwd16_kernel", "rinv_kernel", "rinv16_kernel"),
}


def is_kernel(role: str):
    """A name test for the hand kernels of ``role`` (``cgemm``, ``dft``,
    or ``hand`` for all seven)."""
    import re
    names = (HAND_KERNELS["cgemm"] + HAND_KERNELS["dft"]
             if role == "hand" else HAND_KERNELS[role])
    pat = re.compile(r"\b(" + "|".join(names) + r")\b")
    return lambda n: bool(pat.search(n))
