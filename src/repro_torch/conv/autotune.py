"""Measured autotuner for the conv engine (``backend="tuned"``).

The cost model behind ``backend="auto"`` ranks candidates by FLOPs, but the
direct/FFT crossover, and the best CUDA CGEMM tile, depend on the machine.
This module *measures* instead:

    from repro_torch.conv import autotune
    winner = autotune.tune(x_shape, k_shape, padding=1)
    # -> TunedConfig(backend='fft-cuda', schedule='local', bm=32, ...)

or, threaded through the planner:

    plan = plan_conv(x_shape, k_shape, padding=1, backend="tuned")

``tune`` times every candidate (backend, schedule, frequency-layout
``spectrum``, sub-slab ``overlap``, CUDA CGEMM tile row ``bm/bn/bk``, the
inverse tile DFT's tiles a block ``dft_bt``) on the device (one warm-up
call, then the median of ``reps`` calls, each between two CUDA events on
the current stream; ``time.perf_counter`` on the CPU) under a wall-clock
budget, and persists the winner in a JSON tuning cache so the tuning cost
is paid once per machine.  Cache entries are keyed by the spec signature
(with the mesh, its axes and the kernel-transform placement) + device
name + torch and CUDA versions + the TF32 switches: a new card, an
upgrade or another precision setting invalidates naturally (old keys
never match).

Candidates are timed through the real planner with a representative
bias+relu epilogue, so the ``fft-cuda`` fused inverse tail is part of the
measurement, and with it ``dft_bt``: local real-spectrum ``fft-cuda``
candidates are timed at ``dft_bt`` ``None`` (the kernel's 8 tiles a
block) and at ``DFT_BT_ALT``, as the reference times ``bt`` at ``None``
and 64, a quarter of its default 256.  ``DFT_BT_ALT`` is 4, the compiled
value below the default, not 16: on an H100 the served fused inverse
took 0.197 ms of device time a pass at 4 tiles a block, 0.205 at 8 and
0.230 at 16, and the other three inverses ranked the same
(``chip_smoke.py`` phase 3, ``PERF.md`` §6).  Only a candidate that the
planner refuses (``ValueError`` or ``NotImplementedError`` from
``plan_conv``) is skipped; an error from a kernel propagates, so a broken
``fft-cuda`` cannot quietly lose to ``direct``.

On a mesh (``tune(..., mesh=)``, ``plan_conv(backend="tuned", mesh=)``)
the candidates are the sharded schedules ``nfft`` and ``wfft`` on
``fft-torch`` and ``fft-cuda`` (and with ``overlap="auto"`` the overlaps
``off``/``slab:2``/``slab:4``), as in the reference.  The reference times
its SPMD program from one controller; here every rank of the mesh is a
process running ``tune`` and every candidate runs collectives, so the
ranks must never diverge (``repro_torch.launch.mesh.RankDecisions``):
rank 0 of the mesh decides whether its cache
answers (its ``TunedConfig`` goes to every rank), whether measurement is
on, the repetitions, and before each candidate whether the budget is
spent; a candidate the planner refuses on any rank is skipped on all; a
candidate's time is the slowest rank's (an all-reduce ``MAX``), so every
rank takes the same argmin; a measurement that raises on one rank raises
on all of them (the others' all-reduce sees it); and only rank 0 writes
the cache file.  Every rank must plan the same layers in the same order,
as it must for the plans themselves.

The tuner measures on the GPU unless the caller asks for the CPU
(``repro_torch.device.resolve_device``): ``tune(..., device=)``, or, for
the planner's calls, the scoped ``with autotune.measure_on(device):``.
Without a GPU and without a request it raises.  A measurement never starts
inside a CUDA graph capture (it synchronizes): tune while planning, before
``ServeEngine.warm()`` captures.

Environment knobs (the port's own names, and its own cache file: the JAX
package's tuner keeps ``REPRO_AUTOTUNE*`` and ``repro_autotune.json``, and
each tuner drops a file of another version, so the two must not share one):

  ``REPRO_TORCH_AUTOTUNE``            "0"/"false"/"off"/"no" disables
                                      measurement; ``tune`` then falls back
                                      to the cost model.  Cache *hits* are
                                      still served.
  ``REPRO_TORCH_AUTOTUNE_CACHE``      cache file path (default
                                      ``~/.cache/repro_torch_autotune.json``).
  ``REPRO_TORCH_AUTOTUNE_BUDGET_MS``  wall-clock tuning budget per spec
                                      (default 2000).  The cost-model pick
                                      is always measured; further
                                      candidates run until the budget is
                                      spent.
  ``REPRO_TORCH_AUTOTUNE_REPS``       timed repetitions per candidate
                                      (default 3, median taken; 1 warm-up
                                      call first).

``python -m repro_torch.conv.autotune --selfcheck [--device cpu]`` tunes
one small spec, drops the in-memory store, re-reads the cache file and
asserts the reloaded winner is identical (write -> reload -> same winner).
"""
from __future__ import annotations

import collections
import contextlib
import contextvars
import dataclasses
import json
import os
import statistics
import threading
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.core.conv_spec import ConvSpec
from repro_torch.conv.plan import (
    _auto_backend, _check_dft_bt, _check_mesh, _cuda_blocks,
    _mesh_cache_key, _normalize_padding)
# shared with the planner so that cache signatures never drift from the
# planner's semantics (repro_torch.conv.plan imports this module only
# inside plan_conv)
from repro_torch.conv.plan import _build_spec as _make_spec
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import RankDecisions

CACHE_VERSION = 2                      # 2: the key holds the mesh too
DFT_BT_ALT = 4                         # the dft_bt axis: None and this

_DEFAULT_CACHE = os.path.join("~", ".cache", "repro_torch_autotune.json")
_DEFAULT_BUDGET_MS = 2000.0
_DEFAULT_REPS = 3

AutotuneInfo = collections.namedtuple(
    "AutotuneInfo", ["hits", "misses", "fallbacks", "measured"])


@dataclasses.dataclass(frozen=True)
class TunedConfig:
    """One (backend, schedule, tile) point of the tuning space.

    ``us_per_call`` is the measured median (``None`` for cost-model
    fallbacks, which are never written to the cache).  ``source`` records
    provenance: ``"measured"`` | ``"cost-model"`` | ``"seeded"``.
    """
    backend: str
    schedule: str
    bm: Optional[int] = None           # CUDA CGEMM tile row (fft-cuda)
    bn: Optional[int] = None
    bk: Optional[int] = None
    dft_bt: Optional[int] = None       # inverse tile DFT tiles a block
    spectrum: str = "real"             # frequency layout (FFT pipelines)
    overlap: str = "off"               # sub-slab overlap (sharded only)
    us_per_call: Optional[float] = None
    source: str = "measured"

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: dict) -> "TunedConfig":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})


# --------------------------------------------------------------------------
# Environment knobs and the measuring device
# --------------------------------------------------------------------------

def cache_path() -> str:
    """Tuning-cache file (env ``REPRO_TORCH_AUTOTUNE_CACHE``)."""
    return os.path.expanduser(
        os.environ.get("REPRO_TORCH_AUTOTUNE_CACHE", _DEFAULT_CACHE))


def autotune_enabled() -> bool:
    """Whether ``tune`` may *measure* (env ``REPRO_TORCH_AUTOTUNE``);
    cache hits are served either way."""
    return os.environ.get("REPRO_TORCH_AUTOTUNE", "1").strip().lower() \
        not in ("0", "false", "off", "no")


def budget_ms() -> float:
    try:
        return float(os.environ.get("REPRO_TORCH_AUTOTUNE_BUDGET_MS",
                                    _DEFAULT_BUDGET_MS))
    except ValueError:
        return _DEFAULT_BUDGET_MS


def _env_reps() -> int:
    try:
        return max(1, int(os.environ.get("REPRO_TORCH_AUTOTUNE_REPS",
                                         _DEFAULT_REPS)))
    except ValueError:
        return _DEFAULT_REPS


_measure_device: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_autotune_device", default=None)


@contextlib.contextmanager
def measure_on(device):
    """Within the block, tuning that names no device (the planner's calls
    from ``plan_conv(backend="tuned")``) measures, and keys its cache, on
    ``device``."""
    token = _measure_device.set(torch.device(device))
    try:
        yield
    finally:
        _measure_device.reset(token)


def _resolve_measure_device(device=None) -> torch.device:
    """``device``, else the scoped ``measure_on`` device, else the GPU
    (raising without one)."""
    if device is None:
        device = _measure_device.get()
    return resolve_device(device)


# --------------------------------------------------------------------------
# Persistent cache store
# --------------------------------------------------------------------------

class TuningCache:
    """JSON-file-backed key -> ``TunedConfig`` store (write-through,
    atomic replace; tolerant of a missing/corrupt/other-version file)."""

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()
        self._entries: dict = self._load()

    def _load(self) -> dict:
        try:
            with open(self.path) as fh:
                data = json.load(fh)
            if not isinstance(data, dict) \
                    or data.get("version") != CACHE_VERSION:
                return {}
            entries = data.get("entries", {})
            return {k: TunedConfig.from_json(v)
                    for k, v in entries.items() if isinstance(v, dict)}
        except (OSError, ValueError, TypeError):
            return {}

    def get(self, key: str) -> Optional[TunedConfig]:
        with self._lock:
            return self._entries.get(key)

    def put(self, key: str, cfg: TunedConfig, flush: bool = True) -> None:
        """Store ``cfg`` under ``key``; ``flush`` writes the file (a rank
        other than a mesh's rank 0 keeps its entries in memory only)."""
        with self._lock:
            self._entries[key] = cfg
            if flush:
                self._flush()

    def _flush(self) -> None:
        payload = {"version": CACHE_VERSION,
                   "entries": {k: v.to_json()
                               for k, v in sorted(self._entries.items())}}
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        tmp = f"{self.path}.tmp.{os.getpid()}"
        with open(tmp, "w") as fh:
            json.dump(payload, fh, indent=1, sort_keys=True)
        os.replace(tmp, self.path)

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)


_lock = threading.RLock()
_stores: dict = {}                      # resolved path -> TuningCache
_hits = _misses = _fallbacks = _measured = 0
_sweeps: list = []                      # one record per measured sweep


def _store() -> TuningCache:
    path = cache_path()
    with _lock:
        store = _stores.get(path)
        if store is None:
            store = _stores[path] = TuningCache(path)
        return store


def autotune_info() -> AutotuneInfo:
    with _lock:
        return AutotuneInfo(_hits, _misses, _fallbacks, _measured)


def sweeps() -> list:
    """One record per sweep that measured since the last ``reset``, in
    order: its cache ``key``, the shapes, ``padding`` and ``delta``, how
    many ``candidates`` the space had and how many the sweep ``reached``
    before the budget stopped it, and the ``measured`` candidates, each
    with its ``us_per_call``, in the order they were timed."""
    with _lock:
        return [dict(r, measured=list(r["measured"])) for r in _sweeps]


def reset() -> None:
    """Drop the in-memory store, counters and sweep records (cache
    *files* are kept: the next ``tune`` re-reads them from disk)."""
    global _hits, _misses, _fallbacks, _measured
    with _lock:
        _stores.clear()
        _sweeps.clear()
        _hits = _misses = _fallbacks = _measured = 0


# --------------------------------------------------------------------------
# Cache keys
# --------------------------------------------------------------------------

def _device_kind(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device).replace("|", "/")
    return device.type


def _torch_version() -> str:
    return torch.__version__


def _cuda_version() -> str:
    return str(torch.version.cuda)


def _tf32_flags() -> str:
    """The TF32 switches: a ``direct`` winner timed with cuDNN's TF32 on
    must not answer for a process that runs with it off."""
    return (f"cudnn:{int(torch.backends.cudnn.allow_tf32)},"
            f"matmul:{int(torch.backends.cuda.matmul.allow_tf32)}")


def _dtype_name(dtype) -> str:
    return "none" if dtype is None else str(dtype).removeprefix("torch.")


def _mesh_signature(mesh) -> str:
    """A mesh by value, as the plan cache keys it: dim names and sizes,
    the ranks in mesh order, the device type."""
    if mesh is None:
        return "none"
    names, shape, ranks, device_type = _mesh_cache_key(mesh)
    axes = ",".join(f"{a}:{n}" for a, n in zip(names, shape))
    return f"{axes};ranks[{','.join(map(str, ranks))}];{device_type}"


def spec_signature(x_shape, k_shape, *, padding=(0, 0), delta: int = 16,
                   schedule: str = "auto", mesh=None, three_m: bool = True,
                   compute_dtype=None, data_axis: str = "data",
                   model_axis: str = "model",
                   replicate_kernel_transform: bool = False,
                   spectrum: str = "auto", overlap: str = "off",
                   bm=None, bn=None, bk=None, dft_bt=None) -> str:
    """Device-independent part of the cache key: the problem + the
    constraints the caller put on the tuner (requested schedule, mesh,
    precision, kernel-transform placement, requested spectrum and overlap,
    pinned tile and ``dft_bt``).  Two calls that could legally get
    different winners must get different signatures: a pin-constrained
    sweep must never answer for an unconstrained one."""
    pad = _normalize_padding(padding)
    return (f"v{CACHE_VERSION}"
            f"|x={tuple(map(int, x_shape))}|k={tuple(map(int, k_shape))}"
            f"|pad={pad}|delta={int(delta)}|sched={schedule}"
            f"|mesh={_mesh_signature(mesh)}|3m={int(bool(three_m))}"
            f"|dtype={_dtype_name(compute_dtype)}"
            f"|axes={data_axis},{model_axis}"
            f"|rkt={int(bool(replicate_kernel_transform))}"
            f"|spec={spectrum}|ov={overlap}"
            f"|pins={bm},{bn},{bk},{dft_bt}")


def cache_key(x_shape, k_shape, *, device=None, **kwargs) -> str:
    """Full cache key: spec signature + device name + torch and CUDA
    versions + TF32 switches, for the measuring device (``device``, else
    the scoped ``measure_on`` device, else the GPU)."""
    dev = _resolve_measure_device(device)
    return (spec_signature(x_shape, k_shape, **kwargs)
            + f"|dev={_device_kind(dev)}|torch={_torch_version()}"
            f"|cuda={_cuda_version()}|tf32={_tf32_flags()}")


# --------------------------------------------------------------------------
# Candidate generation
# --------------------------------------------------------------------------

def _block_candidates(spec: ConvSpec) -> list:
    """(bm, bn, bk) candidates for the CUDA CGEMM: the unpinned point
    (the chooser's row for this M) plus the table rows whose ``bm`` is the
    next smaller and the next larger than that row's (the port's form of
    the reference's half- and double-sized blocks)."""
    from repro_torch.kernels.cgemm.ops import SHAPES, default_shape
    by_bm = sorted(range(len(SHAPES)), key=lambda i: SHAPES[i][0])
    at = by_bm.index(default_shape(spec.M))
    cands = [(None, None, None)]
    for j in (at - 1, at + 1):
        if 0 <= j < len(by_bm):
            cands.append(tuple(SHAPES[by_bm[j]][:3]))
    return cands


def _merge_pins(cand: TunedConfig, blocks: tuple, dft_bt) -> TunedConfig:
    """User pins override candidate values: a pinned tile row replaces
    the candidate's whole triple (the knobs name one row together), a
    pinned ``dft_bt`` its ``dft_bt`` (field by field, as in the
    reference)."""
    if blocks != (None, None, None):
        cand = dataclasses.replace(cand, bm=blocks[0], bn=blocks[1],
                                   bk=blocks[2])
    if dft_bt is not None:
        cand = dataclasses.replace(cand, dft_bt=dft_bt)
    return cand


def candidates(spec: ConvSpec, *, schedule: str = "auto", mesh=None,
               three_m: bool = True, spectrum: str = "auto",
               overlap: str = "off",
               bm=None, bn=None, bk=None, dft_bt=None) -> list:
    """Enumerate the tuning space, cost-model pick first (so a clamped
    budget still measures the sane default), ``fft-cuda`` last (on the CPU
    its kernels run their plain versions, the slowest to time).

    ``schedule="auto"`` means ``local`` without a mesh (backends
    ``direct``, ``fft-torch`` and ``fft-cuda``) and ``nfft`` and ``wfft``
    with one (``fft-torch`` and ``fft-cuda``: ``direct`` has no sharded
    form).  ``spectrum="auto"`` adds a real-vs-complex frequency-layout
    axis for the FFT backends; ``direct`` has no spectrum and is tuned as
    ``"real"`` only; pinning ``spectrum`` collapses the axis.
    ``overlap="auto"`` adds the axis ``off``/``slab:2``/``slab:4`` on the
    sharded schedules; local plans have nothing to overlap.  ``fft-cuda``
    with the real spectrum and no overlap is timed at its unpinned tile
    and at the neighbouring rows of the CGEMM's table
    (``_block_candidates``), on ``local`` each at ``dft_bt`` ``None`` and
    ``DFT_BT_ALT``; overlapped or complex at its unpinned tile only.
    Pins override the candidates' values (then deduplicated)."""
    if schedule != "auto":
        scheds = [schedule]
    else:
        scheds = ["nfft", "wfft"] if mesh is not None else ["local"]
    spectra = ["real", "complex"] if spectrum == "auto" else [spectrum]
    out = []
    for sched in scheds:
        local = sched == "local"
        if local:
            ovs = ["off"] if overlap in ("auto", "off") else [overlap]
        elif overlap == "auto":
            ovs = ["off", "slab:2", "slab:4"]
        else:
            ovs = [overlap]
        backends = (["direct", "fft-torch", "fft-cuda"] if local
                    else ["fft-torch", "fft-cuda"])
        for be in backends:
            if be == "direct":
                # direct never builds a spectrum; a pinned
                # spectrum="complex" sweep excludes it (plan_conv rejects
                # the pair)
                if "real" in spectra:
                    out.append(TunedConfig(be, sched, spectrum="real"))
                continue
            for spc in spectra:
                for ov in ovs:
                    if be != "fft-cuda" or spc != "real" or ov != "off":
                        # complex fft-cuda runs no tile DFT kernel, and an
                        # overlapped plan pins its row per sub-slab: time
                        # the unpinned point only
                        out.append(TunedConfig(be, sched, spectrum=spc,
                                               overlap=ov))
                        continue
                    bts = [None, DFT_BT_ALT] if local else [None]
                    for blocks in _block_candidates(spec):
                        for bt in bts:
                            out.append(TunedConfig(be, sched, *blocks,
                                                   dft_bt=bt, spectrum=spc,
                                                   overlap=ov))
    # the full row the pins name (a triple naming none is a ValueError),
    # and a dft_bt pin the inverse was compiled at
    blocks = _cuda_blocks(bm, bn, bk)
    _check_dft_bt(dft_bt)
    out = [_merge_pins(c, blocks, dft_bt) for c in out]
    # dedupe (pins can collapse tile variants) preserving order
    seen, uniq = set(), []
    for c in out:
        key = (c.backend, c.schedule, c.bm, c.bn, c.bk, c.dft_bt,
               c.spectrum, c.overlap)
        if key not in seen:
            seen.add(key)
            uniq.append(c)
    # cost-model pick first (it is never fft-cuda, so it is a single
    # candidate), fft-cuda last
    pick = _cost_model_pick(spec, scheds[0], three_m)
    uniq.sort(key=lambda c: 0 if ((c.backend, c.schedule) == pick
                                  and c.spectrum == "real"
                                  and c.overlap == "off")
              else 1 if c.backend != "fft-cuda" else 2)
    return uniq


def _cost_model_pick(spec: ConvSpec, sched: str, three_m: bool) -> tuple:
    """(backend, schedule) of ``backend="auto"``: ``fft-torch`` on a
    sharded schedule, else the direct/FFT crossover."""
    if sched != "local":
        return ("fft-torch", sched)
    return (_auto_backend(spec, three_m), sched)


# --------------------------------------------------------------------------
# Timing harness
# --------------------------------------------------------------------------

def _refuse_capture() -> None:
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            "autotune: a measurement started inside a CUDA graph capture, "
            "where it may not synchronize; tune while planning, before "
            "the capture (ServeEngine.warm)")


def measure_us(fn, *args, reps: int = _DEFAULT_REPS, **kwargs) -> float:
    """One warm-up call, then the median of ``reps`` calls, in
    microseconds: on a CUDA device each call between two CUDA events on
    the current stream (read after one synchronize), on the CPU on
    ``time.perf_counter``.  The device is that of the first tensor
    argument."""
    _refuse_capture()
    device = next((a.device for a in (*args, *kwargs.values())
                   if isinstance(a, torch.Tensor)), torch.device("cpu"))
    reps = max(1, reps)
    if device.type != "cuda":
        fn(*args, **kwargs)
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn(*args, **kwargs)
            ts.append(time.perf_counter() - t0)
        return statistics.median(ts) * 1e6
    stream = torch.cuda.current_stream(device)
    fn(*args, **kwargs)
    events = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record(stream)
        fn(*args, **kwargs)
        end.record(stream)
        events.append((start, end))
    torch.cuda.synchronize(device)
    return statistics.median(s.elapsed_time(e) for s, e in events) * 1e3


def _candidate_plan(cand: TunedConfig, x_shape, k_shape, *, padding, delta,
                    three_m, compute_dtype, mesh=None, data_axis="data",
                    model_axis="model", replicate_kernel_transform=False):
    """The candidate through the real planner, with a representative
    bias+relu epilogue (so the fused inverse tail is measured)."""
    from repro_torch.conv.epilogue import Epilogue
    from repro_torch.conv.plan import plan_conv
    return plan_conv(x_shape, k_shape, padding=padding, delta=delta,
                     backend=cand.backend, schedule=cand.schedule,
                     mesh=mesh, three_m=three_m, bm=cand.bm, bn=cand.bn,
                     bk=cand.bk, dft_bt=cand.dft_bt, spectrum=cand.spectrum,
                     overlap=cand.overlap, compute_dtype=compute_dtype,
                     data_axis=data_axis, model_axis=model_axis,
                     replicate_kernel_transform=replicate_kernel_transform,
                     epilogue=Epilogue(bias=True, activation="relu"),
                     cache=False)


# the inputs of the sweep running now, drawn once for all its candidates
# (``tune`` fills and empties it): drawing them is no part of any
# candidate's time, and at 224x224 it takes a large share of a layer's
# budget on the host
_drawn: dict = {}


def _inputs(x_shape, k_shape, device) -> tuple:
    """x, k and the bias, drawn from ``default_rng(0)`` in that order (the
    running sweep's, when it is for these shapes and device)."""
    key = (tuple(x_shape), tuple(k_shape), torch.device(device))
    with _lock:
        drawn = _drawn.get(key)
    if drawn is not None:
        return drawn
    rng = np.random.default_rng(0)
    return tuple(torch.as_tensor(rng.standard_normal(s),
                                 dtype=torch.float32).to(device)
                 for s in (x_shape, k_shape, (k_shape[0],)))


def _measure_plan(plan, reps, device) -> float:
    """Time a candidate plan's one-shot ``plan(x, k, bias=b)`` on
    ``device`` under ``torch.no_grad()`` (on a mesh every rank calls it
    with the same global operands)."""
    x, k, b = _inputs(plan.x_shape, plan.k_shape, device)
    with torch.no_grad():
        return measure_us(plan, x, k, reps=reps, bias=b)


def _measure_candidate(cand: TunedConfig, x_shape, k_shape, *, padding,
                       delta, three_m, compute_dtype, reps, device,
                       **mesh_kwargs) -> float:
    """Plan one candidate and time it (``_measure_plan``); the planner's
    refusal (``ValueError``, ``NotImplementedError``) is raised before
    anything runs.  ``mesh_kwargs``: ``mesh``, its axes and
    ``replicate_kernel_transform``, as ``_candidate_plan`` takes them."""
    plan = _candidate_plan(cand, x_shape, k_shape, padding=padding,
                           delta=delta, three_m=three_m,
                           compute_dtype=compute_dtype, **mesh_kwargs)
    return _measure_plan(plan, reps, device)


# --------------------------------------------------------------------------
# The tuner
# --------------------------------------------------------------------------

def _cost_model_config(spec: ConvSpec, schedule, mesh, three_m, spectrum,
                       overlap, blocks, dft_bt) -> TunedConfig:
    if schedule == "auto":
        schedule = "nfft" if mesh is not None else "local"
    backend, _ = _cost_model_pick(spec, schedule, three_m)
    if spectrum == "auto" or backend == "direct":
        spectrum = "real"               # compact layout is the default
    if overlap == "auto":
        overlap = "off"                 # the cost model never bets on it
    return TunedConfig(backend, schedule, *blocks, dft_bt=dft_bt,
                       spectrum=spectrum, overlap=overlap,
                       us_per_call=None, source="cost-model")


def tune(spec, k_shape=None, *, padding=None, delta: Optional[int] = None,
         schedule: str = "auto", mesh=None, three_m: bool = True,
         compute_dtype=None, data_axis: str = "data",
         model_axis: str = "model",
         replicate_kernel_transform: bool = False,
         spectrum: str = "auto", overlap: str = "off",
         bm=None, bn=None, bk=None, dft_bt=None,
         budget: Optional[float] = None, reps: Optional[int] = None,
         device=None) -> TunedConfig:
    """Return the winning config for this spec: warm-cache hit, measured
    sweep, or cost-model fallback (measurement disabled, or every
    candidate refused by the planner), in that order.  Only measured
    winners are persisted: a cost-model fallback stays cold so that
    enabling measurement later re-tunes.

    ``spec`` is the same first positional ``plan_conv`` takes: either a
    ``ConvSpec`` or the input shape ``(B, C, H, W)`` with ``k_shape``/
    ``padding``/``delta`` given separately.  ``device`` is where to
    measure (and whose name keys the cache): default the scoped
    ``measure_on`` device, else the GPU.  With a ``mesh`` every rank of it
    must call ``tune`` alike; rank 0 decides for all of them (the module
    docstring says how), and its ``budget`` and ``reps`` hold.  A kernel's
    error while a candidate runs propagates, on every rank.
    """
    global _hits, _misses, _fallbacks, _measured
    if isinstance(spec, ConvSpec):
        if k_shape is not None or padding is not None or delta is not None:
            raise TypeError(
                "tune(spec, ...): a ConvSpec already carries k_shape/"
                "padding/delta — pass them only with the shape-tuple form")
        x_shape = (spec.B, spec.C, spec.H, spec.W)
        k_shape = (spec.Cout, spec.C, spec.kh, spec.kw)
        padding = (spec.pad_h, spec.pad_w)
        delta = spec.delta
    else:
        if k_shape is None:
            raise TypeError(
                "tune(x_shape, k_shape, ...): k_shape is required with "
                "the shape-tuple form (or pass a ConvSpec)")
        x_shape = spec
        padding = (0, 0) if padding is None else padding
        delta = 16 if delta is None else delta
    x_shape = tuple(map(int, x_shape))
    k_shape = tuple(map(int, k_shape))
    padding = _normalize_padding(padding)
    if mesh is not None:
        _check_mesh(mesh, data_axis, model_axis)
    device = _resolve_measure_device(device)
    mesh_kwargs = dict(mesh=mesh, data_axis=data_axis, model_axis=model_axis,
                       replicate_kernel_transform=replicate_kernel_transform)
    key_kwargs = dict(padding=padding, delta=delta, schedule=schedule,
                      three_m=three_m, compute_dtype=compute_dtype,
                      spectrum=spectrum, overlap=overlap,
                      bm=bm, bn=bn, bk=bk, dft_bt=dft_bt, **mesh_kwargs)
    key = cache_key(x_shape, k_shape, device=device, **key_kwargs)
    spec = _make_spec(x_shape, k_shape, padding, delta)
    # the space first, on every rank alike: it refuses an illegal pin
    cands = candidates(spec, schedule=schedule, mesh=mesh, three_m=three_m,
                       spectrum=spectrum, overlap=overlap,
                       bm=bm, bn=bn, bk=bk, dft_bt=dft_bt)
    blocks = _cuda_blocks(bm, bn, bk)
    ranks = RankDecisions(mesh, what="autotune")
    store = _store()
    # rank 0's cache, switch and repetitions answer for every rank
    hit = store.get(key) if ranks.root else None
    reps = _env_reps() if reps is None else max(1, int(reps))
    hit_json, enabled, reps = ranks.broadcast(
        (hit.to_json() if hit is not None else None, autotune_enabled(),
         reps))
    if hit_json is not None:
        if hit is None:                 # rank 0's entry, on another rank
            hit = TunedConfig.from_json(hit_json)
            store.put(key, hit, flush=False)
        with _lock:
            _hits += 1
        return hit
    if not enabled:
        with _lock:
            _fallbacks += 1
        return _cost_model_config(spec, schedule, mesh, three_m, spectrum,
                                  overlap, blocks, dft_bt)
    with _lock:
        _misses += 1

    budget = budget_ms() if budget is None else float(budget)
    if device.type == "cuda":
        # the kernels' first build is no part of any candidate's time
        from repro_torch.kernels import _build
        _build.build()
    best, measured, reached = None, [], len(cands)
    drawn = _inputs(x_shape, k_shape, device)   # before the budget's clock
    with _lock:
        _drawn[(x_shape, k_shape, torch.device(device))] = drawn
    t0 = time.perf_counter()
    try:
        for i, cand in enumerate(cands):
            if i > 0 and ranks.broadcast(
                    (time.perf_counter() - t0) * 1e3 > budget):
                reached = i
                break
            try:
                plan = _candidate_plan(cand, x_shape, k_shape,
                                       padding=padding, delta=delta,
                                       three_m=three_m,
                                       compute_dtype=compute_dtype,
                                       **mesh_kwargs)
                refused = False
            except (ValueError, NotImplementedError):
                refused = True          # the planner refuses it: skip
            if ranks.any(refused):
                continue
            # a kernel's error propagates: it must not lose the sweep
            # quietly
            try:
                us = _measure_plan(plan, reps, device)
            except Exception:
                ranks.fail()
                raise
            us = ranks.slowest(us)
            cfg = dataclasses.replace(cand, us_per_call=us,
                                      source="measured")
            measured.append(cfg)
            if best is None or us < best.us_per_call:
                best = cfg
    finally:
        with _lock:
            _drawn.clear()
    with _lock:
        _sweeps.append(dict(key=key, x_shape=x_shape, k_shape=k_shape,
                            padding=padding, delta=delta,
                            candidates=len(cands), reached=reached,
                            measured=measured))
    if best is None:
        with _lock:
            _fallbacks += 1
        return _cost_model_config(spec, schedule, mesh, three_m, spectrum,
                                  overlap, blocks, dft_bt)
    with _lock:
        _measured += 1
    store.put(key, best, flush=ranks.root)   # rank 0 alone writes the file
    return best


def lookup(x_shape, k_shape, **key_kwargs) -> Optional[TunedConfig]:
    """Warm-cache lookup only (no measurement, no fallback)."""
    return _store().get(cache_key(x_shape, k_shape, **key_kwargs))


def seed(x_shape, k_shape, config: TunedConfig, **key_kwargs) -> str:
    """Force a winner into the cache (tests / pre-baked fleet configs);
    returns the cache key it was stored under."""
    key = cache_key(x_shape, k_shape, **key_kwargs)
    _store().put(key, config)
    return key


# --------------------------------------------------------------------------
# CLI selfcheck (cache write -> reload -> same winner)
# --------------------------------------------------------------------------

def _selfcheck(x_shape, k_shape, padding, device) -> int:
    dev = resolve_device(device)
    print(f"autotune selfcheck: cache={cache_path()} "
          f"enabled={autotune_enabled()} budget={budget_ms():.0f}ms "
          f"dev={_device_kind(dev)} torch={_torch_version()} "
          f"cuda={_cuda_version()} tf32={_tf32_flags()}")
    reset()
    w1 = tune(x_shape, k_shape, padding=padding, device=dev)
    print(f"  first tune : {w1}")
    if not autotune_enabled():
        w2 = tune(x_shape, k_shape, padding=padding, device=dev)
        if w2 != w1:
            raise AssertionError(
                f"cost-model fallback not deterministic: {w2}")
        print("  measurement disabled; deterministic cost-model fallback OK")
        return 0
    if w1.source != "measured":
        raise AssertionError(f"expected a measured winner, got {w1}")
    if not os.path.exists(cache_path()):
        raise AssertionError("tuning cache file was not written")
    reset()                             # drop memory; force re-read of disk
    w2 = tune(x_shape, k_shape, padding=padding, device=dev)
    print(f"  reloaded   : {w2}")
    info = autotune_info()
    if w2 != w1 or (info.hits, info.misses) != (1, 0):
        raise AssertionError(
            f"cache round-trip: {w1} -> {w2}, counters {info}")
    with open(cache_path()) as fh:
        raw = json.load(fh)
    if raw.get("version") != CACHE_VERSION or not raw.get("entries"):
        raise AssertionError("cache file is not round-trippable")
    print(f"  selfcheck OK: winner {w2.backend}/{w2.spectrum} "
          f"@ {w2.us_per_call:.0f}us, {len(raw['entries'])} cache entries")
    return 0


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        description="repro_torch conv autotuner (see "
                    "repro_torch.conv.autotune)")
    ap.add_argument("--selfcheck", action="store_true",
                    help="tune one small spec; assert the cache file "
                         "round-trips (write -> reload -> same winner)")
    ap.add_argument("--x-shape", type=int, nargs=4, default=(1, 4, 16, 16),
                    metavar=("B", "C", "H", "W"))
    ap.add_argument("--k-shape", type=int, nargs=4, default=(8, 4, 3, 3),
                    metavar=("CO", "C", "KH", "KW"))
    ap.add_argument("--padding", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="where to measure (default: the GPU; 'cpu' times "
                         "the kernels' plain versions on the host)")
    args = ap.parse_args(argv)
    if args.selfcheck:
        return _selfcheck(tuple(args.x_shape), tuple(args.k_shape),
                          args.padding, args.device)
    w = tune(tuple(args.x_shape), tuple(args.k_shape), padding=args.padding,
             device=args.device)
    print(w)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
