"""Plan-lint: static analysis of convolution plans, traced on fake tensors.

The paper's NUMA-aware claim is *structural*: data reordering plus the
three-level cgemm parallelization bound how many remote accesses
(all-to-alls / reductions) each schedule performs.  That property can be
certified statically — run the plan on tensors that hold no data, record
every operation it dispatches, count — instead of measured.

``analyze(plan)`` runs a ``ConvPlan`` / ``PreparedConv`` on fake tensors
(``torch._subclasses.fake_tensor.FakeTensorMode``: a shape, a dtype and a
device, no data, so no FLOP runs and no byte is allocated, and a fake
``cuda`` tensor needs no GPU) under a ``TorchDispatchMode`` that sees
every aten op and every ``c10d`` op the plan issues, and turns what it
saw into a structured ``PlanProfile``:

  * per-collective counts under the reference's names (``all_to_all``,
    ``psum``, ``ppermute``, ``all_gather``: ``c10d.alltoall_base_`` is an
    ``all_to_all``, ``allreduce_`` a ``psum``, the all-gathers an
    ``all_gather``, send and recv each a ``ppermute``; any other ``c10d``
    op, functional ones too, counts under its own name) and the bytes
    entering them (the bytes ``stages._record`` counts);
  * dtype-flow facts: the operand dtype of every collective (did the
    ``compute_dtype`` cast land *before* the hot collective?), the CGEMM
    operand dtypes (did ``compute_dtype`` actually reach the hot stage?),
    and whether f64 appeared on any input or output of any op;
  * stage-op invocation counts (via ``stage_trace``);
  * epilogue-fusion facts: the collective/stage-count delta vs the same
    plan with its epilogue stripped (must be zero — fusion is free);
  * prepared-plan elision facts: which stages/collectives a prepared
    execution skips vs the one-shot plan (nfft: stage 2 and one boundary
    all-to-all);
  * an estimated peak of live storage bytes per rank: the inputs at the
    start, each op output's storage while it lives (a ``weakref.finalize``
    on the storage frees it), views and in-place results never twice.

The port stacks the real and imaginary planes of a collective in one
buffer, so it issues half the reference's collectives for the same bytes;
and ``n_eqns`` counts dispatched ops, not jaxpr equations.

On top of the profile sits a declarative invariant registry keyed by
``(backend, schedule)`` (``"*"`` wildcards), evaluated by
``analyze(plan).check()``:

    backend x schedule        invariant
    ----------------------    ------------------------------------------
    *        local            0 collectives of any kind
    *        nfft (full)      3 all_to_all (one per stage boundary), 0 psum
    *        nfft (prepared)  2 all_to_all, stage 2 run zero times
    *        nfft (repl. G)   2 all_to_all (kernel boundary elided)
    *        wfft             exactly the hot all-reduce, 0 all_to_all
    *        * + compute_dtype casts placed before the hot collective,
                              CGEMM operands in compute_dtype
    *        * + epilogue     zero extra collectives, zero extra stage ops
    *        *                no f64 anywhere in the program
    *        nfft (real)      <= 0.55x the boundary all-to-all bytes of
                              the plan's full-spectrum (complex) twin
    *        wfft (real)      <= 0.55x the hot all-reduce bytes of the twin

Overlapped plans (``overlap="slab:k"``) scale the count rules per slab —
nfft issues ``2k + 1`` all-to-alls (D/Z boundaries per slab, kernel
boundary once), wfft ``k`` all-reduces, each stage op ``k`` times (stage
2 once) — and add two rules of their own: total collective bytes must
stay <= 1.0x the sequential (``overlap="off"``) twin's (the slabs
repartition the rows, they must never re-send them), and on ``fft-cuda``
every sub-slab's cgemm must launch the one plan-pinned CGEMM tile row, no
taller than the row the smallest sub-slab takes.

The real-spectrum rules are *relative*: ``analyze`` traces the same plan
with ``spectrum="complex"`` (``dataclasses.replace`` twin) and compares
collective operand bytes — certifying that the compact Hermitian packing
actually halves what the wires move, not merely that it exists.

``python -m repro_torch.conv.analyze --check`` sweeps every registered
backend x schedule pair over the paper geometries
(``configs/paper_convs.py``) x {full, prepared, fused-epilogue,
compute-dtype, complex-spectrum, overlapped} variants on a (1, 1) mesh
(NCCL on the GPU, gloo with ``--device cpu``) and exits non-zero on any
violation — the gate that keeps future perf work honest.
``seeded_violation(...)`` breaks the pipelines on purpose so the gate
itself is testable.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
import time
import weakref
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_map

COLLECTIVES = ("all_to_all", "psum", "ppermute", "all_gather")

# (namespace, op) -> (the reference's name, the argument whose tensors
# enter the collective)
_COLLECTIVE_OPS = {
    ("c10d", "alltoall_base_"): ("all_to_all", 1),
    ("c10d", "alltoall_"): ("all_to_all", 1),
    ("c10d", "allreduce_"): ("psum", 0),
    ("c10d", "allreduce_coalesced_"): ("psum", 0),
    ("c10d", "allgather_"): ("all_gather", 1),
    ("c10d", "_allgather_base_"): ("all_gather", 1),
    ("c10d", "allgather_coalesced_"): ("all_gather", 1),
    ("c10d", "allgather_into_tensor_coalesced_"): ("all_gather", 1),
    ("c10d", "send"): ("ppermute", 0),
    ("c10d", "recv_"): ("ppermute", 0),
}
_COLLECTIVE_NAMESPACES = ("c10d", "_c10d_functional")
_NOT_COLLECTIVES = {("_c10d_functional", "wait_tensor")}


# --------------------------------------------------------------------------
# The walk: every op the plan dispatches, on fake tensors
# --------------------------------------------------------------------------

def _tensors(tree) -> list:
    from torch.distributed.tensor import DTensor
    return [t._local_tensor if isinstance(t, DTensor) else t
            for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


class _Walk(TorchDispatchMode):
    """Records every op dispatched while it is active: the op count, f64
    on any input or output, the collectives with their bytes and operand
    dtypes, and the live storage bytes (``inputs`` at the start, each op
    output's storage from its op until it is freed)."""

    def __init__(self, inputs):
        super().__init__()
        self.n_ops = 0
        self.has_f64 = False
        self.collectives = dict.fromkeys(COLLECTIVES, 0)
        self.collective_dtypes: Dict[str, Dict[str, int]] = {}
        self.collective_bytes = 0
        self.live = 0
        self.peak = 0
        self._storages: set = set()
        for t in _tensors(inputs):
            self._track(t)

    def _track(self, t) -> None:
        storage = t.untyped_storage()
        key = storage._cdata
        if key in self._storages:            # a view, or an in-place result
            return
        nbytes = storage.nbytes()
        self._storages.add(key)
        self.live += nbytes
        self.peak = max(self.peak, self.live)
        weakref.finalize(storage, self._free, key, nbytes)

    def _free(self, key, nbytes) -> None:
        self._storages.discard(key)
        self.live -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.n_ops += 1
        if not self.has_f64:
            self.has_f64 = any(t.dtype == torch.float64
                               for t in _tensors((args, kwargs, out)))
        ns, _, name = func._schema.name.partition("::")
        if ns in _COLLECTIVE_NAMESPACES and (ns, name) \
                not in _NOT_COLLECTIVES:
            self._collective(ns, name, args)
        for t in _tensors(out):
            self._track(t)
        return out

    def _collective(self, ns, name, args) -> None:
        kind, arg = _COLLECTIVE_OPS.get((ns, name), (f"{ns}.{name}", 0))
        self.collectives[kind] = self.collectives.get(kind, 0) + 1
        operands = _tensors(args[arg])
        self.collective_bytes += _nbytes(operands)
        if operands:
            dt = _dtype_name(operands[0].dtype)
            per = self.collective_dtypes.setdefault(kind, {})
            per[dt] = per.get(dt, 0) + 1


def _dtype_name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


# --------------------------------------------------------------------------
# PlanProfile
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class Violation:
    invariant: str
    message: str

    def __str__(self) -> str:
        return f"[{self.invariant}] {self.message}"


@dataclasses.dataclass(frozen=True, eq=False)
class CheckReport:
    """Result of evaluating the invariant registry against a profile."""
    profile: "PlanProfile"
    violations: Tuple[Violation, ...]
    checked: Tuple[str, ...]                   # invariant names evaluated

    @property
    def ok(self) -> bool:
        return not self.violations

    def raise_if_failed(self) -> "CheckReport":
        if self.violations:
            detail = "\n  ".join(str(v) for v in self.violations)
            raise AssertionError(
                f"plan-lint: {self.profile.describe_key()} violates "
                f"{len(self.violations)} invariant(s):\n  {detail}")
        return self


def _plain(obj):
    """``obj`` with every dict key-sorted and every tuple a list: what
    ``json`` writes the same way every time."""
    if isinstance(obj, dict):
        return {k: _plain(obj[k]) for k in sorted(obj, key=str)}
    if isinstance(obj, (tuple, list)):
        return [_plain(v) for v in obj]
    return obj


@dataclasses.dataclass(frozen=True, eq=False)
class PlanProfile:
    """Structured static-analysis facts for one traced plan execution."""
    backend: str
    schedule: str
    prepared: bool
    is_pipeline: bool                          # stage-graph backend
    replicate_kernel_transform: bool
    epilogue: str                              # Epilogue.describe()
    compute_dtype: Optional[str]               # canonical name or None
    collectives: Dict[str, int]                # name -> op count
    collective_dtypes: Dict[str, Dict[str, int]]   # name -> dtype -> count
    collective_bytes: int                      # operand bytes entering them
    stage_counts: Dict[str, int]               # stage-op counts
    cgemm_dtypes: Tuple[str, ...]              # operand dtypes at stage 3
    has_f64: bool
    peak_live_bytes: int
    n_eqns: int                                # dispatched ops
    epilogue_delta: Optional[Dict[str, Dict[str, int]]] = None
    elision: Optional[Dict[str, int]] = None   # full minus prepared counts
    spectrum: str = "real"                     # plan frequency layout
    spectrum_delta: Optional[Dict[str, Any]] = None  # vs complex twin
    overlap: str = "off"                       # plan overlap knob (resolved)
    num_slabs: int = 1                         # sub-slab count (1 = off)
    blocks: Optional[Tuple] = None             # plan (bm, bn, bk) pins
    cgemm_shapes: Tuple = ()                   # distinct (M, N, K) at stage 3
    overlap_delta: Optional[Dict[str, Any]] = None   # vs sequential twin

    def describe_key(self) -> str:
        tags = [self.backend, self.schedule]
        if self.prepared:
            tags.append("prepared")
        if self.num_slabs > 1:
            tags.append(self.overlap)
        if self.spectrum != "real":
            tags.append(self.spectrum)
        if self.epilogue != "none":
            tags.append(f"ep={self.epilogue}")
        if self.compute_dtype:
            tags.append(self.compute_dtype)
        return "/".join(tags)

    def check(self, *, extra=()) -> CheckReport:
        """Evaluate every registered invariant applying to this profile."""
        violations: List[Violation] = []
        invs = list(invariants_for(self.backend, self.schedule)) + list(extra)
        for inv in invs:
            msg = inv.rule(self)
            if msg:
                violations.append(Violation(inv.name, msg))
        return CheckReport(profile=self, violations=tuple(violations),
                           checked=tuple(i.name for i in invs))

    def to_dict(self) -> dict:
        """The reference's keys, key-sorted at every level, tuples as
        lists: the same JSON for the same facts."""
        d = dataclasses.asdict(self)
        d["blocks"] = list(self.blocks) if self.blocks else None
        return _plain(d)


# --------------------------------------------------------------------------
# Invariant registry (declarative, keyed backend x schedule)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class Invariant:
    """One named structural rule.  ``rule(profile)`` returns ``None`` when
    the invariant holds, else a human-readable violation message."""
    name: str
    rule: Callable[[PlanProfile], Optional[str]]
    description: str = ""


_REGISTRY: Dict[Tuple[str, str], List[Invariant]] = {}


def register_invariant(backend: str, schedule: str, name: str,
                       rule: Callable[[PlanProfile], Optional[str]],
                       description: str = "") -> Invariant:
    """Register a structural invariant for ``(backend, schedule)``;
    ``"*"`` wildcards either key.  Third-party backends registered via
    ``repro_torch.conv.register_backend`` add their rules here so the
    ``--check`` sweep certifies them too."""
    inv = Invariant(name=name, rule=rule, description=description)
    _REGISTRY.setdefault((backend, schedule), []).append(inv)
    return inv


def invariants_for(backend: str, schedule: str) -> Tuple[Invariant, ...]:
    out: List[Invariant] = []
    for key in (("*", "*"), ("*", schedule), (backend, "*"),
                (backend, schedule)):
        out.extend(_REGISTRY.get(key, ()))
    return tuple(out)


def _expect_counts(**expected):
    """Rule factory: exact collective counts.  Values are ints or
    ``callable(profile) -> int`` for prepared/replicated variants."""
    def rule(p: PlanProfile) -> Optional[str]:
        bad = []
        for name, want in expected.items():
            want_n = want(p) if callable(want) else want
            got = p.collectives.get(name, 0)
            if got != want_n:
                bad.append(f"{name}: expected {want_n}, traced {got}")
        return "; ".join(bad) or None
    return rule


def _nfft_a2a(p: PlanProfile) -> int:
    # per slab: D boundary #1 + Z boundary #3 (re/im stacked: one
    # all-to-all each); kernel boundary #2 is shared by all slabs and
    # issued once — prepared elides it (stage 2 was paid at prepare time)
    # and replicate_kernel_transform never issues it.  num_slabs=1
    # recovers the sequential 3 full / 2 prepared-or-replicated counts.
    s = max(1, p.num_slabs)
    return 2 * s + (0 if (p.prepared or p.replicate_kernel_transform)
                    else 1)


def _wfft_psum(p: PlanProfile) -> int:
    # the hot-stage all-reduce (re/im stacked), once per sub-slab
    return max(1, p.num_slabs)


def _rule_local_collective_free(p: PlanProfile) -> Optional[str]:
    extra = {k: v for k, v in p.collectives.items() if v}
    if extra:
        return f"local schedule traced collectives: {extra}"
    return None


def _rule_stage_ops_once(p: PlanProfile) -> Optional[str]:
    if not p.is_pipeline:
        return None
    s = max(1, p.num_slabs)
    # stages 1/3/4 run once per sub-slab; the kernel transform is shared
    # by all slabs (never duplicated) and elided entirely when prepared
    want = {"input_transform": s, "cgemm": s, "output_inverse": s,
            "kernel_transform": 0 if p.prepared else 1}
    bad = [f"{k}: expected {v}, traced {p.stage_counts.get(k, 0)}"
           for k, v in want.items() if p.stage_counts.get(k, 0) != v]
    return "; ".join(bad) or None


def _rule_no_f64(p: PlanProfile) -> Optional[str]:
    if p.has_f64:
        return "f64 values appeared in the traced program (silent upcast)"
    return None


def _rule_compute_dtype_reaches_cgemm(p: PlanProfile) -> Optional[str]:
    if p.compute_dtype is None or not p.is_pipeline:
        return None
    if set(p.cgemm_dtypes) != {p.compute_dtype}:
        return (f"CGEMM operands traced as {sorted(set(p.cgemm_dtypes))}, "
                f"expected compute_dtype={p.compute_dtype}")
    return None


def _rule_cast_before_hot_collective(hot: str, expected_n):
    """The compute_dtype cast must land BEFORE the hot collective so it
    moves half the bytes: ``expected_n`` of the ``hot`` collectives must
    carry operands in compute_dtype."""
    def rule(p: PlanProfile) -> Optional[str]:
        if p.compute_dtype is None:
            return None
        want = expected_n(p) if callable(expected_n) else expected_n
        got = p.collective_dtypes.get(hot, {}).get(p.compute_dtype, 0)
        if got != want:
            return (f"{hot} in {p.compute_dtype}: expected {want}, "
                    f"traced {got} "
                    f"(dtypes seen: {p.collective_dtypes.get(hot, {})})")
        return None
    return rule


def _rule_epilogue_free(p: PlanProfile) -> Optional[str]:
    if not p.epilogue_delta:
        return None
    bad = []
    for kind, deltas in p.epilogue_delta.items():
        extra = {k: v for k, v in deltas.items() if v}
        if extra:
            bad.append(f"epilogue added {kind}: {extra}")
    return "; ".join(bad) or None


_RFFT_BYTES_RATIO = 0.55


def _rule_rfft_halves_collective_bytes(p: PlanProfile) -> Optional[str]:
    if p.spectrum != "real" or not p.spectrum_delta:
        return None
    ratio = p.spectrum_delta.get("ratio")
    if ratio is not None and ratio > _RFFT_BYTES_RATIO:
        return (f"real-spectrum plan moves {ratio:.4f}x the collective "
                f"bytes of its full-spectrum twin "
                f"({p.spectrum_delta.get('collective_bytes')} vs "
                f"{p.spectrum_delta.get('twin_collective_bytes')}); the "
                f"compact Hermitian packing must stay <= "
                f"{_RFFT_BYTES_RATIO}x")
    return None


def _rule_prepared_elides_boundary(p: PlanProfile) -> Optional[str]:
    if not (p.prepared and p.elision):
        return None
    if p.elision.get("all_to_all", 0) != 1:
        return (f"prepared nfft must skip exactly one boundary all-to-all "
                f"(re/im stacked); elision traced {p.elision}")
    return None


# Overlapped execution repartitions the batch rows across sub-slab
# collectives — it must never re-send them.  Exact parity is expected
# (the per-slab paddings are proportional); the epsilon only absorbs
# float division.
_OVERLAP_BYTES_RATIO = 1.005


def _rule_overlap_bytes_parity(p: PlanProfile) -> Optional[str]:
    if p.num_slabs <= 1 or not p.overlap_delta:
        return None
    ratio = p.overlap_delta.get("ratio")
    if ratio is not None and ratio > _OVERLAP_BYTES_RATIO:
        return (f"overlapped plan moves {ratio:.4f}x the collective bytes "
                f"of its sequential (overlap='off') twin "
                f"({p.overlap_delta.get('collective_bytes')} vs "
                f"{p.overlap_delta.get('twin_collective_bytes')}); "
                f"sub-slabbing must repartition rows, not duplicate them")
    return None


def _rule_overlap_uniform_blocks(p: PlanProfile) -> Optional[str]:
    """Every sub-slab's cgemm must launch the ONE CGEMM tile row pinned at
    plan time (rows that differ per slab are distinct kernels, chosen
    again on every call), and that row must be no taller than the row the
    smallest sub-slab takes (``default_shape``), else the small slabs
    compute padded rows on every call: the twin of the reference's
    lane-fit check of its resolved ``bm``."""
    if p.num_slabs <= 1 or not p.cgemm_shapes:
        return None
    from repro_torch.kernels.cgemm.ops import (
        SHAPES, default_shape, shape_for_blocks)
    pinned = shape_for_blocks(*p.blocks) if p.blocks else None
    rows = {pinned if pinned is not None else default_shape(m)
            for (m, _, _) in p.cgemm_shapes}
    if len(rows) > 1:
        return (f"sub-slab cgemm shapes {sorted(p.cgemm_shapes)} launch "
                f"different CGEMM tile rows {sorted(rows)}; the row must "
                f"be pinned once at plan time")
    row = next(iter(rows))
    m_min = min(m for m, _, _ in p.cgemm_shapes)
    fit = default_shape(m_min)
    if SHAPES[row][0] > SHAPES[fit][0]:
        return (f"CGEMM tile row {row} (bm={SHAPES[row][0]}) is taller "
                f"than the row of the smallest sub-slab (M={m_min} -> row "
                f"{fit}, bm={SHAPES[fit][0]}): the small slabs compute "
                f"padded rows on every call")
    return None


def _register_builtin_invariants() -> None:
    register_invariant(
        "*", "local", "local-collective-free", _rule_local_collective_free,
        "the local schedule performs zero collectives of any kind")
    register_invariant(
        "*", "nfft", "nfft-a2a-count",
        _expect_counts(all_to_all=_nfft_a2a, psum=0, ppermute=0,
                       all_gather=0),
        "tuple partitioning: one all-to-all (re/im stacked) per live stage "
        "boundary and a collective-free hot CGEMM (3 full / 2 prepared or "
        "replicated; the D/Z boundaries scale per sub-slab when "
        "overlapped)")
    register_invariant(
        "*", "nfft", "nfft-prepared-elision", _rule_prepared_elides_boundary,
        "prepared nfft skips stage 2 AND boundary all-to-all #2")
    register_invariant(
        "*", "nfft", "nfft-hot-cast",
        _rule_cast_before_hot_collective("all_to_all",
                                         lambda p: 2 * max(1, p.num_slabs)),
        "compute_dtype cast lands before the D/Z boundary all-to-alls "
        "(the kernel boundary stays f32)")
    register_invariant(
        "*", "wfft", "wfft-hot-psum-pair",
        _expect_counts(psum=_wfft_psum, all_to_all=0, ppermute=0,
                       all_gather=0),
        "baseline: exactly the hot-stage all-reduce (re/im stacked; per "
        "sub-slab when overlapped), nothing else")
    register_invariant(
        "*", "wfft", "wfft-hot-cast",
        _rule_cast_before_hot_collective("psum", _wfft_psum),
        "compute_dtype cast lands before the hot-stage all-reduce")
    register_invariant(
        "*", "nfft", "nfft-rfft-halves-a2a",
        _rule_rfft_halves_collective_bytes,
        "the compact half-spectrum nfft plan moves <= 0.55x the boundary "
        "all-to-all bytes of its full-spectrum (complex) twin")
    register_invariant(
        "*", "wfft", "wfft-rfft-halves-psum",
        _rule_rfft_halves_collective_bytes,
        "the compact half-spectrum wfft plan moves <= 0.55x the hot "
        "all-reduce bytes of its full-spectrum (complex) twin")
    register_invariant(
        "*", "*", "stage-ops-once", _rule_stage_ops_once,
        "each pipeline stage op runs exactly once (stage 2 zero times "
        "when prepared)")
    register_invariant(
        "*", "*", "no-f64", _rule_no_f64,
        "no silent f64 upcast anywhere in the traced program")
    register_invariant(
        "*", "*", "compute-dtype-reaches-cgemm",
        _rule_compute_dtype_reaches_cgemm,
        "compute_dtype actually reaches the hot CGEMM operands")
    register_invariant(
        "*", "*", "epilogue-fusion-free", _rule_epilogue_free,
        "a fused epilogue adds zero collectives and zero stage ops")
    register_invariant(
        "*", "*", "overlap-bytes-parity", _rule_overlap_bytes_parity,
        "an overlapped plan's total collective bytes stay <= 1.0x its "
        "sequential (overlap='off') twin's — sub-slabbing repartitions "
        "the rows, it never re-sends them")
    register_invariant(
        "fft-cuda", "*", "overlap-uniform-blocks",
        _rule_overlap_uniform_blocks,
        "every sub-slab's cgemm launches the one plan-pinned CGEMM tile "
        "row, no taller than the smallest sub-slab's")


_register_builtin_invariants()


# --------------------------------------------------------------------------
# Tracing on fake tensors -> PlanProfile
# --------------------------------------------------------------------------

def _canon_dtype(dt) -> Optional[str]:
    return None if dt is None else _dtype_name(dt)


def _default_device(plan) -> str:
    """Where ``analyze`` puts the fake tensors of ``plan`` by default: the
    device type of a sharded plan's mesh, else CUDA (a fake ``cuda``
    tensor needs no GPU) — on a PyTorch built with CUDA.  A CPU-only build
    cannot run fake ``cuda`` tensors through every op (it has no CUDA
    device guard), so there the default is the CPU."""
    if plan.mesh is not None:
        return plan.mesh.device_type
    return "cuda" if torch.backends.cuda.is_built() else "cpu"


def _device(plan, device) -> torch.device:
    """``device``, or ``_default_device(plan)``, with the current GPU's
    index where it names none."""
    device = torch.device(_default_device(plan) if device is None
                          else device)
    if device.type == "cuda" and device.index is None \
            and torch.cuda.is_available():
        device = torch.device("cuda", torch.cuda.current_device())
    return device


@contextlib.contextmanager
def _faking():
    """Fake tensors, no autograd.  Real tensors a plan holds come in as
    inputs, converted without a copy."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode(allow_non_fake_inputs=True), torch.no_grad():
        yield


def _epilogue_operands(plan, device) -> dict:
    ep = {}
    if plan.epilogue.bias:
        ep["bias"] = torch.empty((plan.spec.Cout,), device=device)
    if plan.epilogue.residual:
        ep["residual"] = torch.empty(plan.out_shape, device=device)
    return ep


def _walk(run, inputs):
    """``run()`` under the walk and an isolated stage trace: the walk and
    the stage-op counts."""
    from repro_torch.conv.stages import isolated_trace
    with isolated_trace() as counts, _Walk(inputs) as walk:
        run()
    return walk, dict(counts)


def _trace_full(plan, device):
    """Walk + stage counts of the one-shot ``plan(x, k)`` path."""
    with _faking():
        x = torch.empty(plan.x_shape, device=device)
        k = torch.empty(plan.k_shape, device=device)
        ep = _epilogue_operands(plan, device)
        return _walk(lambda: plan(x, k, **ep), (x, k, ep))


def _trace_prepared(plan, device, state=None):
    """Walk + stage counts of the prepared-execute path.  With no
    ``state`` the prepared kernel is the pipeline's own ``prepare`` run on
    a fake kernel (no transform FLOPs run, and neither the plan's cache
    nor the prepared cache is touched); a given ``state`` is replaced by
    fakes of its shapes."""
    from repro_torch.conv import registry
    from repro_torch.conv.stages import isolated_trace
    be = registry.get_backend(plan.backend)
    pipe = be.make_pipeline(plan) if be.pipeline_factory else None
    with _faking():
        x = torch.empty(plan.x_shape, device=device)
        if state is not None:
            st = tree_map(lambda t: torch.empty_strided(
                t.shape, t.stride(), dtype=t.dtype, device=device)
                if isinstance(t, torch.Tensor) else t, state)
        elif pipe is not None:
            with isolated_trace():
                st = pipe.prepare(plan, torch.empty(plan.k_shape,
                                                    device=device))
        else:
            st = torch.empty(plan.k_shape, device=device)
        ep = _epilogue_operands(plan, device)
        if pipe is not None:
            def run():
                pipe.execute(plan, x, st, **ep)
        elif plan.epilogue.is_noop:
            def run():
                be.execute(plan, x, st)
        else:
            def run():
                be.execute(plan, x, st, **ep)
        return _walk(run, (x, st, ep))


def _profile_from_trace(plan, walk, counts, *, prepared: bool):
    from repro_torch.conv import registry
    stage_counts = {k: v for k, v in counts.items() if isinstance(k, str)}
    cgemm_dtypes = tuple(sorted(
        k[1] for k in counts if isinstance(k, tuple) and k[0] == "cgemm_dtype"
    ))
    cgemm_shapes = tuple(sorted(
        k[1] for k in counts if isinstance(k, tuple) and k[0] == "cgemm_shape"
    ))
    be = registry.get_backend(plan.backend)
    return PlanProfile(
        backend=plan.backend, schedule=plan.schedule, prepared=prepared,
        is_pipeline=be.pipeline_factory is not None,
        replicate_kernel_transform=plan.replicate_kernel_transform,
        epilogue=plan.epilogue.describe(),
        compute_dtype=_canon_dtype(plan.compute_dtype),
        collectives=walk.collectives,
        collective_dtypes=walk.collective_dtypes,
        collective_bytes=walk.collective_bytes, stage_counts=stage_counts,
        cgemm_dtypes=cgemm_dtypes, has_f64=walk.has_f64,
        peak_live_bytes=walk.peak, n_eqns=walk.n_ops,
        spectrum=plan.spectrum, overlap=plan.overlap,
        num_slabs=plan.num_slabs,
        blocks=(plan.bm, plan.bn, plan.bk), cgemm_shapes=cgemm_shapes)


def _profile(plan, device, prepared: bool, state=None) -> PlanProfile:
    if prepared:
        return _profile_from_trace(plan, *_trace_prepared(plan, device,
                                                          state),
                                   prepared=True)
    return _profile_from_trace(plan, *_trace_full(plan, device),
                               prepared=False)


def analyze(target, *, prepared: bool = False, device=None):
    """Statically analyze a ``ConvPlan``, ``PreparedConv`` or
    ``NetworkPlan`` into a structured profile: the plan runs on fake
    tensors, so no conv FLOPs run and nothing is allocated.

    ``analyze(plan)`` profiles the one-shot path; ``analyze(plan,
    prepared=True)`` profiles the prepared-execute path with the kernel
    prepared on a fake kernel; ``analyze(prepared_conv)`` profiles an
    existing prepared plan (its state's shapes).  ``device``: where the
    fake tensors lie — ``None`` is the plan's mesh's device type for a
    sharded plan (CUDA on an NCCL mesh, the CPU on a gloo one) and CUDA
    for a local plan (fake CUDA tensors need no GPU; the CPU on a
    CPU-only PyTorch); ``"cpu"`` for the host.  Evaluate the invariant
    registry with ``analyze(...).check()``.
    """
    from repro_torch.conv.epilogue import Epilogue
    from repro_torch.conv.netplan import NetworkPlan
    from repro_torch.conv.plan import ConvPlan, PreparedConv
    if isinstance(target, NetworkPlan):
        return target.analyze(device=device)
    if isinstance(target, PreparedConv):
        plan, state, prepared = target.plan, target.state, True
    elif isinstance(target, ConvPlan):
        plan, state = target, None
    else:
        raise TypeError(
            f"analyze() takes a ConvPlan, PreparedConv or NetworkPlan; "
            f"got {type(target).__name__}")
    dev = _device(plan, device)

    profile = _profile(plan, dev, prepared, state)
    if prepared:
        full = _profile(plan, dev, False)
        elision = {
            name: full.collectives.get(name, 0)
            - profile.collectives.get(name, 0) for name in COLLECTIVES}
        elision["kernel_transform"] = \
            full.stage_counts.get("kernel_transform", 0) \
            - profile.stage_counts.get("kernel_transform", 0)
        profile = dataclasses.replace(profile, elision=elision)

    if not plan.epilogue.is_noop:
        bp = _profile(dataclasses.replace(plan, epilogue=Epilogue()), dev,
                      prepared)
        delta = {
            "collectives": {
                n: profile.collectives.get(n, 0) - bp.collectives.get(n, 0)
                for n in COLLECTIVES},
            "stage_counts": {
                n: profile.stage_counts.get(n, 0)
                - bp.stage_counts.get(n, 0)
                for n in set(profile.stage_counts) | set(bp.stage_counts)},
        }
        profile = dataclasses.replace(profile, epilogue_delta=delta)

    # Real-spectrum plans on sharded schedules get a bytes-ratio profile
    # against their full-spectrum twin (same plan, spectrum="complex") so
    # the halved-collective-bytes invariant is certified *relatively* —
    # the twin is traced at the same prepared-ness.
    if profile.is_pipeline and plan.spectrum == "real" \
            and plan.schedule in ("nfft", "wfft"):
        tp = _profile(dataclasses.replace(plan, spectrum="complex"), dev,
                      prepared)
        ratio = (profile.collective_bytes / tp.collective_bytes
                 if tp.collective_bytes else None)
        profile = dataclasses.replace(profile, spectrum_delta={
            "collective_bytes": profile.collective_bytes,
            "twin_collective_bytes": tp.collective_bytes,
            "ratio": ratio})

    # Overlapped plans get a bytes-parity profile against their sequential
    # twin (same plan, overlap="off"): the sub-slab collectives must
    # repartition the rows the synchronous path moves, never re-send them.
    if profile.is_pipeline and profile.num_slabs > 1:
        sq = _profile(dataclasses.replace(plan, overlap="off"), dev,
                      prepared)
        ratio = (profile.collective_bytes / sq.collective_bytes
                 if sq.collective_bytes else None)
        profile = dataclasses.replace(profile, overlap_delta={
            "collective_bytes": profile.collective_bytes,
            "twin_collective_bytes": sq.collective_bytes,
            "ratio": ratio,
            "collectives": dict(profile.collectives),
            "twin_collectives": dict(sq.collectives)})
    return profile


# --------------------------------------------------------------------------
# Seeded violations (negative testing of the gate itself)
# --------------------------------------------------------------------------

VIOLATION_MODES = ("extra-collective", "extra-stage", "skip-cast",
                   "rfft-unpacked", "overlap-oversend")


@contextlib.contextmanager
def _patched(module, **fns):
    """``module``'s attributes replaced by ``fns`` within the block."""
    orig = {name: getattr(module, name) for name in fns}
    for name, fn in fns.items():
        setattr(module, name, fn)
    try:
        yield
    finally:
        for name, fn in orig.items():
            setattr(module, name, fn)


@contextlib.contextmanager
def _oversending(stages):
    """``overlap-oversend``: within a pipeline's ``_slabbed`` with more
    than one slab, every collective pads its M rows 2x before the wire and
    drops the padding after; every other collective is untouched."""
    slabbed = [False]
    a2a, all_reduce = stages._boundary_a2a, stages._all_reduce

    def flagged(orig):
        def run(self, xs, *args):
            prev, slabbed[0] = slabbed[0], len(xs) > 1
            try:
                return orig(self, xs, *args)
            finally:
                slabbed[0] = prev
        return run

    def doubled(T):                  # M is axis 2 of the stacked planes
        return torch.cat([T, torch.zeros_like(T)], dim=2)

    def broken_a2a(T, group, split, concat, n):
        if not slabbed[0]:
            return a2a(T, group, split, concat, n)
        work, recv, c = a2a(doubled(T), group, split, concat, n)
        return work, recv.narrow(3, 0, T.shape[2]), c    # (n, 2, ., M, .)

    def broken_all_reduce(T, group):
        if not slabbed[0]:
            return all_reduce(T, group)
        work, Z = all_reduce(doubled(T), group)
        return work, Z.narrow(2, 0, T.shape[2])

    nfft, wfft = stages.NfftPipeline, stages.WfftPipeline
    with _patched(nfft, _slabbed=flagged(nfft._slabbed)), \
            _patched(wfft, _slabbed=flagged(wfft._slabbed)), \
            _patched(stages, _boundary_a2a=broken_a2a,
                     _all_reduce=broken_all_reduce):
        yield


@contextlib.contextmanager
def seeded_violation(mode: str = "extra-collective"):
    """Deliberately break the stage pipelines so ``--check`` has something
    to catch (negative self-test of the gate; never use outside tests).

      extra-collective  every nfft boundary all-to-all is followed by an
                        all-reduce of what it received (the hot path gains
                        reductions it must not have);
      extra-stage       the kernel transform runs twice per trace;
      skip-cast         compute_dtype casts silently dropped, in
                        ``_maybe_cast`` and in the collectives' ``_pack``
                        (collectives move full-width bytes again);
      rfft-unpacked     the compact-Hermitian pack degrades to a plain
                        half-plane flatten — real-spectrum plans ship the
                        redundant self-conjugate rows again and the
                        bytes-ratio invariants must trip;
      overlap-oversend  every sub-slab collective pads its M rows 2x
                        before the wire and slices back after — only
                        overlapped plans are hit (the sequential twin is
                        untouched), so the overlap-bytes-parity invariant
                        must trip.
    """
    from repro_torch.conv import stages
    from repro_torch.core import fftconv
    if mode == "overlap-oversend":
        patch = _oversending(stages)
    elif mode == "extra-collective":
        orig_a2a = stages._boundary_a2a

        def broken_a2a(T, group, split, concat, n):
            work, recv, c = orig_a2a(T, group, split, concat, n)
            work.wait()
            return stages._all_reduce(recv, group)[0], recv, c

        patch = _patched(stages, _boundary_a2a=broken_a2a)
    elif mode == "extra-stage":
        orig_kt = stages.stage_kernel_transform

        def broken_kt(k, spec, spectrum="rect", tile_rfft=None,
                      tile_fft=None):
            orig_kt(k, spec, spectrum, tile_rfft, tile_fft)
            return orig_kt(k, spec, spectrum, tile_rfft, tile_fft)

        patch = _patched(stages, stage_kernel_transform=broken_kt)
    elif mode == "rfft-unpacked":
        def broken_pack(Tr, Ti, delta):
            # keep the full half-plane (delta x (delta//2+1)) flattened:
            # shape-consistent downstream (unpack reads a prefix) but the
            # redundant conjugate rows ride every collective again
            return (Tr.reshape(*Tr.shape[:-2], -1),
                    Ti.reshape(*Ti.shape[:-2], -1))

        patch = _patched(fftconv, pack_half_spectrum=broken_pack)
    elif mode == "skip-cast":
        orig_pack = stages._pack
        patch = _patched(stages, _maybe_cast=lambda pair, dtype: pair,
                         _pack=lambda pair, n, dtype=None:
                         orig_pack(pair, n))
    else:
        raise ValueError(
            f"unknown violation mode {mode!r}; known: {VIOLATION_MODES}")
    with patch:
        yield


# --------------------------------------------------------------------------
# CLI: sweep every backend x schedule over the paper geometries
# --------------------------------------------------------------------------

def _paper_geometries(batch: int, limit: Optional[int] = None):
    """Table-I layers as (name, x_shape, k_shape, padding).  Structure is
    batch-invariant, so the sweep uses a small batch; ``limit`` trims the
    set for quick runs."""
    from repro_torch.configs.paper_convs import TABLE1
    layers = TABLE1[:limit] if limit else TABLE1
    return [(l.name, (batch, l.C, l.H, l.W), (l.Cout, l.C, l.kh, l.kw),
             l.pad) for l in layers]


@contextlib.contextmanager
def _sweep_mesh(device):
    """A (1, 1) mesh for the sharded pairs, on the running process group,
    or on a world of one started (and destroyed) here: NCCL on the GPU,
    gloo on the host."""
    import torch.distributed as dist
    from repro_torch.launch import mesh as M
    started = not dist.is_initialized()
    if started:
        if device.type == "cuda":
            M.start_process_group("nccl", device_id=device)
        else:
            M.start_process_group("gloo")
    try:
        yield M.make_mesh((1, 1), ("data", "model"),
                          device_type=device.type)
    finally:
        if started:
            M.destroy_process_group()


def sweep(*, batch: int = 4, limit: Optional[int] = None,
          compute_dtype="bfloat16", progress=print, pairs=None,
          device=None):
    """Profile + check every registered backend x schedule pair over the
    paper geometries x {full, prepared, fused-epilogue, compute-dtype,
    full-spectrum (complex), overlapped (slab:2)} variants.  Returns
    ``(profiles, violations)`` where ``profiles`` maps
    ``"backend/schedule/layer/variant"`` to a ``PlanProfile``.  ``pairs``
    restricts the sweep to a subset of (backend, schedule) pairs — the
    ``--jobs`` process-parallel tracer partitions the registry this way.
    ``device``: where the fake tensors and the (1, 1) mesh lie (``None``:
    the GPU)."""
    from repro_torch.conv import registry
    from repro_torch.conv.epilogue import Epilogue
    from repro_torch.conv.plan import plan_conv
    from repro_torch.device import resolve_device

    device = resolve_device(device)
    profiles: Dict[str, PlanProfile] = {}
    violations: List[Tuple[str, Violation]] = []
    cdt = getattr(torch, compute_dtype) if compute_dtype else None
    if pairs is None:
        pairs = registry.backend_schedule_pairs()
    needs = any(registry.get_schedule(s).requires_mesh for _, s in pairs)
    with (_sweep_mesh(device) if needs
          else contextlib.nullcontext()) as mesh:
        for backend, schedule in pairs:
            needs_mesh = registry.get_schedule(schedule).requires_mesh
            for name, x_shape, k_shape, padding in _paper_geometries(
                    batch, limit):
                base = dict(padding=padding, backend=backend,
                            schedule=schedule,
                            mesh=mesh if needs_mesh else None)
                variants = [
                    ("full", {}, False),
                    ("prepared", {}, True),
                    ("epilogue",
                     {"epilogue": Epilogue(bias=True, activation="relu")},
                     False),
                ]
                if cdt is not None:
                    variants.append(("cdtype", {"compute_dtype": cdt},
                                     False))
                if registry.get_backend(backend).pipeline_factory \
                        is not None:
                    # the full-spectrum twin is a legal plan in its own
                    # right — certify it directly, not only as a ratio
                    # baseline
                    variants.append(("complex", {"spectrum": "complex"},
                                     False))
                    if needs_mesh:
                        # overlapped sub-slab execution: slab-scaled
                        # collective counts + bytes parity vs the
                        # sequential twin
                        variants.append(("overlap", {"overlap": "slab:2"},
                                         False))
                for variant, extra, as_prepared in variants:
                    key = f"{backend}/{schedule}/{name}/{variant}"
                    plan = plan_conv(x_shape, k_shape, **base, **extra)
                    profile = analyze(plan, prepared=as_prepared,
                                      device=device)
                    profiles[key] = profile
                    for v in profile.check().violations:
                        violations.append((key, v))
                        progress(f"VIOLATION {key}: {v}")
    return profiles, violations


def _sweep_worker(payload):
    """Module-level (picklable) worker for ``--jobs``: sweep a subset of
    the backend x schedule pairs in a spawned process (its own world of
    one), returning plain JSON-able results (profiles as dicts,
    violations as tuples)."""
    pairs, batch, limit, inject, device = payload
    ctx = seeded_violation(inject) if inject else contextlib.nullcontext()
    with ctx:
        profiles, violations = sweep(batch=batch, limit=limit, pairs=pairs,
                                     progress=lambda s: None,
                                     device=device)
    return ({k: p.to_dict() for k, p in profiles.items()},
            [(k, v.invariant, v.message) for k, v in violations])


def _sweep_parallel(jobs: int, batch: int, limit, inject, device):
    """Partition the registered pairs round-robin over ``jobs`` spawned
    processes (seeded violations are applied inside each worker)."""
    import multiprocessing as mp
    from repro_torch.conv import registry
    pairs = list(registry.backend_schedule_pairs())
    chunks = [c for c in (pairs[i::jobs] for i in range(jobs)) if c]
    ctx = mp.get_context("spawn")
    with ctx.Pool(processes=len(chunks)) as pool:
        results = pool.map(_sweep_worker,
                           [(c, batch, limit, inject, str(device))
                            for c in chunks])
    payload: Dict[str, dict] = {}
    violations: List[Tuple[str, str, str]] = []
    for prof, viols in results:
        payload.update(prof)
        violations.extend(viols)
    return payload, violations


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.conv.analyze",
        description="Plan-lint: certify the conv engine's structural "
                    "invariants (collectives / dtype flow / fusion) for "
                    "every registered backend x schedule.")
    ap.add_argument("--check", action="store_true",
                    help="sweep backend x schedule x paper geometries and "
                         "exit non-zero on any violated invariant")
    ap.add_argument("--batch", type=int, default=4,
                    help="trace batch size (structure is batch-invariant)")
    ap.add_argument("--limit", type=int, default=None,
                    help="only the first N Table-I geometries")
    ap.add_argument("--json-out", default="",
                    help="write every profile as JSON to this path")
    ap.add_argument("--inject", choices=VIOLATION_MODES, default=None,
                    help="seed a deliberate pipeline violation first "
                         "(negative self-test: --check must then FAIL)")
    ap.add_argument("--jobs", type=int, default=1,
                    help="process-parallel tracing: partition the backend "
                         "x schedule pairs over N spawned workers, each "
                         "on a world of one")
    ap.add_argument("--device", default=None,
                    help="where the fake tensors and the (1, 1) mesh lie "
                         "(default: the GPU, an NCCL mesh; 'cpu': a gloo "
                         "mesh)")
    args = ap.parse_args(argv)
    if not args.check and not args.json_out:
        ap.print_help()
        return 2

    from repro_torch.device import resolve_device
    device = resolve_device(args.device)
    t0 = time.perf_counter()
    if args.jobs > 1:
        payload, raw_violations = _sweep_parallel(
            args.jobs, args.batch, args.limit, args.inject, device)
        for key, inv, msg in raw_violations:
            print(f"VIOLATION {key}: [{inv}] {msg}")
        n_violations = len(raw_violations)
    else:
        ctx = seeded_violation(args.inject) if args.inject \
            else contextlib.nullcontext()
        with ctx:
            profiles, violations = sweep(batch=args.batch, limit=args.limit,
                                         device=device)
        payload = {k: p.to_dict() for k, p in profiles.items()}
        n_violations = len(violations)
    seconds = time.perf_counter() - t0

    if args.json_out:
        with open(args.json_out, "w") as fh:
            json.dump(payload, fh, indent=1, sort_keys=True)
        print(f"# wrote {len(payload)} profiles to {args.json_out}")

    n = len(payload)
    if n_violations:
        print(f"plan-lint: {n_violations} violation(s) across "
              f"{n} profiles", file=sys.stderr)
        return 1
    print(f"plan-lint: OK — {n} profiles, 0 violations "
          f"(invariants certified for "
          f"{len({(d['backend'], d['schedule']) for d in payload.values()})} "
          f"backend x schedule pairs, {seconds:.1f}s on {device})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
