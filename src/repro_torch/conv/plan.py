"""Plan/execute convolution engine (FFTW-style).

The best convolution algorithm is geometry-dependent (direct vs FFT
crossover; tile size; 3M vs 4M complex product; nFFT tuple partitioning vs
wFFT), so selection lives in a planner rather than at call sites:

    plan = plan_conv(x.shape, k.shape, padding=1)   # plan once
    y = plan(x, k)                                  # execute many times

``ConvPlan`` freezes everything the execution needs: the geometry
(``ConvSpec``), the (backend, schedule) pair, precision, ``three_m``, the
fused epilogue and, for the sharded schedules, the mesh and its axes.
Plans are memoized in a keyed LRU cache so repeated layer shapes pay
planning once.  A plan holds no tensors: it runs on whatever device its
operands lie on.

On top of the one-shot ``plan(x, k)`` there is a prepare/execute split for
fixed kernels (serving):

    prepared = plan.prepare(k, weights_version=step)   # stage 2 runs here
    y = prepared(x)                                    # stage 2 never again

``prepare`` caches the transformed kernel ``G`` in the exact layout the
schedule consumes — for ``nfft`` each rank's post-all-to-all P-slab, so
prepared sharded execution runs the kernel transform AND boundary
all-to-all #2 zero times.  The prepared cache is keyed by (plan, kernel
object) and checked against ``weights_version``: prepare with a new
version recomputes (invalidation), with the same version returns the
cached ``PreparedConv``.

The sharded schedules (``nfft``, ``wfft``) run SPMD over a
``torch.distributed`` ``DeviceMesh`` (``repro_torch.launch.mesh``): every
rank calls the plan with the same global operands (the input may instead
be a ``DTensor`` placed as the output is), takes its block as the
reference's ``shard_map`` ``in_specs`` say, and gets a ``DTensor``
placed (B over ``data_axis``, C' over ``model_axis``) with the unpadded
global shape; its ``full_tensor()`` is the reference's output.  A
layer's output feeds the next sharded layer as it is.

``backend="auto"`` picks direct vs FFT from the ``ConvSpec`` cost model
(``fft-torch`` on a mesh); ``schedule="auto"`` picks ``nfft`` when a mesh
is given, else ``local``.  ``backend="tuned"`` measures instead
(``repro_torch.conv.autotune``): the candidate (backend, schedule,
spectrum, overlap, CGEMM tile, ``dft_bt``) points are timed on the
device, on a mesh by every rank with rank 0 deciding, the winner is
cached per machine, and its tile and ``dft_bt`` ride the plan down into
the CUDA kernels.

Every stage-pipeline backend trains, on every schedule: when grad mode is
on and an operand (a tensor or a ``DTensor``) requires grad,
``plan(x, k, ...)`` and ``prepared(x, ...)`` run through the plan-level
VJP (``repro_torch.conv.autodiff``); otherwise they run the pipeline
straight, and record nothing for autograd.  ``overlap`` is
``"off"`` on every local plan (``"auto"`` resolves to it, as in the
reference); ``"slab:<k>"`` overlaps the sharded schedules' collectives
with compute.  ``bm``/``bn``/``bk`` pin a row of the CUDA CGEMM's compiled
tile table (``kernels.cgemm.ops.SHAPES``) on ``fft-cuda`` plans, and
``dft_bt`` one of the inverse tile DFT kernel's compiled tiles a block
(``kernels.dft_tile.ops.INVERSE_TILES``); the reference honours any
positive value, the port takes only what its kernels were compiled with.

``backend="fft-cuda"`` runs tiles up to ``kernels.dft_tile.ops.MAX_DELTA``
(32); a larger ``delta`` is refused when the plan is made.

``stride`` rides on the plan, not on its ``ConvSpec`` (which stays the JAX
package's twin field for field): ``out_shape`` and ``flops`` follow it,
and only ``direct`` runs a stride other than 1.  ``auto`` and ``tuned``
resolve a strided geometry to ``direct``; ``fft-torch`` and ``fft-cuda``
refuse it when the plan is made.  A unit-stride plan's cache key,
``describe()`` and artifact record carry no stride.
"""
from __future__ import annotations

import collections
import dataclasses
import os
import threading
from typing import Any, Optional

import torch

from repro_torch.core.conv_spec import ConvSpec
from repro_torch.conv import autodiff, registry
from repro_torch.conv.epilogue import Epilogue
from repro_torch.conv.stages import axis_size, round_up
from repro_torch.core.fftconv import SPECTRA


def _wants_grad(*tensors) -> bool:
    """Whether autograd must see this call: grad mode is on and an operand
    requires grad."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


@dataclasses.dataclass(frozen=True)
class ConvPlan:
    """Frozen, executable schedule for one convolution geometry.

    Execute with ``plan(x, k)``; ``x`` must be ``(B, C, H, W)`` and ``k``
    ``(C', C, kh, kw)`` matching the planned shapes exactly (plan again
    for a new geometry — planning is cached, so this is cheap).
    """
    spec: ConvSpec
    backend: str                       # resolved registry name
    schedule: str                      # resolved registry name
    padding: tuple                     # (pad_h, pad_w)
    three_m: bool = True               # 3M (Karatsuba) vs 4M complex product
    bm: Optional[int] = None           # CUDA CGEMM tile row (fft-cuda)
    bn: Optional[int] = None
    bk: Optional[int] = None
    dft_bt: Optional[int] = None       # inverse tile DFT tiles a block
    compute_dtype: Any = None          # CGEMM operand dtype (e.g. bf16)
    mesh: Any = None                   # DeviceMesh of the sharded schedules
    data_axis: str = "data"
    model_axis: str = "model"
    replicate_kernel_transform: bool = False
    epilogue: Epilogue = Epilogue()    # fused elementwise tail (stage 4)
    spectrum: str = "real"             # "real" (compact Hermitian) | "complex"
    overlap: str = "off"               # "off" | "slab:<k>" sub-slab overlap
    stride: tuple = (1, 1)             # (s_h, s_w); direct only past 1

    @property
    def num_slabs(self) -> int:
        """Batch sub-slab count of the overlapped execution (1 = off)."""
        return _parse_overlap(self.overlap)

    # ---- execution --------------------------------------------------------
    def __call__(self, x, k, *, bias=None, residual=None):
        """Execute the plan.  Plans with a non-noop ``epilogue`` take the
        epilogue *operands* here: ``plan(x, k, bias=b, residual=r)``."""
        self._check_x(x)
        if tuple(k.shape) != self.k_shape:
            raise ValueError(
                f"plan was built for kernel {self.k_shape}, got "
                f"{tuple(k.shape)}; call plan_conv for the new geometry")
        self._check_epilogue_operands(bias, residual)
        be = registry.get_backend(self.backend)
        if be.pipeline_factory is not None:
            if _wants_grad(x, k, bias, residual):
                return autodiff.pipeline_conv(self, x, k, bias, residual)
            return be.make_pipeline(self).full(self, x, k, bias=bias,
                                               residual=residual)
        if not self.epilogue.is_noop:
            return be.execute(self, x, k, bias=bias, residual=residual)
        return be.execute(self, x, k)

    def _check_x(self, x):
        if tuple(x.shape) != self.x_shape:
            raise ValueError(
                f"plan was built for input {self.x_shape}, got "
                f"{tuple(x.shape)}; call plan_conv for the new geometry")

    def _check_epilogue_operands(self, bias, residual):
        ep = self.epilogue
        if ep.bias != (bias is not None):
            raise ValueError(
                f"plan epilogue declares bias={ep.bias} but bias "
                f"{'was not' if ep.bias else 'was'} passed at execution")
        if ep.residual != (residual is not None):
            raise ValueError(
                f"plan epilogue declares residual={ep.residual} but "
                f"residual {'was not' if ep.residual else 'was'} passed "
                "at execution")
        if bias is not None and tuple(bias.shape) != (self.spec.Cout,):
            raise ValueError(
                f"epilogue bias must have shape ({self.spec.Cout},), got "
                f"{tuple(bias.shape)}")
        if residual is not None and tuple(residual.shape) != self.out_shape:
            raise ValueError(
                f"epilogue residual must match the output {self.out_shape},"
                f" got {tuple(residual.shape)}")

    # ---- prepare/execute split --------------------------------------------
    def prepare(self, k, *, weights_version=None) -> "PreparedConv":
        """Run the kernel transform (stage 2) once; return a ``PreparedConv``
        executing the remaining stages against the cached result.

        The prepared cache is keyed by (plan, kernel object): each layer's
        kernel gets its own entry even when same-geometry layers share a
        plan.  ``weights_version`` is the staleness check — preparing the
        same kernel under the same version returns the memoized
        ``PreparedConv`` without re-transforming; a different version
        recomputes and replaces it (weight update -> invalidation).
        ``None`` always recomputes and is never cached.  The prepared
        kernel is frozen (computed under ``torch.inference_mode()``).
        """
        if tuple(k.shape) != self.k_shape:
            raise ValueError(
                f"plan was built for kernel {self.k_shape}, got "
                f"{tuple(k.shape)}; call plan_conv for the new geometry")
        global _prepared_hits, _prepared_misses, _prepared_invalidations
        # Key by (plan, kernel object): same-geometry layers share one
        # ConvPlan, so the plan alone would hand layer B layer A's cached
        # transform.  The PreparedConv pins k, so id(k) is unambiguous for
        # as long as its entry lives.
        cache_key = (self, id(k))
        if weights_version is not None:
            with _prepared_lock:
                slot = _prepared_cache.get(cache_key)
                if slot is not None and slot[0] == weights_version:
                    _prepared_hits += 1
                    _prepared_cache.move_to_end(cache_key)
                    return slot[1]
        be = registry.get_backend(self.backend)
        if be.pipeline_factory is not None:
            with torch.inference_mode():
                state = be.make_pipeline(self).prepare(self, k)
        else:
            state = k              # opaque backend: nothing to pre-transform
        prepared = PreparedConv(plan=self, state=state, kernel=k,
                                weights_version=weights_version)
        if weights_version is not None:
            with _prepared_lock:
                if cache_key in _prepared_cache:
                    _prepared_invalidations += 1
                    _prepared_cache.move_to_end(cache_key)
                _prepared_misses += 1
                _prepared_cache[cache_key] = (weights_version, prepared)
                # same LRU bound as the plan cache: prepared G slabs are
                # the big tensors, don't let them accumulate unboundedly
                cap = plan_cache_capacity()
                while len(_prepared_cache) > cap:
                    _prepared_cache.popitem(last=False)
        return prepared

    # ---- introspection ----------------------------------------------------
    def analyze(self, *, prepared: bool = False, device=None):
        """Static analysis of this plan run on fake tensors: collective
        counts, dtype flow, fusion/elision facts, peak live bytes — see
        ``repro_torch.conv.analyze``.  ``analyze(prepared=True)`` profiles
        the prepared-execute path (the kernel prepared on a fake kernel; no
        transform FLOPs run, no cache is written).  Certify with
        ``plan.analyze().check()``."""
        from repro_torch.conv.analyze import analyze
        return analyze(self, prepared=prepared, device=device)

    @property
    def x_shape(self) -> tuple:
        s = self.spec
        return (s.B, s.C, s.H, s.W)

    @property
    def k_shape(self) -> tuple:
        s = self.spec
        return (s.Cout, s.C, s.kh, s.kw)

    @property
    def strided(self) -> bool:
        return self.stride != (1, 1)

    @property
    def out_shape(self) -> tuple:
        s = self.spec
        sh, sw = self.stride
        return (s.B, s.Cout, (s.Ho - 1) // sh + 1, (s.Wo - 1) // sw + 1)

    @property
    def differentiable(self) -> bool:
        be = registry.get_backend(self.backend)
        return self.schedule in be.differentiable

    def flops(self) -> int:
        """Cost-model FLOPs of the planned path (for rooflines)."""
        if self.backend == "direct":
            B, Co, Ho, Wo = self.out_shape
            s = self.spec
            return 2 * B * Co * s.C * Ho * Wo * s.kh * s.kw
        return self.spec.cgemm_flops(three_m=self.three_m,
                                     spectrum=self.spectrum) \
            + self.spec.transform_flops()

    def describe(self) -> str:
        s = self.spec
        stride = f" stride={self.stride}" if self.strided else ""
        lines = [
            f"ConvPlan {self.x_shape} * {self.k_shape} -> {self.out_shape}"
            f"{stride}",
            f"  backend={self.backend} schedule={self.schedule} "
            f"three_m={self.three_m} delta={s.delta} "
            f"spectrum={self.spectrum} epilogue={self.epilogue.describe()}",
            f"  cost-model FLOPs: direct {s.direct_flops():.3e}, fft "
            f"{s.cgemm_flops(three_m=self.three_m) + s.transform_flops():.3e}",
        ]
        if self.mesh is not None:
            n_data = axis_size(self.mesh, self.data_axis)
            n_model = axis_size(self.mesh, self.model_axis)
            lines.append(
                f"  mesh axes: {self.data_axis}={n_data} "
                f"x {self.model_axis}={n_model}, replicate_kernel_transform="
                f"{self.replicate_kernel_transform}, overlap={self.overlap}")
        if self.bm or self.bn or self.bk or self.dft_bt:
            lines.append(f"  blocks bm={self.bm} bn={self.bn} bk={self.bk} "
                         f"dft_bt={self.dft_bt}")
        if self.compute_dtype is not None:
            lines.append(f"  compute_dtype={self.compute_dtype}")
        return "\n".join(lines)


@dataclasses.dataclass(frozen=True, eq=False)
class PreparedConv:
    """A plan bound to a prepared (already-transformed) kernel.

    ``prepared(x)`` runs stages 1/3/4; stage 2 was paid once in
    ``plan.prepare``.  It is differentiable in ``x`` and the epilogue
    operands (dx comes from the transposed plan on ``kernel``); the
    prepared kernel itself is frozen.
    """
    plan: ConvPlan
    state: Any                          # pipeline G pair, or raw k (opaque)
    kernel: Any = None                  # original k
    weights_version: Any = None

    def __call__(self, x, *, bias=None, residual=None):
        self.plan._check_x(x)
        self.plan._check_epilogue_operands(bias, residual)
        be = registry.get_backend(self.plan.backend)
        if be.pipeline_factory is not None:
            if _wants_grad(x, bias, residual):
                return autodiff.prepared_conv(self, x, bias, residual)
            return be.make_pipeline(self.plan).execute(
                self.plan, x, self.state, bias=bias, residual=residual)
        if not self.plan.epilogue.is_noop:
            return be.execute(self.plan, x, self.state, bias=bias,
                              residual=residual)
        return be.execute(self.plan, x, self.state)

    @property
    def out_shape(self) -> tuple:
        return self.plan.out_shape

    def analyze(self, *, device=None):
        """Static analysis of the prepared execution path (stage 2 and —
        for nfft — boundary all-to-all #2 must be absent from it), on
        fakes of the prepared state's shapes; see
        ``repro_torch.conv.analyze``."""
        from repro_torch.conv.analyze import analyze
        return analyze(self, device=device)


# --------------------------------------------------------------------------
# Plan cache (bounded LRU) + prepared-kernel cache
# --------------------------------------------------------------------------

PlanCacheInfo = collections.namedtuple("PlanCacheInfo",
                                       ["hits", "misses", "size"])
PreparedCacheInfo = collections.namedtuple(
    "PreparedCacheInfo", ["hits", "misses", "invalidations", "size"])

_DEFAULT_CACHE_SIZE = 256

_cache_lock = threading.Lock()
_plan_cache: "collections.OrderedDict" = collections.OrderedDict()
_cache_hits = 0
_cache_misses = 0

_prepared_lock = threading.Lock()
# (plan, id(k)) -> (weights_version, prepared); LRU-bounded like the plans
_prepared_cache: "collections.OrderedDict" = collections.OrderedDict()
_prepared_hits = 0
_prepared_misses = 0
_prepared_invalidations = 0


def plan_cache_capacity() -> int:
    """Max cached plans (env ``REPRO_CONV_PLAN_CACHE_SIZE``, default 256)."""
    try:
        cap = int(os.environ.get("REPRO_CONV_PLAN_CACHE_SIZE",
                                 _DEFAULT_CACHE_SIZE))
    except ValueError:
        cap = _DEFAULT_CACHE_SIZE
    return max(1, cap)


def plan_cache_info() -> PlanCacheInfo:
    with _cache_lock:
        return PlanCacheInfo(_cache_hits, _cache_misses, len(_plan_cache))


def clear_plan_cache() -> None:
    global _cache_hits, _cache_misses
    with _cache_lock:
        _plan_cache.clear()
        _cache_hits = 0
        _cache_misses = 0


def prepared_cache_info() -> PreparedCacheInfo:
    with _prepared_lock:
        return PreparedCacheInfo(_prepared_hits, _prepared_misses,
                                 _prepared_invalidations,
                                 len(_prepared_cache))


def clear_prepared_cache() -> None:
    global _prepared_hits, _prepared_misses, _prepared_invalidations
    with _prepared_lock:
        _prepared_cache.clear()
        _prepared_hits = 0
        _prepared_misses = 0
        _prepared_invalidations = 0


def _mesh_cache_key(mesh):
    """Value key for a mesh: two distinct ``DeviceMesh`` objects with the
    same dim names, shape, rank layout and device type share plan-cache
    entries (object identity would duplicate them)."""
    if mesh is None:
        return None
    return (tuple(mesh.mesh_dim_names), tuple(mesh.mesh.shape),
            tuple(mesh.mesh.flatten().tolist()), mesh.device_type)


# --------------------------------------------------------------------------
# Planner
# --------------------------------------------------------------------------

def _normalize_padding(padding) -> tuple:
    if isinstance(padding, int):
        return (padding, padding)
    ph, pw = padding
    return (int(ph), int(pw))


def _build_spec(x_shape, k_shape, padding, delta) -> ConvSpec:
    """Validated ``ConvSpec`` for a conv geometry.  Kernels larger than the
    tile get a widened (then-unused) tile so the spec validates; only
    ``direct`` can execute them."""
    B, C, H, W = x_shape
    Cout, C2, kh, kw = k_shape
    if C != C2:
        raise ValueError(f"channel mismatch: input C={C}, kernel C={C2}")
    return ConvSpec(B=B, C=C, Cout=Cout, H=H, W=W, kh=kh, kw=kw,
                    pad_h=padding[0], pad_w=padding[1],
                    delta=max(delta, kh, kw))


def _normalize_stride(stride) -> tuple:
    sh, sw = (stride, stride) if isinstance(stride, int) else stride
    if int(sh) < 1 or int(sw) < 1:
        raise ValueError(f"stride must be >= 1, got {stride!r}")
    return (int(sh), int(sw))


def _auto_backend(spec: ConvSpec, three_m: bool) -> str:
    """Direct-vs-FFT crossover on the ConvSpec cost model (of a unit-stride
    geometry: ``_resolve`` gives a strided one to ``direct`` first)."""
    fft = spec.cgemm_flops(three_m=three_m) + spec.transform_flops()
    return "direct" if spec.direct_flops() <= fft else "fft-torch"


# overlap="auto" picks "off" below this per-rank batch: slabbing a tiny
# batch leaves each slab too small to amortize its collective's latency
# (and k=2 on b_loc<4 would pipeline 1-row slabs).
_AUTO_OVERLAP_MIN_B = 4


def _parse_overlap(overlap) -> int:
    """Sub-slab count encoded by a (resolved) overlap knob value:
    ``"off"`` -> 1, ``"slab:<k>"`` -> k (k >= 2); anything else is a
    ``ValueError``, with the reference's message."""
    if overlap == "off":
        return 1
    if isinstance(overlap, str) and overlap.startswith("slab:"):
        try:
            k = int(overlap[len("slab:"):])
        except ValueError:
            k = 0
        if k >= 2:
            return k
    raise ValueError(
        f"unknown overlap {overlap!r} (choose 'off', 'slab:<k>' with "
        "k >= 2, or 'auto')")


def _check_mesh(mesh, data_axis, model_axis):
    """A mesh is a ``DeviceMesh`` with both axes among its dim names."""
    from torch.distributed.device_mesh import DeviceMesh
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(
            f"mesh must be a torch.distributed DeviceMesh "
            f"(repro_torch.launch.mesh.make_mesh), got {type(mesh).__name__}")
    names = tuple(mesh.mesh_dim_names or ())
    for axis in (data_axis, model_axis):
        if axis not in names:
            raise ValueError(f"mesh has no axis {axis!r} (axes: {names})")


def _b_loc(B, mesh, data_axis) -> int:
    """Per-rank batch of a plan on ``mesh`` (B padded to the data axis,
    as ``padded_sharded_spec`` pads it)."""
    n_data = axis_size(mesh, data_axis)
    return round_up(B, n_data) // n_data


def _auto_overlap(overlap, x_shape, k_shape, delta, backend, schedule,
                  mesh, data_axis):
    """``"auto"`` resolved before the plan-cache key, so that it shares
    the entry of what it resolves to.  As in the reference: ``"slab:2"``
    on a sharded stage pipeline (a mesh, a schedule that requires one and
    a backend with a stage pipeline) with a per-rank batch of at least
    ``_AUTO_OVERLAP_MIN_B``, else ``"off"``."""
    if overlap != "auto":
        return overlap
    if mesh is None:
        return "off"
    sched = registry.get_schedule("nfft" if schedule == "auto" else schedule)
    if backend == "auto":     # on a mesh: fft-torch, or direct if oversize
        pipeline = max(k_shape[2:]) <= delta
    else:
        pipeline = registry.get_backend(backend).pipeline_factory is not None
    return "slab:2" if sched.requires_mesh and pipeline \
        and _b_loc(x_shape[0], mesh, data_axis) >= _AUTO_OVERLAP_MIN_B \
        else "off"


def _resolve_overlap(overlap, spec, sched, be, backend, schedule, mesh,
                     data_axis) -> str:
    """Validate + normalize the overlap knob against the resolved
    (backend, schedule, mesh): explicit slab counts are clamped once to
    the per-rank batch so every slab is non-empty (``"slab:1"`` never
    exists — it normalizes to ``"off"``); a slab count on anything but
    a sharded stage pipeline is the reference's ``ValueError``."""
    num_slabs = _parse_overlap(overlap)
    if num_slabs == 1:
        return "off"
    if not (sched.requires_mesh and be.pipeline_factory is not None):
        raise ValueError(
            f"overlap={overlap!r} requires a sharded stage-pipeline "
            f"schedule (backend {backend!r} / schedule {schedule!r} has "
            "no boundary collectives to overlap); use overlap='off'")
    num_slabs = min(num_slabs, _b_loc(spec.B, mesh, data_axis))
    return f"slab:{num_slabs}" if num_slabs > 1 else "off"


def _check_schedule_mesh(schedule, mesh):
    """The registered schedule ``schedule``, which must have a mesh if and
    only if it is sharded."""
    sched = registry.get_schedule(schedule)
    if sched.requires_mesh and mesh is None:
        raise ValueError(f"schedule {schedule!r} requires a mesh")
    if not sched.requires_mesh and mesh is not None:
        raise ValueError(
            f"schedule {schedule!r} ignores the mesh; pass schedule='nfft' "
            "or 'wfft' (or drop the mesh)")
    return sched


def _check_cuda_delta(delta):
    """``fft-cuda`` plans only what its tile DFT kernels run."""
    # imported here: the kernel package imports repro_torch.conv
    from repro_torch.kernels.dft_tile.ops import MAX_DELTA
    if delta > MAX_DELTA:
        raise ValueError(
            f"backend 'fft-cuda' runs tiles of delta <= {MAX_DELTA} (the "
            f"limit of its tile DFT kernels), got delta={delta}; use "
            "backend 'fft-torch' or a smaller delta")


def _check_dft_bt(dft_bt):
    """A ``dft_bt`` pin names a compiled tiles-a-block value of the
    inverse tile DFT kernel (``None``: its default)."""
    # imported here: the kernel package imports repro_torch.conv
    from repro_torch.kernels.dft_tile.ops import resolve_tiles
    if dft_bt is not None:
        resolve_tiles(dft_bt)


def _cuda_blocks(bm, bn, bk) -> tuple:
    """The (bm, bn, bk) of the CUDA CGEMM tile row that the knobs name
    (all ``None`` when none is pinned)."""
    # imported here: the kernel package imports repro_torch.conv
    from repro_torch.kernels.cgemm.ops import SHAPES, shape_for_blocks
    row = shape_for_blocks(bm, bn, bk)
    return (None, None, None) if row is None else SHAPES[row][:3]


def _resolve(x_shape, k_shape, padding, delta, backend, schedule, mesh,
             three_m, bm, bn, bk, dft_bt, compute_dtype, data_axis,
             model_axis, replicate_kernel_transform, epilogue, spectrum,
             overlap, stride=(1, 1)) -> ConvPlan:
    _, _, kh, kw = k_shape
    if spectrum not in SPECTRA:
        raise ValueError(
            f"unknown spectrum {spectrum!r} (choose 'real', 'complex', or "
            "'auto')")
    # Kernels larger than the FFT tile rule out the FFT backends but are
    # fine for direct conv: _build_spec widens the (then-unused) tile so
    # the spec validates, and auto resolves to direct below.
    oversize = max(kh, kw) > delta
    if oversize and backend not in ("auto", "direct"):
        registry.get_backend(backend)        # unknown names error first
        raise ValueError(
            f"kernel {kh}x{kw} exceeds tile size delta={delta}; only the "
            f"'direct' backend supports it (requested {backend!r})")
    # Overlap-save tiles compute every output position: a strided conv
    # would throw most of them away, so the pipelines take none.
    strided = stride != (1, 1)
    if strided and backend not in ("auto", "direct"):
        registry.get_backend(backend)        # unknown names error first
        raise ValueError(
            f"backend {backend!r} runs unit-stride convolutions only; "
            f"stride {stride} runs on the 'direct' backend")
    spec = _build_spec(x_shape, k_shape, padding, delta)

    if schedule == "auto":
        schedule = "nfft" if mesh is not None else "local"
    sched = _check_schedule_mesh(schedule, mesh)
    # Channel axes are zero-padded up to model-axis multiples inside the
    # pipelines, and the frequency (P) axis is padded once before the nfft
    # boundary all-to-alls: no divisibility precondition.

    if backend == "auto":
        if oversize or strided:
            backend = "direct"
        else:
            backend = "fft-torch" if sched.requires_mesh \
                else _auto_backend(spec, three_m)
    be = registry.get_backend(backend)
    if backend == "fft-cuda":
        _check_cuda_delta(delta)
        bm, bn, bk = _cuda_blocks(bm, bn, bk)
    if schedule not in be.schedules:
        raise ValueError(
            f"backend {backend!r} does not support schedule {schedule!r} "
            f"(supported: {be.schedules})")
    if not epilogue.is_noop and not be.epilogue_capable:
        raise ValueError(
            f"backend {backend!r} cannot fuse an epilogue "
            f"({epilogue.describe()}); register it with "
            "supports_epilogue=True or use a stage-pipeline backend")
    if spectrum == "complex" and be.pipeline_factory is None:
        raise ValueError(
            f"spectrum='complex' (the full-spectrum twin) only applies to "
            f"the FFT stage pipelines; backend {backend!r} has no spectrum")

    # -- overlap (comm/compute-overlapped sub-slab execution) ---------------
    overlap = _resolve_overlap(overlap, spec, sched, be, backend, schedule,
                               mesh, data_axis)
    num_slabs = _parse_overlap(overlap)
    if num_slabs > 1 and backend == "fft-cuda" and bm is None:
        # Pin the CGEMM tile row ONCE, for the smallest sub-slab's M, so
        # every slab launches the same row (the chooser would pick per
        # slab).  An explicit pin already names the row of every slab.
        from repro_torch.kernels.cgemm.ops import SHAPES, default_shape
        m_min = (_b_loc(spec.B, mesh, data_axis) // num_slabs) \
            * spec.n_tiles
        bm, bn, bk = SHAPES[default_shape(m_min)][:3]
    return ConvPlan(spec=spec, backend=backend, schedule=schedule,
                    padding=padding, three_m=three_m, bm=bm, bn=bn, bk=bk,
                    dft_bt=dft_bt, compute_dtype=compute_dtype, mesh=mesh,
                    data_axis=data_axis, model_axis=model_axis,
                    replicate_kernel_transform=replicate_kernel_transform,
                    epilogue=epilogue, spectrum=spectrum, overlap=overlap,
                    stride=stride)


def plan_conv(spec, k_shape=None, *, padding=None, delta: Optional[int] = None,
              backend: str = "auto", schedule: str = "auto", mesh=None,
              three_m: bool = True, bm=None, bn=None, bk=None, dft_bt=None,
              compute_dtype=None, data_axis: str = "data",
              model_axis: str = "model",
              replicate_kernel_transform: bool = False,
              epilogue: Optional[Epilogue] = None,
              spectrum: str = "auto", overlap: str = "off",
              stride=1, cache: bool = True) -> ConvPlan:
    """Create (or fetch from the plan cache) a ``ConvPlan``.

    Args:
      spec: a ``ConvSpec`` (geometry + padding + delta in one object), or
        the input shape ``(B, C, H, W)`` with ``k_shape``/``padding``/
        ``delta`` given separately.
      k_shape: kernel shape ``(C', C, kh, kw)`` with ``kh, kw <= delta``
        (shape-tuple form only — a ``ConvSpec`` already carries it).
      padding: int or ``(ph, pw)`` zero padding (default 0).
      delta: FFT tile size (the paper uses 16).
      backend: ``"direct"`` | ``"fft-torch"`` | ``"fft-cuda"`` | ``"auto"``
        (cost-model crossover between direct and ``fft-torch``, or
        ``fft-torch`` on a mesh; never auto-selects the CUDA kernels) |
        ``"tuned"`` (measured selection through
        ``repro_torch.conv.autotune``: warm persistent cache, or a sweep
        timed on the device of ``autotune.measure_on`` (default the GPU),
        or the cost model when measurement is disabled; the tuner also
        picks the spectrum, the CGEMM tile and ``dft_bt`` unless pinned
        here, and, on a mesh, the schedule (nfft/wfft) and, with
        ``overlap="auto"``, the overlap; every rank of the mesh must
        plan it, and they agree through rank 0).
      schedule: ``"local"`` | ``"nfft"`` | ``"wfft"`` | ``"auto"``
        (``nfft`` when a mesh is given, else ``local``).
      mesh: a ``torch.distributed`` ``DeviceMesh`` with ``data_axis`` and
        ``model_axis`` among its dim names
        (``repro_torch.launch.mesh.make_mesh``); required by the sharded
        schedules.  Cached plans key meshes by value (dim names, shape,
        rank layout, device type), so equal meshes share entries.
      three_m: 3-matmul (Karatsuba) vs 4-matmul complex product.
      bm, bn, bk: the CUDA CGEMM tile (``fft-cuda`` only; stored and
        unused on the other backends).  They must name one row of the
        kernel's compiled table ``kernels.cgemm.ops.SHAPES`` (``bm``
        alone does); the plan stores that row's full triple.  With
        ``backend="tuned"`` an explicit pin replaces the tuned tile.
      dft_bt: tiles a block of the inverse tile DFT kernel, the
        reference's tiles per grid step of the fused inverse: one of
        ``kernels.dft_tile.ops.INVERSE_TILES`` (anything else is a
        ``ValueError``), or ``None`` for the kernel's default.
        ``fft-cuda`` launches every inverse at it; stored and unused on the
        other backends.  With ``backend="tuned"`` a pin replaces the tuned
        value.
      compute_dtype: CGEMM operand dtype (e.g. ``torch.bfloat16``; float32
        accumulation).  On the sharded schedules the cast happens before
        the hot-path collective (nfft boundary all-to-all / wfft
        all-reduce), halving its bytes.
      data_axis, model_axis: the mesh dims the batch and the channels are
        sharded over.
      replicate_kernel_transform: nfft only — run the (cheap) kernel
        transform on every rank in place of boundary all-to-all #2.
      epilogue: ``Epilogue`` fused into stage 4 (bias add, activation,
        residual add).  The operand values are execution arguments:
        ``plan(x, k, bias=b, residual=r)``.
      spectrum: frequency-domain layout of the FFT pipelines: ``"real"``
        (the ``"auto"`` default, the compact Hermitian half-spectrum) or
        ``"complex"`` (the full-spectrum twin).
      overlap: comm/compute-overlapped execution of the sharded
        schedules: ``"slab:<k>"`` splits the per-rank batch into k
        sub-slabs and issues slab i+1's collective before slab i's hot
        CGEMM; slab counts are clamped to the per-rank batch.  ``"auto"``
        resolves (before the plan-cache key, so both share one plan) to
        ``"slab:2"`` on a mesh with a per-rank batch of at least 4, else
        to ``"off"``; with ``backend="tuned"`` the tuner measures the
        overlap axis instead.  ``"slab:<k>"`` on a local plan, or a
        malformed value, is a ``ValueError``, with the reference's
        message.
      stride: int or ``(s_h, s_w)``, at least 1.  Only ``direct`` runs a
        stride past 1: ``auto`` and ``tuned`` resolve such a geometry to
        it, and ``fft-torch``/``fft-cuda`` refuse it (``ValueError``).
        The output is ``((H + 2 p - k) // s + 1, ...)``, as ``F.conv2d``'s.
      cache: memoize the plan under its argument key (bounded LRU, see
        ``plan_cache_capacity``).

    ``backend="fft-cuda"`` with ``delta > 32`` is a ``ValueError``: its
    tile DFT kernels run up to delta 32 (``fft-torch`` runs any delta);
    so is a ``bm``/``bn``/``bk`` triple that names no row of its CGEMM,
    and, on any backend, a ``dft_bt`` its inverse was not compiled at.

    Returns:
      A frozen ``ConvPlan``; call it as ``plan(x, k)`` or split with
      ``plan.prepare(k)``.
    """
    global _cache_hits, _cache_misses
    _check_dft_bt(dft_bt)
    if isinstance(spec, ConvSpec):
        if k_shape is not None or padding is not None or delta is not None:
            raise TypeError(
                "plan_conv(spec, ...): a ConvSpec already carries k_shape/"
                "padding/delta — pass them only with the shape-tuple form")
        x_shape = (spec.B, spec.C, spec.H, spec.W)
        k_shape = (spec.Cout, spec.C, spec.kh, spec.kw)
        padding = (spec.pad_h, spec.pad_w)
        delta = spec.delta
    else:
        if k_shape is None:
            raise TypeError(
                "plan_conv(x_shape, k_shape, ...): k_shape is required "
                "with the shape-tuple form (or pass a ConvSpec)")
        x_shape = spec
        padding = 0 if padding is None else padding
        delta = 16 if delta is None else delta
    x_shape, k_shape = tuple(map(int, x_shape)), tuple(map(int, k_shape))
    padding = _normalize_padding(padding)
    stride = _normalize_stride(stride)
    epilogue = Epilogue() if epilogue is None else epilogue
    if mesh is not None:
        _check_mesh(mesh, data_axis, model_axis)
    if backend == "tuned":
        # Measured selection resolves BEFORE the plan cache, so the plan
        # is memoized under the *resolved* config: a cost-model fallback
        # (measurement disabled) is never frozen in — once the tuning
        # cache warms, the next call adopts the winner.
        if max(k_shape[2], k_shape[3]) > delta or stride != (1, 1):
            backend = "direct"      # oversize or strided: only direct fits
        else:
            from repro_torch.conv import autotune
            if schedule != "auto":
                # refused here, not after a sweep that refuses them all
                _check_schedule_mesh(schedule, mesh)
            # tune unpinned: pins constrain the *plan*, not the machine's
            # measured winner (pinned tune() calls get their own key)
            tuned = autotune.tune(
                x_shape, k_shape, padding=padding, delta=delta,
                schedule=schedule, mesh=mesh, three_m=three_m,
                compute_dtype=compute_dtype, data_axis=data_axis,
                model_axis=model_axis,
                replicate_kernel_transform=replicate_kernel_transform,
                spectrum=spectrum, overlap=overlap)
            backend = tuned.backend
            if schedule == "auto":
                schedule = tuned.schedule
            if spectrum == "auto":
                spectrum = tuned.spectrum
            if overlap == "auto":
                overlap = tuned.overlap
            # an explicit pin beats the tuned tile; the knobs name one
            # row together, so the pin replaces the whole triple
            if bm is None and bn is None and bk is None:
                bm, bn, bk = tuned.bm, tuned.bn, tuned.bk
            if dft_bt is None:
                dft_bt = tuned.dft_bt
    # "auto" is left only where the tuner did not run (another backend,
    # or an oversize kernel that went direct)
    overlap = _auto_overlap(overlap, x_shape, k_shape, delta, backend,
                            schedule, mesh, data_axis)
    if spectrum == "auto":
        spectrum = "real"    # deterministic default — share the cache entry
    key = (x_shape, k_shape, padding, delta, backend, schedule,
           _mesh_cache_key(mesh), three_m, bm, bn, bk, dft_bt, compute_dtype,
           data_axis, model_axis, replicate_kernel_transform, epilogue,
           spectrum, overlap)
    if stride != (1, 1):
        key += (stride,)    # a unit-stride key stays what it always was
    if cache:
        with _cache_lock:
            plan = _plan_cache.get(key)
            if plan is not None:
                _cache_hits += 1
                _plan_cache.move_to_end(key)
                return plan
    plan = _resolve(x_shape, k_shape, padding, delta, backend, schedule,
                    mesh, three_m, bm, bn, bk, dft_bt, compute_dtype,
                    data_axis, model_axis, replicate_kernel_transform,
                    epilogue, spectrum, overlap, stride)
    if cache:
        with _cache_lock:
            _cache_misses += 1
            _plan_cache[key] = plan
            _plan_cache.move_to_end(key)
            cap = plan_cache_capacity()
            while len(_plan_cache) > cap:
                _plan_cache.popitem(last=False)
    return plan


def conv2d(x, k, **kwargs):
    """One-shot convenience: ``plan_conv(x.shape, k.shape, **kwargs)(x, k)``.

    The plan cache makes repeated same-shape calls pay planning once.
    """
    return plan_conv(tuple(x.shape), tuple(k.shape), **kwargs)(x, k)
