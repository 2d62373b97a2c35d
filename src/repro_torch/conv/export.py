"""Plan artifacts for fleet cold-start (``repro_torch.conv.export``).

Serving a model on a fresh worker normally pays the whole plan lifecycle
again in every process: plan every layer (and, with ``backend="tuned"``,
measure every candidate), then transform every kernel (stage 2).  This
module does that work once and ships it:

    net = plan_network(layers, backend="fft-cuda")
    net.export("vgg.rpa", params=kernels, weights_version=7)  # build once

    # on a fresh worker: no planning, no tuning, no kernel transform
    loaded = load_network("vgg.rpa")
    y = loaded["conv1"](x, bias=b)                            # deploy many

The twin of the JAX package's export, with what stands in for its
StableHLO modules and XLA executables: nothing.  A CUDA graph cannot be
serialized, and the port's kernels are built from the checkout's sources
at first use, so an artifact carries the schedule and its data, and the
loaded layers run the port's own pipelines.  A single zip file holds:

  ``manifest.json``      the stamps a worker must share to load the
                         artifact ahead of time (artifact format, torch
                         and CUDA versions, device name and compute
                         capability, each kernel library's file name,
                         whose digest covers its source and flags, and
                         for a sharded plan the world size and the mesh),
                         the ``weights_version``, and per (net, layer) the
                         resolved plan config (enough to plan again live),
                         a plan-lint ``PlanProfile`` fingerprint and the
                         names of its tensors;
  ``tensors/<sha>.npy``  the prepared kernel slabs (stage 2's output in
                         the layout the schedule consumes: for ``nfft``
                         each rank's P/N slab, gathered to rank 0) and the
                         raw kernels, stored uncompressed and named by the
                         sha256 of their bytes, so equal tensors (the same
                         layer in several batch buckets) are stored once.
                         A bfloat16 tensor is stored as its ``uint16``
                         bits, its dtype named in the manifest.

``load_network`` checks the stamps.  A compatible artifact loads ahead of
time (``source="aot"``): each layer's ``ConvPlan`` is built from its
stored config with no ``plan_conv`` call (the plan cache and the tuner are
not consulted), and its ``PreparedConv`` from the stored slabs with no
stage 2; each distinct tensor is put on the device once, shared read-only
by every layer that names it.  On a mismatch it warns and plans live from
the stored configs and kernels (``on_mismatch="error"`` raises
``ArtifactMismatch`` instead).  ``verify`` plans every stored config live
and compares the fingerprints: the certificate that the artifact runs the
schedule it was built from.

On a mesh every rank calls ``export_network`` and ``load_network`` alike
(SPMD).  Export gathers every rank's slabs to rank 0 in one collective;
rank 0 alone writes the file, and the ranks meet at a barrier.  Load binds
the caller's ``DeviceMesh`` (or makes one from the default group), each
rank reads its own slabs, and the ranks agree through rank 0 on loading
ahead of time or live (``launch.mesh.RankDecisions``): a rank that alone
fell back would wait forever in its peers' first collective.
"""
from __future__ import annotations

import collections
import dataclasses
import hashlib
import io
import json
import os
import struct
import warnings
import zipfile
from typing import Any, Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.conv.epilogue import Epilogue
from repro_torch.device import resolve_device

ARTIFACT_VERSION = 1

# The PlanProfile facts a fingerprint certifies: everything structural
# about the schedule (backend/schedule/collectives/stage ops/spectrum/
# overlap/epilogue/precision), nothing measured or byte-counted.
FINGERPRINT_FIELDS = (
    "backend", "schedule", "prepared", "collectives", "stage_counts",
    "spectrum", "overlap", "num_slabs", "epilogue", "compute_dtype",
    "cgemm_dtypes",
)

# The stamps ``compat_reasons`` compares, in the order it names them.
STAMPS = ("artifact_version", "torch_version", "cuda_version", "device_name",
          "compute_capability", "kernels", "world_size", "mesh")


class ArtifactMismatch(RuntimeError):
    """The artifact cannot be used as it is on this worker."""


# --------------------------------------------------------------------------
# Fingerprints (plan-lint certificate)
# --------------------------------------------------------------------------

def plan_fingerprint(plan, *, prepared: bool = False, device=None) -> str:
    """sha256 over the structural subset of the plan's ``PlanProfile``
    (``FINGERPRINT_FIELDS``), analyzed on fake tensors on ``device``
    (``ConvPlan.analyze``'s default when ``None``): the same in every
    process of one version of the port, so a fresh worker can certify an
    artifact by planning live and comparing."""
    prof = plan.analyze(prepared=prepared, device=device).to_dict()
    payload = {k: prof.get(k) for k in FINGERPRINT_FIELDS}
    blob = json.dumps(payload, sort_keys=True, default=str).encode()
    return "sha256:" + hashlib.sha256(blob).hexdigest()


# --------------------------------------------------------------------------
# Plan config (de)serialization: enough to plan again live
# --------------------------------------------------------------------------

def _dtype_name(dt) -> Optional[str]:
    return None if dt is None else str(dt).removeprefix("torch.")


def _dtype(name: Optional[str]):
    return None if name is None else getattr(torch, name)


def _mesh_config(mesh) -> Optional[dict]:
    if mesh is None:
        return None
    return {"axis_names": list(mesh.mesh_dim_names),
            "shape": [int(s) for s in mesh.mesh.shape],
            "device_type": mesh.device_type}


def _bind_mesh(cfg: Optional[dict], mesh=None):
    """The mesh a stored sharded config plans on: the caller's, which must
    have the stored axis names (its shape may differ: a live plan takes
    any mesh), or one of the stored shape over the default process
    group.  ``None`` for a local config."""
    if cfg is None:
        return None
    if mesh is not None:
        missing = set(cfg["axis_names"]) - set(mesh.mesh_dim_names or ())
        if missing:
            raise ArtifactMismatch(
                f"artifact mesh axes {cfg['axis_names']} are not all on the "
                f"given mesh ({mesh.mesh_dim_names})")
        return mesh
    from repro_torch.launch.mesh import make_mesh
    if not dist.is_initialized():
        raise ArtifactMismatch(
            f"artifact plans on a mesh {tuple(cfg['shape'])}: start a "
            "process group (launch.mesh.start_process_group) or pass mesh=")
    try:
        return make_mesh(cfg["shape"], cfg["axis_names"],
                         device_type=cfg["device_type"])
    except RuntimeError as e:
        raise ArtifactMismatch(str(e)) from e


def plan_config(plan) -> dict:
    """JSON-able resolved plan config, with the JAX package's keys
    (``backend`` holds the port's name), and ``stride`` where it is not 1
    (a unit-stride record is the JAX package's); ``rebuild_plan`` inverts
    it."""
    cfg = {
        "x_shape": list(plan.x_shape),
        "k_shape": list(plan.k_shape),
        "padding": list(plan.padding),
        "delta": int(plan.spec.delta),
        "backend": plan.backend,
        "schedule": plan.schedule,
        "three_m": bool(plan.three_m),
        "bm": plan.bm, "bn": plan.bn, "bk": plan.bk,
        "dft_bt": plan.dft_bt,
        "compute_dtype": _dtype_name(plan.compute_dtype),
        "mesh": _mesh_config(plan.mesh),
        "data_axis": plan.data_axis,
        "model_axis": plan.model_axis,
        "replicate_kernel_transform": bool(plan.replicate_kernel_transform),
        "epilogue": {"bias": plan.epilogue.bias,
                     "activation": plan.epilogue.activation,
                     "residual": plan.epilogue.residual},
        "spectrum": plan.spectrum,
        "overlap": plan.overlap,
    }
    if plan.strided:
        cfg["stride"] = list(plan.stride)
    return cfg


def _plan_kwargs(cfg: dict, mesh) -> dict:
    return dict(
        backend=cfg["backend"], schedule=cfg["schedule"], mesh=mesh,
        three_m=cfg["three_m"], bm=cfg["bm"], bn=cfg["bn"], bk=cfg["bk"],
        dft_bt=cfg["dft_bt"], compute_dtype=_dtype(cfg["compute_dtype"]),
        data_axis=cfg["data_axis"], model_axis=cfg["model_axis"],
        replicate_kernel_transform=cfg["replicate_kernel_transform"],
        epilogue=Epilogue(**cfg["epilogue"]), spectrum=cfg["spectrum"],
        overlap=cfg["overlap"],
        stride=tuple(int(s) for s in cfg.get("stride", (1, 1))))


def rebuild_plan(cfg: dict, *, mesh=None):
    """Plan live from a stored config through ``plan_conv`` (the fallback
    and ``verify``).  A sharded config plans on ``mesh`` (``_bind_mesh``);
    raises ``ArtifactMismatch`` when no mesh can be had here."""
    from repro_torch.conv.plan import plan_conv
    return plan_conv(
        tuple(cfg["x_shape"]), tuple(cfg["k_shape"]),
        padding=tuple(cfg["padding"]), delta=int(cfg["delta"]),
        **_plan_kwargs(cfg, _bind_mesh(cfg.get("mesh"), mesh)))


def _aot_plan(cfg: dict, mesh):
    """The ``ConvPlan`` of a stored config, built directly: no
    ``plan_conv`` call, so neither the plan cache nor the tuner sees it.
    A sharded plan holds the caller's ``mesh`` object."""
    from repro_torch.conv.plan import ConvPlan, _build_spec
    kw = _plan_kwargs(cfg, mesh if cfg.get("mesh") is not None else None)
    padding = tuple(int(p) for p in cfg["padding"])
    spec = _build_spec(tuple(cfg["x_shape"]), tuple(cfg["k_shape"]),
                       padding, int(cfg["delta"]))
    return ConvPlan(spec=spec, padding=padding, **kw)


# --------------------------------------------------------------------------
# Stamps
# --------------------------------------------------------------------------

def _kernel_libraries() -> dict:
    """Each CUDA kernel library's file name, whose digest covers its
    source and compiler flags (computed without ``nvcc``)."""
    from repro_torch.kernels import _build
    return {name: _build.library(name).name for name in _build.KERNELS}


def _stamps(device: torch.device, mesh) -> dict:
    on_card = device.type == "cuda"
    cc = torch.cuda.get_device_capability(device) if on_card else None
    return {
        "artifact_version": ARTIFACT_VERSION,
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "device_name": (torch.cuda.get_device_name(device) if on_card
                        else device.type),
        "compute_capability": None if cc is None else f"{cc[0]}.{cc[1]}",
        "kernels": _kernel_libraries(),
        "world_size": dist.get_world_size() if mesh is not None else None,
        "mesh": _mesh_config(mesh),
    }


def compat_reasons(manifest: dict, *, device=None, mesh=None) -> list:
    """Why this artifact cannot load ahead of time on this worker, on
    ``device`` (or the ``mesh``'s device) and ``mesh`` ([] = compatible):
    every stamp that differs, by name."""
    if mesh is not None:
        device = _mesh_device(mesh)
    here = _stamps(resolve_device(device), mesh)
    return [f"{key} {manifest.get(key)!r} != {here[key]!r}"
            for key in STAMPS if manifest.get(key) != here[key]]


def _mesh_device(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


# --------------------------------------------------------------------------
# Export
# --------------------------------------------------------------------------

def _as_net_mapping(net) -> "collections.OrderedDict":
    """NetworkPlan | BucketedNetworkPlan | Mapping[label, NetworkPlan] as
    an ordered label -> NetworkPlan mapping."""
    from repro_torch.conv.netplan import BucketedNetworkPlan, NetworkPlan
    if isinstance(net, NetworkPlan):
        return collections.OrderedDict([("net", net)])
    if isinstance(net, BucketedNetworkPlan):
        return collections.OrderedDict(
            (f"b{b}", n) for b, n in net.items())
    return collections.OrderedDict(
        (str(label), n) for label, n in net.items())


def _npy(t: torch.Tensor) -> tuple:
    """(``.npy`` bytes, dtype name) of a tensor, bfloat16 as its bits."""
    t = t.detach().cpu().contiguous()
    name = _dtype_name(t.dtype)
    arr = (t.view(torch.int16).numpy().view(np.uint16)
           if t.dtype == torch.bfloat16 else t.numpy())
    bio = io.BytesIO()
    np.save(bio, arr, allow_pickle=False)
    return bio.getvalue(), name


def _add(tensors: dict, t: torch.Tensor) -> str:
    """Store ``t`` under the sha256 of its bytes (once); its member name."""
    data, dtype = _npy(t)
    member = "tensors/" + hashlib.sha256(data).hexdigest()[:32] + ".npy"
    tensors.setdefault(member, (data, dtype, list(t.shape)))
    return member


def _state_leaves(state) -> tuple:
    """(format, leaves) of a prepared state: a pipeline's (Gr, Gi) pair,
    or an opaque backend's raw kernel."""
    if isinstance(state, tuple):
        return "tuple", list(state)
    if isinstance(state, torch.Tensor):
        return "leaf", [state]
    raise ValueError(
        f"unsupported prepared-state structure {type(state).__name__} "
        "(export knows tuples of tensors and single tensors)")


def _export_device(nets, params, device) -> torch.device:
    for n in nets.values():
        for p in n.plans.values():
            if p.mesh is not None:
                return _mesh_device(p.mesh)
    if params:
        for v in params.values():
            if isinstance(v, torch.Tensor):
                return v.device
    return resolve_device(device)


def _one_mesh(nets):
    meshes = {id(p.mesh): p.mesh for n in nets.values()
              for p in n.plans.values() if p.mesh is not None}
    if len(meshes) > 1:
        raise ValueError("export: every sharded plan of an artifact must "
                         "plan on one mesh")
    return next(iter(meshes.values()), None)


def export_network(net, path: str, *, params: Optional[Mapping] = None,
                   weights_version=None, dtype=None, device=None) -> str:
    """Write ``net`` (a ``NetworkPlan``, a ``BucketedNetworkPlan``, whose
    labels are ``b<batch>``, or a label -> ``NetworkPlan`` mapping) to one
    artifact at ``path`` and return ``path``.

    With ``params`` (layer name -> kernel) the layers export *prepared*:
    each layer's ``prepare`` under ``weights_version`` (a prepared-cache
    hit when the caller prepared it already) gives the slabs that ride
    along, with the raw kernel.  Without, the artifact is unprepared and a
    loaded layer takes ``(x, k)``.  The stamps name the device of a
    sharded plan's mesh, else the one the params lie on, else ``device``
    (the GPU unless asked).  ``dtype`` is the stamped activation dtype
    (default float32).  On a mesh every rank must call this alike: rank 0 gathers
    the slabs and writes the file."""
    nets = _as_net_mapping(net)
    prepared = params is not None
    mesh = _one_mesh(nets)
    dev = _export_device(nets, params, device)
    manifest: dict = dict(_stamps(dev, mesh))
    manifest.update({
        "weights_version": weights_version,
        "prepared": prepared,
        "dtype": _dtype_name(torch.float32 if dtype is None else dtype),
        "nets": {},
    })
    tensors: dict = {}                  # member -> (bytes, dtype, shape)
    states: dict = {}                   # (label, layer) -> this rank's
    fingerprints: dict = {}             # id(plan) -> fingerprint
    for label, nplan in nets.items():
        layers: dict = {}
        for name, plan in nplan.items():
            entry = dict(plan_config(plan))
            key = id(plan)
            if key not in fingerprints:  # same-geometry layers share one
                fingerprints[key] = plan_fingerprint(plan, prepared=prepared)
            entry["fingerprint"] = fingerprints[key]
            entry["prepared"] = prepared
            entry["kernel"] = None
            entry["state"] = []
            if prepared:
                if name not in params:
                    raise ValueError(
                        f"export: params missing kernel for {name!r}")
                pc = plan.prepare(params[name],
                                  weights_version=weights_version)
                fmt, leaves = _state_leaves(pc.state)
                entry["state_format"] = fmt
                states[(label, name)] = [_add(tensors, t) for t in leaves]
                entry["kernel"] = _add(tensors, params[name])
            layers[name] = entry
        manifest["nets"][label] = {"layers": layers}
    if mesh is not None:
        tensors = _gather_states(manifest, tensors, states)
    else:
        for (label, name), members in states.items():
            manifest["nets"][label]["layers"][name]["state"] = members
    if tensors is not None:
        manifest["tensors"] = {m: {"dtype": d, "shape": s}
                               for m, (_, d, s) in sorted(tensors.items())}
        _write(path, manifest, tensors)
    if mesh is not None:
        dist.barrier()
    return path


def _gather_states(manifest, tensors, states):
    """Every rank's slab names and the tensors rank 0 lacks, gathered to
    rank 0 in one collective on every rank; each sharded entry gets
    ``rank_state`` (one member list per global rank) in place of
    ``state``.  Returns the tensors to write on rank 0, else None."""
    rank, world = dist.get_rank(), dist.get_world_size()
    # rank 0 keeps its own bytes; the others send theirs
    mine = (states, {} if rank == 0 else tensors)
    box = [None] * world if rank == 0 else None
    dist.gather_object(mine, box, dst=0)
    if rank != 0:
        return None
    for _, theirs in box:
        for m, v in theirs.items():
            tensors.setdefault(m, v)
    for (label, name) in states:
        entry = manifest["nets"][label]["layers"][name]
        entry["rank_state"] = [box[r][0][(label, name)]
                               for r in range(world)]
    return tensors


def _write(path: str, manifest: dict, tensors: dict) -> None:
    """The zip, written to ``<path>.tmp`` and renamed into place: tensors
    stored uncompressed (deflating float noise costs much and saves
    nothing), the manifest deflated."""
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with zipfile.ZipFile(tmp, "w", zipfile.ZIP_STORED) as zf:
        for member, (data, _, _) in sorted(tensors.items()):
            zf.writestr(member, data)
        zf.writestr("manifest.json",
                    json.dumps(manifest, indent=1, sort_keys=True),
                    compress_type=zipfile.ZIP_DEFLATED)
    os.replace(tmp, path)


# --------------------------------------------------------------------------
# Load
# --------------------------------------------------------------------------

@dataclasses.dataclass(eq=False)
class LoadedConv:
    """One loaded layer: its plan built from the stored config and, when
    prepared, its ``PreparedConv`` over the stored slabs.  Called as a
    ``PreparedConv`` (prepared: ``layer(x, bias=..., residual=...)``) or
    a ``ConvPlan`` (unprepared: ``layer(x, k, bias=...)``).  ``native``
    is always False: the port ships no executable (the JAX package's
    deserialized XLA executables set it)."""
    name: str
    config: dict
    fingerprint: str
    prepared: bool
    epilogue: Epilogue
    state: tuple
    plan: Any
    _call: Any
    native: bool = False

    @property
    def x_shape(self) -> tuple:
        return tuple(self.config["x_shape"])

    @property
    def k_shape(self) -> tuple:
        return tuple(self.config["k_shape"])

    def __call__(self, x, *args, bias=None, residual=None):
        ep = self.epilogue
        if self.prepared:
            if args:
                raise TypeError(
                    f"prepared loaded layer {self.name!r} takes only x "
                    "(the kernel is baked into the artifact)")
        elif len(args) != 1:
            raise TypeError(
                f"unprepared loaded layer {self.name!r} takes (x, k)")
        if ep.bias != (bias is not None):
            raise ValueError(
                f"layer {self.name!r} epilogue declares bias={ep.bias} "
                f"but bias {'was not' if ep.bias else 'was'} passed")
        if ep.residual != (residual is not None):
            raise ValueError(
                f"layer {self.name!r} epilogue declares residual="
                f"{ep.residual} but residual "
                f"{'was not' if ep.residual else 'was'} passed")
        return self._call(x, *args, bias=bias, residual=residual)


@dataclasses.dataclass(frozen=True, eq=False)
class LoadedNetwork:
    """A loaded network: Mapping-like over its layers, duck-typed to
    ``PreparedNetwork``.  ``source`` is ``"aot"`` (built from the stored
    configs and slabs) or ``"live"`` (the fallback planned and prepared
    the artifact's configs and kernels again)."""
    layers: "collections.OrderedDict"
    weights_version: Any
    source: str
    fingerprints: dict

    def __getitem__(self, name):
        return self.layers[name]

    def __iter__(self):
        return iter(self.layers)

    def __len__(self):
        return len(self.layers)

    def items(self):
        return self.layers.items()

    @property
    def x_shape(self) -> tuple:
        first = next(iter(self.layers.values()))
        if hasattr(first, "x_shape"):
            return tuple(first.x_shape)
        return tuple(first.plan.x_shape)


def read_manifest(path: str) -> dict:
    with zipfile.ZipFile(path) as zf:
        return json.loads(zf.read("manifest.json"))


class _Tensors:
    """Each member of the artifact read once and put on ``device`` once;
    every layer naming it shares that tensor.  A member's array is read
    straight from its offset in the file into its own buffer (members are
    stored uncompressed): no copy through ``zipfile``'s buffers."""

    def __init__(self, raw, zf, manifest, device):
        self._raw, self._zf = raw, zf
        self._info, self._device = manifest["tensors"], device
        self._cache: dict = {}

    def _array(self, member: str) -> np.ndarray:
        zi = self._zf.getinfo(member)
        if zi.compress_type != zipfile.ZIP_STORED:
            raise ArtifactMismatch(f"artifact member {member!r} is "
                                   "compressed; tensors are stored")
        f = self._raw
        f.seek(zi.header_offset + 26)   # the local header's name/extra sizes
        name_len, extra_len = struct.unpack("<HH", f.read(4))
        f.seek(zi.header_offset + 30 + name_len + extra_len)
        version = np.lib.format.read_magic(f)
        read_header = (np.lib.format.read_array_header_1_0 if version ==
                       (1, 0) else np.lib.format.read_array_header_2_0)
        shape, fortran, dtype = read_header(f)
        if fortran or dtype.hasobject:
            raise ArtifactMismatch(f"artifact member {member!r} is not a "
                                   "C-ordered plain array")
        arr = np.empty(shape, dtype)
        if f.readinto(memoryview(arr).cast("B")) != arr.nbytes:
            raise ArtifactMismatch(f"artifact member {member!r} is "
                                   "truncated")
        return arr

    def __call__(self, member: str) -> torch.Tensor:
        t = self._cache.get(member)
        if t is None:
            arr = self._array(member)
            if self._info[member]["dtype"] == "bfloat16":
                t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
            else:
                t = torch.from_numpy(arr)
            t = self._cache[member] = t.to(self._device)
        return t


def _load_layer_aot(name, entry, mesh, tensors, weights_version):
    from repro_torch.conv.plan import PreparedConv
    plan = _aot_plan(entry, mesh)
    state: tuple = ()
    call = plan
    if entry["prepared"]:
        members = (entry["rank_state"][dist.get_rank()]
                   if "rank_state" in entry else entry["state"])
        state = tuple(tensors(m) for m in members)
        call = PreparedConv(
            plan=plan, state=state if entry["state_format"] == "tuple"
            else state[0], kernel=tensors(entry["kernel"]),
            weights_version=weights_version)
    return LoadedConv(name=name, config=entry,
                      fingerprint=entry["fingerprint"],
                      prepared=entry["prepared"], epilogue=plan.epilogue,
                      state=state, plan=plan, _call=call)


def _load_layer_live(name, entry, mesh, tensors, weights_version):
    plan = rebuild_plan(entry, mesh=mesh)
    if entry["prepared"]:
        return plan.prepare(tensors(entry["kernel"]),
                            weights_version=weights_version)
    return plan


def load_network(path: str, *, on_mismatch: str = "fallback", device=None,
                 mesh=None):
    """Load an artifact on this worker, on ``device`` (the GPU unless
    asked) or, for a sharded artifact, on ``mesh`` (default: one of the
    stored shape over the default process group) and its device.

    A compatible artifact loads ahead of time: no planning, no tuning, no
    kernel transform.  An incompatible one (another stamp: torch or CUDA
    version, device, kernel sources, world size or mesh) falls back to
    planning live from the stored configs and kernels, with a warning
    (``on_mismatch="error"`` raises ``ArtifactMismatch`` instead).  On a
    mesh the ranks agree: one rank's mismatch makes every rank fall back
    (or raise).

    Returns a ``LoadedNetwork`` for a single-net artifact, else an
    ``OrderedDict[label, LoadedNetwork]`` (bucketed exports)."""
    if on_mismatch not in ("fallback", "error"):
        raise ValueError(f"unknown on_mismatch {on_mismatch!r}")
    manifest = read_manifest(path)
    mesh = _bind_mesh(manifest.get("mesh"), mesh)
    dev = _mesh_device(mesh) if mesh is not None else resolve_device(device)
    reasons = compat_reasons(manifest, device=dev, mesh=mesh)
    if mesh is not None:
        from repro_torch.launch.mesh import RankDecisions
        if RankDecisions(mesh, what="load_network").any(bool(reasons)) \
                and not reasons:
            reasons = ["another rank of the mesh cannot load it ahead of "
                       "time"]
    if reasons:
        if on_mismatch == "error":
            raise ArtifactMismatch(
                f"plan artifact {path!r} incompatible: "
                + "; ".join(reasons))
        warnings.warn(
            f"plan artifact {path!r} incompatible ({'; '.join(reasons)}); "
            "falling back to live planning", stacklevel=2)
    source = "live" if reasons else "aot"
    load = _load_layer_live if reasons else _load_layer_aot
    wv = manifest.get("weights_version")
    out: "collections.OrderedDict" = collections.OrderedDict()
    with open(path, "rb", buffering=0) as raw, zipfile.ZipFile(raw) as zf:
        tensors = _Tensors(raw, zf, manifest, dev)
        for label, ncfg in manifest["nets"].items():
            layers: "collections.OrderedDict" = collections.OrderedDict()
            fps = {}
            for name, entry in ncfg["layers"].items():
                fps[name] = entry["fingerprint"]
                layers[name] = load(name, entry, mesh, tensors, wv)
            out[label] = LoadedNetwork(layers=layers, weights_version=wv,
                                       source=source, fingerprints=fps)
    if list(out) == ["net"]:
        return out["net"]
    return out


def verify(path: str) -> dict:
    """Plan-lint certificate: plan every stored layer config LIVE on this
    worker (through ``plan_conv``: the plan cache, no kernel runs; a
    sharded config on a mesh of the stored shape over the default process
    group), fingerprint it and compare against the export-time stamp.
    Returns ``{"ok": bool, "n_checked": int, "mismatches": [...]}``."""
    manifest = read_manifest(path)
    mesh = _bind_mesh(manifest.get("mesh"))
    mismatches = []
    seen: dict = {}                     # (id(plan), prepared) -> fingerprint
    n = 0
    for label, ncfg in manifest["nets"].items():
        for name, entry in ncfg["layers"].items():
            n += 1
            plan = rebuild_plan(entry, mesh=mesh)
            key = (id(plan), entry["prepared"])
            if key not in seen:
                seen[key] = plan_fingerprint(plan,
                                             prepared=entry["prepared"])
            if seen[key] != entry["fingerprint"]:
                mismatches.append(
                    {"net": label, "layer": name,
                     "exported": entry["fingerprint"], "live": seen[key]})
    return {"ok": not mismatches, "n_checked": n,
            "mismatches": mismatches}
