"""Atomic, async checkpointing with elastic restore, and plan artifacts
beside the weights.  The twin of the JAX package's checkpoint store, with
its on-disk layout, so a checkpoint written by either package restores
in the other.

Layout: ``<dir>/step_<N>/`` holds one ``leaf_<i>.npy`` a leaf (named by
``meta.json``'s ``files`` map, keyed by ``keystr`` paths of
``torch.utils._pytree``, which spells dict, list and namedtuple paths as
``jax.tree_util.keystr`` does: ``['lst'][1].w``) and ``meta.json``
(``format`` 2).  Writes go to ``step_<N>.tmp`` and then ``os.rename``
(the atomic commit): a crash mid-save never corrupts the newest
checkpoint, and a restart picks the newest *committed* step.
``save_async`` copies the tensors to the host first (the only
synchronous part) and writes them on a worker thread.  A ``DTensor`` leaf
is saved from its ``full_tensor()``.  A bfloat16 leaf, which numpy cannot
hold, is saved as its ``uint16`` bits, with its dtype in ``meta.json``'s
``dtypes`` map.

Elastic restore: each leaf is read on the host and put on ``device`` (the
GPU unless the caller asks for another), or, where ``shardings`` names a
``(DeviceMesh, placements)`` pair for it, placed with
``torch.distributed.tensor.distribute_tensor``: a checkpoint taken on one
mesh restores onto another.  Checkpoints of the pre-``keystr`` layout
(no ``files`` map; keys joined from ``.key``/``.idx``) still restore.

Plan artifacts (``repro_torch.conv.export``) ride next to the weights:
``save_plan_artifact`` attaches one ``plans.rpa`` to a committed step
(one artifact per ``weights_version``) and ``load_plan_artifact`` loads
it on a fresh worker.  A weight update means a new step, so a new
artifact (the serve engine's ``update_weights`` likewise drops a loaded
artifact and plans live).
"""
from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.device import resolve_device


def _legacy_key(path) -> str:
    """Pre-keystr key derivation, kept only to restore old checkpoints
    (it can collide distinct paths: a dict key ``"a.b"`` and nested
    ``a -> b`` join alike)."""
    return ".".join(str(getattr(p, "key", getattr(p, "idx", p)))
                    for p in path)


def _is_placement(x) -> bool:
    """A ``shardings`` leaf: ``None`` or a ``(DeviceMesh, placements)``
    pair (which pytree would otherwise flatten into its parts)."""
    from torch.distributed.device_mesh import DeviceMesh
    return x is None or (isinstance(x, tuple) and len(x) == 2
                         and isinstance(x[0], DeviceMesh))


def _flatten(tree, *, legacy: bool = False, is_leaf=None) -> dict:
    flat = pytree.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]
    out = {}
    for path, leaf in flat:
        key = _legacy_key(path) if legacy else pytree.keystr(path)
        if key in out:
            raise ValueError(
                f"checkpoint: two leaves flatten to the same key {key!r}")
        out[key] = leaf
    return out


def _to_host(v) -> np.ndarray:
    """A leaf as a host array: a ``DTensor`` whole, a tensor detached and
    copied, anything else through ``np.asarray``; bfloat16 as its
    ``uint16`` bits."""
    from torch.distributed.tensor import DTensor
    if isinstance(v, DTensor):
        v = v.full_tensor()
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        if v.dtype == torch.bfloat16:
            return v.view(torch.int16).numpy().view(np.uint16)
        return v.numpy()
    return np.asarray(v)


def _host_tree(tree):
    """(key -> host array, key -> dtype name for the bfloat16 leaves)."""
    flat = _flatten(tree)
    dtypes = {k: "bfloat16" for k, v in flat.items()
              if isinstance(v, torch.Tensor) and v.dtype == torch.bfloat16}
    return {k: _to_host(v) for k, v in flat.items()}, dtypes


def _file_map(keys) -> dict:
    """Injective key -> filename map (by index: a ``keystr`` path may hold
    any character of a dict key, so keys never become filenames)."""
    return {k: f"leaf_{i:05d}.npy" for i, k in enumerate(sorted(keys))}


def _make_meta(step: int, host: dict, dtypes: dict, extra,
               weights_version) -> dict:
    meta = {"step": step, "format": 2, "keys": sorted(host),
            "files": _file_map(host), "weights_version": weights_version,
            "extra": extra or {}}
    if dtypes:
        meta["dtypes"] = dtypes
    return meta


def _commit(ckpt_dir: str, step: int, host: dict, meta: dict) -> str:
    """Write the step into ``step_<N>.tmp`` and rename it into place."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    files = meta["files"]
    for k, v in host.items():
        np.save(os.path.join(tmp, files[k]), v)
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)           # atomic commit
    return final


def save(ckpt_dir: str, step: int, tree, *, extra: dict | None = None,
         weights_version=None) -> str:
    """Synchronous atomic save of a pytree of tensors (``DTensor``s
    included); returns the step's directory."""
    os.makedirs(ckpt_dir, exist_ok=True)
    host, dtypes = _host_tree(tree)
    return _commit(ckpt_dir, step, host,
                   _make_meta(step, host, dtypes, extra, weights_version))


_PENDING: list[threading.Thread] = []


def save_async(ckpt_dir: str, step: int, tree, *, extra: dict | None = None,
               weights_version=None) -> threading.Thread:
    """Copy to the host synchronously, write and commit on a worker
    thread (``wait_pending`` joins them)."""
    host, dtypes = _host_tree(tree)
    meta = _make_meta(step, host, dtypes, extra, weights_version)
    os.makedirs(ckpt_dir, exist_ok=True)
    t = threading.Thread(target=_commit, args=(ckpt_dir, step, host, meta),
                         daemon=True)
    t.start()
    _PENDING.append(t)
    return t


def wait_pending() -> None:
    for t in _PENDING:
        t.join()
    _PENDING.clear()


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def _from_host(arr: np.ndarray, dtype) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def restore(ckpt_dir: str, step: int, target_tree, *, shardings=None,
            device=None):
    """Restore into the structure of ``target_tree``: each leaf on
    ``device`` (``repro_torch.device.resolve_device``: the GPU unless
    asked), or placed by its ``(DeviceMesh, placements)`` pair in
    ``shardings`` (a tree of the same structure whose leaves are those
    pairs or ``None``): the elastic restore onto another mesh.  Returns
    ``(tree, meta)``."""
    from torch.distributed.tensor import distribute_tensor
    dev = resolve_device(device)
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)
    legacy = "files" not in meta      # pre-keystr checkpoint layout
    files = meta.get("files", {})
    dtypes = meta.get("dtypes", {})

    def fname(k):
        return files[k] if not legacy else k + ".npy"

    flat_target = _flatten(target_tree, legacy=legacy)
    flat_shard = ({} if shardings is None else
                  _flatten(shardings, legacy=legacy, is_leaf=_is_placement))
    loaded = {}
    for k in flat_target:
        t = _from_host(np.load(os.path.join(d, fname(k)),
                               allow_pickle=False), dtypes.get(k))
        place = flat_shard.get(k)
        if place is not None:
            mesh, placements = place
            loaded[k] = distribute_tensor(t.to(mesh.device_type), mesh,
                                          placements)
        else:
            loaded[k] = t.to(dev)
    paths, spec = pytree.tree_flatten_with_path(target_tree)
    keys = [_legacy_key(path) if legacy else pytree.keystr(path)
            for path, _ in paths]
    return pytree.tree_unflatten([loaded[k] for k in keys], spec), meta


# --------------------------------------------------------------------------
# Plan artifacts next to the weights (repro_torch.conv.export)
# --------------------------------------------------------------------------

PLAN_ARTIFACT = "plans.rpa"


def plan_artifact_path(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:08d}", PLAN_ARTIFACT)


def has_plan_artifact(ckpt_dir: str, step: int) -> bool:
    return os.path.exists(plan_artifact_path(ckpt_dir, step))


def save_plan_artifact(ckpt_dir: str, step: int, net, params, *,
                       weights_version=None) -> str:
    """Attach a plan artifact to a *committed* checkpoint step, so that a
    fresh worker restoring these weights also skips planning, tuning and
    the kernel transforms.  ``net`` is a ``NetworkPlan``,
    ``BucketedNetworkPlan`` or label mapping; ``weights_version``
    defaults to the step (one artifact per weights version)."""
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    if not os.path.isdir(d):
        raise FileNotFoundError(
            f"no committed checkpoint step {step} under {ckpt_dir!r}; "
            "save the weights first")
    from repro_torch.conv.export import export_network
    wv = step if weights_version is None else weights_version
    return export_network(net, plan_artifact_path(ckpt_dir, step),
                          params=params, weights_version=wv)


def load_plan_artifact(ckpt_dir: str, step: int, **load_kwargs):
    """Load the plan artifact attached to a checkpoint step (keyword
    arguments pass to ``repro_torch.conv.export.load_network``)."""
    p = plan_artifact_path(ckpt_dir, step)
    if not os.path.exists(p):
        raise FileNotFoundError(
            f"checkpoint step {step} under {ckpt_dir!r} has no plan "
            f"artifact ({PLAN_ARTIFACT})")
    from repro_torch.conv.export import load_network
    return load_network(p, **load_kwargs)
