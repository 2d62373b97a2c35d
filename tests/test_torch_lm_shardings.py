"""The sharding rules and shape stand-ins of the port against the JAX
package's (``repro_torch.launch.shardings`` / ``specs`` against
``repro.launch.shardings`` / ``specs``): twins of ``tests/test_launch.py``'s
``test_param_specs_match_struct`` and ``test_cache_specs_match_struct``,
made stronger: for every architecture at full width and every shape cell,
on shape-only (16, 16) and (2, 16, 16) meshes, each spec equals the
reference's as a tuple, leaf for leaf, over equal tree structures; and
each stand-in has the reference's shape and dtype."""
import functools

import jax
import pytest
import torch
from torch.utils import _pytree

from repro.configs import (ARCH_NAMES, LONG_CONTEXT_OK,
                           get_config as jget_config)
from repro.launch import shardings as JSH
from repro.launch import specs as JSP
from repro.models.common import SHAPES as JSHAPES
from repro_torch.configs import get_config as tget_config
from repro_torch.launch import mesh as M
from repro_torch.launch import shardings as TSH
from repro_torch.launch import specs as TSP
from repro_torch.models.common import SHAPES as TSHAPES
from repro_torch.parallel.act_sharding import P, placements

import torch_lm_common as C


class _FakeMesh:
    """Shape-only stand-in (no process group, no device)."""
    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


MESHES = [_FakeMesh({"data": 16, "model": 16}),
          _FakeMesh({"pod": 2, "data": 16, "model": 16})]
CELLS = [s.name for s in TSHAPES]


def _cell(name):
    return ([s for s in JSHAPES if s.name == name][0],
            [s for s in TSHAPES if s.name == name][0])


@functools.lru_cache(maxsize=None)
def _structs(arch):
    """Both packages' parameter structs of ``arch`` at full width."""
    return (JSP.param_structs(jget_config(arch)),
            TSP.param_structs(tget_config(arch)))


def _jax_specs(tree):
    """{key string: spec tuple} of a reference spec tree."""
    return {jax.tree_util.keystr(p): tuple(s) for p, s in
            jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: isinstance(
                    x, jax.sharding.PartitionSpec))[0]}


def _torch_specs(tree):
    """{key string: spec tuple} of a port spec tree (every leaf a spec)."""
    flat = {_pytree.keystr(p): s for p, s in _pytree.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))[0]}
    assert all(isinstance(s, P) for s in flat.values())
    return {k: tuple(s) for k, s in flat.items()}


def _assert_specs_equal(got, want, what):
    g, w = _torch_specs(got), _jax_specs(want)
    assert sorted(g) == sorted(w), (what, sorted(set(g) ^ set(w)))
    bad = {k: (g[k], w[k]) for k in w if g[k] != w[k]}
    assert not bad, (what, bad)


def _dtype_name(dtype):
    return str(dtype).removeprefix("torch.")


def _assert_structs_equal(got, want, what):
    """Equal key strings, shapes and dtypes; every leaf ``meta``."""
    g = C.flat_torch(got)
    w = {jax.tree_util.keystr(p): s for p, s in
         jax.tree_util.tree_flatten_with_path(want)[0]}
    assert sorted(g) == sorted(w), (what, sorted(set(g) ^ set(w)))
    for k, s in w.items():
        assert g[k].device.type == "meta", (what, k)
        assert tuple(g[k].shape) == tuple(s.shape), (what, k)
        assert _dtype_name(g[k].dtype) == str(s.dtype), (what, k)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_specs_and_structs_match_the_reference(arch):
    jstr, tstr = _structs(arch)
    _assert_structs_equal(tstr, jstr, f"{arch} params ")
    _assert_structs_equal(TSP.param_structs(tget_config(arch), bf16=True),
                          JSP.param_structs(jget_config(arch), bf16=True),
                          f"{arch} bf16 params ")
    _assert_structs_equal(TSP.opt_structs(tstr), JSP.opt_structs(jstr),
                          f"{arch} opt ")
    for mesh in MESHES:
        for fsdp in (False, True):
            tspec = TSH.param_specs(tget_config(arch), tstr, mesh,
                                    fsdp=fsdp)
            jspec = JSH.param_specs(jget_config(arch), jstr, mesh,
                                    fsdp=fsdp)
            what = f"{arch} {mesh.axis_names} fsdp={fsdp} "
            _assert_specs_equal(tspec, jspec, what)
            _assert_specs_equal(TSH.opt_specs(tspec), JSH.opt_specs(jspec),
                                what + "opt ")


@pytest.mark.parametrize("arch", ARCH_NAMES)
@pytest.mark.parametrize("shape", CELLS)
def test_batch_and_cache_specs_match_the_reference(arch, shape):
    jcell, tcell = _cell(shape)
    jcfg, tcfg = jget_config(arch), tget_config(arch)
    _assert_structs_equal(TSP.input_specs(tcfg, tcell),
                          JSP.input_specs(jcfg, jcell), f"{arch} input ")
    for mesh in MESHES:
        _assert_specs_equal(TSH.batch_specs(tcfg, tcell, mesh),
                            JSH.batch_specs(jcfg, jcell, mesh),
                            f"{arch} {shape} {mesh.axis_names} batch ")
    if tcell.kind == "train":
        return                                   # no cache for train cells
    if shape == "long_500k" and not LONG_CONTEXT_OK[arch]:
        return                                   # documented skip
    tcache = TSP.cache_structs(tcfg, tcell)
    _assert_structs_equal(tcache, JSP.cache_structs(jcfg, jcell),
                          f"{arch} {shape} cache ")
    for mesh in MESHES:
        _assert_specs_equal(TSH.cache_specs(tcfg, tcell, mesh),
                            JSH.cache_specs(jcfg, jcell, mesh),
                            f"{arch} {shape} {mesh.axis_names} cache ")


def test_partition_spec_normalises_as_jax():
    J = jax.sharding.PartitionSpec
    for entries in [(("data",), None), ((), "model"), (("pod", "data"),),
                    (None, ("data", "model"), None), ()]:
        assert tuple(P(*entries)) == tuple(J(*entries)), entries
    assert P(("data",)) == ("data",) and P() == ()


def test_placements_and_production_mesh():
    """``placements``: Shard on every mesh dim naming a tensor dim, major
    to minor; an axis out of the mesh's order or used twice, or a spec
    longer than the tensor, is refused; a mesh dim of size 1 shards
    nothing (the one-rank gloo (1, 1) mesh).  ``make_production_mesh`` on
    a one-rank group names the ranks it needs."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = _FakeMesh({"data": 2, "model": 2})
    assert placements(P(("data", "model"), None), mesh) == \
        (Shard(0), Shard(0))
    assert placements(P(None, "model"), mesh) == (Replicate(), Shard(1))
    assert placements(P(), mesh, 3) == (Replicate(), Replicate())
    for bad in (P(("model", "data")), P("data", "data"), P("pod")):
        with pytest.raises(ValueError):
            placements(bad, mesh)
    with pytest.raises(ValueError):
        placements(P(None, None, None), mesh, 2)
    assert placements(P("data", "model"), _FakeMesh(
        {"data": 2, "model": 1})) == (Shard(0), Replicate())
    M.start_process_group("gloo")
    try:
        one = M.make_host_mesh(1, 1)
        assert placements(P(("data", "model"), None), one) == \
            (Replicate(), Replicate())
        with pytest.raises(RuntimeError, match="needs 256 ranks, found 1"):
            M.make_production_mesh()
        with pytest.raises(RuntimeError, match="needs 512 ranks, found 1"):
            M.make_production_mesh(multi_pod=True)
    finally:
        M.destroy_process_group()


def test_structs_allocate_nothing():
    """mixtral-8x7b at full width (187 GB of float32): every stand-in is a
    ``meta`` tensor (a shape and a dtype, no data)."""
    tstr = _structs("mixtral-8x7b")[1]
    leaves = list(C.flat_torch(tstr).values())
    assert sum(t.numel() for t in leaves) * 4 > 180e9
    assert all(type(t) is torch.Tensor and t.is_meta for t in leaves)
