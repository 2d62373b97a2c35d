"""The LM substrate on a one-rank gloo (1, 1) mesh, in process:

- the repair of ``lm._block_forward``'s dispatch: ``moe_ep`` without a
  mesh computes ``moe_forward``, as the reference, where the port raised;
- ``activation_sharding``: ``current_mesh``, ``constrain``, nesting and
  thread-locality, and a unit's recompute in the backward;
- ``launch.shardings.place`` keeps one rank's tree without a copy;
- all ten small forms' train step and ``serve.generate`` on placed trees,
  equal to the same runs on plain tensors (``chip_smoke.lm_mesh_small``,
  phase 20's first half, on the host).

Multi-rank numerics are in ``test_torch_lm_mesh_ranks.py``."""
import dataclasses
import importlib.util
import pathlib
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.distributed.tensor import DTensor, Replicate

from repro.models import lm as JLM
from repro_torch.configs import ARCH_NAMES
from repro_torch.launch import mesh as M
from repro_torch.launch import shardings as SH
from repro_torch.models import lm as TLM
from repro_torch.parallel import act_sharding as A

import torch_lm_common as C

ROOT = pathlib.Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)


@pytest.fixture(scope="module")
def mesh():
    M.start_process_group("gloo")
    try:
        yield M.make_host_mesh(1, 1)
    finally:
        M.destroy_process_group()


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "deepseek-v2-lite-16b"])
def test_moe_ep_without_a_mesh_is_the_reference_forward(arch):
    """``moe_ep=True`` and no mesh: ``lm_forward`` takes ``moe_forward``
    and equals the reference's on its weights carried across."""
    jcfg, tcfg = C.configs(arch, moe_ep=True)
    jp = jax.jit(lambda k: JLM.init_lm_params(jcfg, k))(
        jax.random.PRNGKey(0))
    toks = np.random.default_rng(2).integers(0, jcfg.vocab, (2, 8))
    want = jax.jit(lambda p, t: JLM.lm_forward(p, jcfg, t, remat=False))(
        jp, jnp.asarray(toks, jnp.int32))
    got = TLM.lm_forward(C.carry(jp, tcfg), tcfg, torch.tensor(toks),
                         remat=False)
    C.assert_close(got, want, what=f"{arch} moe_ep forward")


def test_context_nests_per_thread_and_constrain_places(mesh):
    x = torch.randn(4, 3, 8)
    assert A.current_mesh() is None and A.constrain(x, "seq") is x
    with pytest.raises(ValueError):
        A.constrain(x, "tokens")
    fake = type("FakeMesh", (), {"shape": {"data": 16, "model": 16},
                                 "axis_names": ("data", "model")})()
    seen = {}
    with A.activation_sharding(mesh):
        assert A.current_mesh() is mesh
        assert A.constrain(x, "seq") is x            # plain stays plain
        d = DTensor.from_local(x, mesh, [Replicate(), Replicate()])
        assert isinstance(A.constrain(d, "logits"), DTensor)
        with A.activation_sharding(fake):
            assert A.current_mesh() is fake
            # the reference's specs and divisibility guards
            assert A._spec("logits", torch.zeros(32, 3, 64), fake,
                           ("data",), "model") == A.P("data", None, "model")
            assert A._spec("logits", x, fake, ("data",), "model") == \
                A.P(None, None, None)                # 4 rows, 8 columns
            assert A._spec("heads", torch.zeros(32, 1, 16, 2), fake,
                           ("data",), "model") == \
                A.P("data", None, "model", None)
            assert A._spec("seq", x, fake, ("data",), "model") == \
                A.P(None, None, None)
        assert A.current_mesh() is mesh
        t = threading.Thread(target=lambda: seen.update(m=A.current_mesh()))
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
        later = A.carried(A.current_mesh)
    assert seen == {"m": None} and A.current_mesh() is None
    assert later() is mesh                 # a recompute sees the context
    assert A.current_mesh() is None


def test_place_keeps_one_ranks_tree_without_a_copy(mesh):
    cfg = C.configs("deepseek-v2-lite-16b")[1]
    params = TLM.init_lm_params(cfg, torch.Generator().manual_seed(0))
    placed = SH.place(mesh, SH.param_specs(cfg, params, mesh, fsdp=True),
                      params)
    for (k, a), b in zip(C.flat_torch(placed).items(),
                         C.flat_torch(params).values()):
        assert isinstance(a, DTensor) and a.shape == b.shape, k
        assert a.to_local().data_ptr() == b.data_ptr(), k
    with pytest.raises(ValueError, match="spec tree"):
        SH.place(mesh, {"embed": A.P()}, params)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_small_form_on_placed_trees_equals_plain(mesh, arch):
    """One train step and a greedy generation on the mesh equal the plain
    runs: both on the host, the same ops on one rank."""
    r = smoke.lm_mesh_small(arch, mesh, device="cpu")
    assert max(r["train_vs_host"].values()) == 0.0
    assert max(r["serve_vs_host"]) == 0.0
    assert len(r["tokens"][0]) == smoke.LM_STEPS + 1


def test_remat_recompute_runs_in_the_forwards_context(mesh):
    """A unit recomputed in the backward takes the expert-parallel MoE
    again: its exchanges are recorded in the forward and again in the
    recompute."""
    from repro_torch.conv import stage_trace
    from repro_torch.train.step import loss_and_grads
    cfg = dataclasses.replace(C.configs("mixtral-8x7b")[1], moe_ep=True)
    params = TLM.init_lm_params(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    batch = {k: torch.tensor(rng.integers(0, cfg.vocab, (2, 8)))
             for k in ("tokens", "labels")}
    placed = SH.place(mesh, SH.param_specs(cfg, params, mesh, fsdp=False),
                      params)
    with stage_trace() as n, A.activation_sharding(mesh):
        loss, grads = loss_and_grads(placed, cfg, batch)
    layers = cfg.n_layers
    assert n[("collective", "all_to_all")] == 2 * layers * 2
    l0, g0 = loss_and_grads(params, cfg, batch)
    assert abs(float(loss.full_tensor()) - float(l0)) <= 1e-6 * float(l0)
    got, want = C.flat_torch(smoke.whole(grads)), C.flat_torch(g0)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        C.assert_close(got[k], w.numpy(), tol=1e-6, what=k)
