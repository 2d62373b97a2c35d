"""The LM substrate on spawned gloo ranks at meshes (2, 2) and (1, 4),
against the JAX package on four host devices (``torch_lm_mesh_workers``:
one spawn of four ranks a mesh shape, all checks of that shape in it, and
one JAX process; all at once):

- the expert-parallel MoE (``parallel.ep_moe``): mixtral's small form at
  capacity_factor 8 without shared experts (``tests/test_ep_moe.py``'s
  case) against the reference's ``moe_forward`` and its
  ``moe_forward_ep`` on the same mesh, with exactly 2 all-to-alls and no
  other collective; deepseek's at its default capacity, where tokens
  drop, with a shared expert, against the reference's EP; the EP
  gradient against the port's local ``moe_forward``'s;
- the sharded train step (``tests/test_distributed.py``'s qwen3 variant),
  FSDP off and on, on the reference's weights carried across: against
  the port's local step and the reference's sharded step;
- sharded serving: deepseek's prefill and greedy decode steps, the
  TP-MoE and the EP MoE (where nothing drops), against the local run;
- the layout faults that the dry-run found at full width, each at the
  smallest form and mesh that showed it (``W.VARIANT_MESH``): a train step
  with FSDP against the reference's sharded step and the port's local one;
- the dry-run's collective counts of the sharded train step on a fake
  (2, 2) mesh against what ``CommDebugMode`` saw on the gloo ranks."""
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.train import init_train_state
from repro_torch.configs import get_config as tget_config
from repro_torch.optim import AdamWConfig, cosine_lr

import torch_lm_common as C
import torch_lm_mesh_workers as W

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
MESH_TAGS = ["x".join(map(str, m)) for m in W.MESHES]
EP_TOL = 1e-4            # tests/test_ep_moe.py's
GRAD_TOL = 1e-5
LOCAL_TOL = 1e-5         # the sharded step against the port's local one
JAX_TOL = 1e-4           # ... and against the reference's sharded step


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("lm_mesh")
    jcfg = W.qwen3_variant(jget_config)
    params, _ = jax.jit(lambda k: init_train_state(jcfg, k))(
        jax.random.PRNGKey(0))
    torch.save(C.carry(params, W.qwen3_variant(tget_config)),
               tmp / "qwen3.pt")
    for name in W.VARIANT_MESH:
        jcfg = W.variant(jget_config, name)
        params, _ = jax.jit(lambda k: init_train_state(jcfg, k))(
            jax.random.PRNGKey(0))
        torch.save(C.carry(params, W.variant(tget_config, name)),
                   tmp / f"{name}.pt")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src"), HERE]), OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    script = os.path.join(HERE, "torch_lm_mesh_workers.py")
    procs = [subprocess.Popen([sys.executable, script, "jax", str(tmp)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)]
    for tag in MESH_TAGS:
        for rank in range(4):
            procs.append(subprocess.Popen(
                [sys.executable, script, "torch", str(tmp), str(rank), tag],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    failed = [log[-3000:] for p, log in zip(procs, logs) if p.returncode]
    assert not failed, "\n\n".join(failed)
    ours = {}
    for tag in MESH_TAGS:
        with np.load(tmp / f"torch_{tag}.npz") as z:
            ours[tag] = dict(z)
        ours[tag]["facts"] = json.loads((tmp / f"torch_{tag}.json")
                                        .read_text())
    with np.load(tmp / "jax.npz") as z:
        theirs = dict(z)
    return ours, theirs


def _tree(d, prefix):
    return {k[len(prefix):]: v for k, v in d.items() if k.startswith(prefix)}


@pytest.mark.parametrize("tag", MESH_TAGS)
def test_ep_moe_matches_the_reference_and_exchanges_twice(spawned, tag):
    ours, theirs = spawned
    o = ours[tag]
    C.assert_close(o["mixtral/ep"], theirs["mixtral/tp_local"], EP_TOL,
                   "mixtral EP vs the reference's moe_forward")
    C.assert_close(o["mixtral/ep"], theirs[f"mixtral/ep/{tag}"], EP_TOL,
                   "mixtral EP vs the reference's EP")
    # deepseek at the default capacity drops tokens: the reference's EP on
    # the same mesh drops the same ones
    C.assert_close(o["deepseek/ep"], theirs[f"deepseek/ep/{tag}"], EP_TOL,
                   "deepseek EP vs the reference's EP")
    # two exchanges, and nothing else: the hot stage is local.  deepseek's
    # shared expert runs as dense TP beside them, its d_ff sharded: its
    # partial sums are reduced into the output's sequence shards
    assert o["facts"]["mixtral"] == {"recorded": 2,
                                     "comm": {"alltoall_base_": 2}}
    facts = o["facts"]["deepseek"]
    assert facts["recorded"] == 2 and facts["comm"] == {
        "alltoall_base_": 2, "reduce_scatter_tensor": 1}, facts


@pytest.mark.parametrize("tag", MESH_TAGS)
def test_ep_moe_gradient_matches_the_local_moe(spawned, tag):
    o = spawned[0][tag]
    for k in ("x", "w_gate_router", "w1", "w2", "w3"):
        C.assert_close(o[f"mixtral/grad/ep/{k}"],
                       o[f"mixtral/grad/local/{k}"], GRAD_TOL,
                       f"EP grad of {k}")


@pytest.mark.parametrize("fsdp", [0, 1])
@pytest.mark.parametrize("tag", MESH_TAGS)
def test_sharded_train_step_matches_local_and_reference(spawned, tag, fsdp):
    ours, theirs = spawned
    key = f"train/fsdp{fsdp}"
    _check_step(ours[tag], key, "train/local", theirs,
                f"train/{tag}/{key[6:]}")


@pytest.mark.parametrize("name", list(W.VARIANT_MESH))
def test_layout_fault_forms_step_as_the_reference(spawned, name):
    """kv2, ssm6 and fsdp0 (``W.VARIANT_MESH``) raised in the port's
    sharded step before its repairs (``act_sharding.split_heads``/
    ``merge_heads``, ``lm._unstack``); whisper, the embedding lookup
    (``act_sharding.take_rows``), the tied logits (``grad_placed``) and
    the flatten of two split dims (``constrain``) under torch 2.11."""
    ours, theirs = spawned
    tag = "x".join(map(str, W.VARIANT_MESH[name]))
    _check_step(ours[tag], f"variant/{name}/mesh", f"variant/{name}/local",
                theirs, f"variant/{name}")


def _check_step(o, key, local_key, theirs, ref_key):
    """The sharded step ``key`` of the port's rank 0 outputs ``o`` against
    its local step ``local_key`` and the reference's ``ref_key``: loss,
    mu (the grads) and the new parameters."""
    assert o["facts"][key]["placed_as_specs"]
    C.assert_close(o[f"{key}/loss"], o[f"{local_key}/loss"], LOCAL_TOL,
                   "loss vs the local step")
    C.assert_close(o[f"{key}/loss"], theirs[f"{ref_key}/loss"],
                   JAX_TOL, "loss vs the reference's sharded step")
    local = {n: _tree(o, f"{local_key}/{n}") for n in ("mu", "params")}
    ref = {n: _tree(theirs, f"{ref_key}/{n}") for n in ("mu", "params")}
    got = {n: _tree(o, f"{key}/{n}") for n in ("mu", "params")}
    for n in ("mu", "params"):
        assert sorted(got[n]) == sorted(local[n]) == sorted(ref[n])
    for k in got["mu"]:
        # the grads: mu is (1 - b1) g after one step
        C.assert_close(got["mu"][k], local["mu"][k], LOCAL_TOL,
                       f"mu{k} vs local")
        C.assert_close(got["mu"][k], ref["mu"][k], JAX_TOL,
                       f"mu{k} vs reference")
        # the new parameters, less the part of the move that the two runs'
        # grads decide apart (``_moved_apart``)
        for other, tol, what in ((local, LOCAL_TOL, "local"),
                                 (ref, JAX_TOL, "reference")):
            C.assert_close(got["params"][k] - _moved_apart(
                got["mu"][k], other["mu"][k]), other["params"][k], tol,
                f"params{k} vs {what}")


def _moved_apart(mu, mu_other):
    """How much further the first AdamW step moves a parameter with first
    moment ``mu`` than with ``mu_other``.  Step 1 moves each element by
    -lr (g / (|g| + eps) + wd p) with g = mu / (1 - b1), about lr times
    the sign of g: where a grad is near 0, the float noise of two sums in
    other orders (the ranks') moves it another way, by up to 2 lr, which a
    leaf of small parameters (the norms' gammas start at 0) reads as a
    large part of itself.  That part is the optimizer's, not the step's:
    it is taken out, in float64, before the parameters are compared."""
    cfg = AdamWConfig(**W.OPT)
    lr = float(cosine_lr(cfg, torch.tensor(1)))

    def move(m):
        g = m.astype(np.float64) / (1 - cfg.b1)
        return -lr * g / (np.abs(g) + cfg.eps)
    return (move(mu) - move(mu_other)).astype(np.float32)


@pytest.mark.parametrize("case", list(W.SERVE_CASES))
@pytest.mark.parametrize("tag", MESH_TAGS)
def test_sharded_serving_matches_local(spawned, tag, case):
    o = spawned[0][tag]
    facts = o["facts"][f"serve/{case}"]
    assert facts["tokens_equal"]
    assert facts["c_kv_spec"] == [None, "data", "model", None]
    moe_layers = 2                         # deepseek's small form
    assert facts["recorded"] == (2 * moe_layers * (W.SERVE_STEPS + 1)
                                 if case == "ep" else 0)
    for i in range(W.SERVE_STEPS + 1):
        C.assert_close(o[f"serve/{case}/mesh/{i}"],
                       o[f"serve/{case}/local/{i}"], C.TOL,
                       f"serve {case} step {i}")


@pytest.mark.parametrize("device_type", ["cpu", "cuda"])
def test_dryrun_counts_what_the_gloo_ranks_ran(spawned, device_type):
    """The train step of the qwen3 variant with FSDP, dry-run on a fake
    (2, 2) mesh of ``device_type``: on a ``cpu`` mesh its collectives are
    the ones ``CommDebugMode`` saw on the four gloo ranks, op for op; on a
    ``cuda`` mesh, where ``DTensor`` plans what NCCL runs, each all-gather
    that a ``cpu`` mesh runs with a chunk in place of an all-to-all is
    that all-to-all."""
    from repro_torch.launch import dryrun
    from repro_torch.models.common import ShapeCell
    seen = spawned[0]["2x2"]["facts"]["train/fsdp1"]["comm"]
    rec = dryrun.dry_run(W.qwen3_variant(tget_config),
                         ShapeCell("t", W.TRAIN_SEQ, W.TRAIN_BATCH, "train"),
                         mesh_shape=(2, 2), device_type=device_type,
                         use_flash=False, grad_bf16=False)
    ops = {k.split(".")[1]: n for k, n in rec["collective_ops"].items()}
    assert sum(rec["collectives"]["counts"].values()) == sum(ops.values())
    if device_type == "cpu":
        assert ops == seen
        return
    a2a = ops.pop("shard_dim_alltoall")
    assert a2a > 0 and rec["collectives"]["counts"]["all-to-all"] == a2a
    ops["all_gather_into_tensor"] += a2a
    assert ops == seen


@pytest.mark.parametrize("tag", MESH_TAGS)
def test_sharded_serving_merges_split_keys(spawned, tag):
    """The kv2 form served on the mesh against the local run: at (1, 4)
    its 2 kv heads do not divide the model axis, so the cache is split on
    its sequence (``cache_specs``) and each decode step's attention runs
    on the ranks' keys and merges them by their log-sum-exps
    (``act_sharding.on_head_blocks``); at (2, 2) the heads split."""
    o = spawned[0][tag]
    facts = o["facts"]["serve/kv2"]
    assert facts["tokens_equal"]
    split_seq = tag == "1x4"
    assert facts["k_spec"] == [None, "data", None if split_seq else "model",
                               "model" if split_seq else None, None]
    for i in range(W.SERVE_STEPS + 1):
        C.assert_close(o[f"serve/kv2/mesh/{i}"], o[f"serve/kv2/local/{i}"],
                       C.TOL, f"serve kv2 step {i}")
