"""The processes of ``test_torch_lm_mesh_ranks.py``: a gloo rank of the port
on a mesh, or the JAX package on four host devices.

    python torch_lm_mesh_workers.py torch <dir> <rank> <n_data>x<n_model>
    python torch_lm_mesh_workers.py jax <dir>

``<dir>`` holds the input the test wrote (``qwen3.pt`` and ``<variant>.pt``:
the reference's weights of the qwen3 variant and of each ``VARIANT_MESH``
form, carried into the port's tree; both sides draw the MoE weights and
inputs from numpy seeds) and receives the outputs: rank 0's
``torch_<mesh>.npz`` and ``torch_<mesh>.json``, and ``jax.npz``."""
import dataclasses
import json
import os
import sys

import numpy as np

MESHES = ((2, 2), (1, 4))
# tests/test_ep_moe.py's case: nothing drops at capacity_factor 8
EP_CASES = {"mixtral": ("mixtral-8x7b", dict(capacity_factor=8.0,
                                             n_shared=0)),
            "deepseek": ("deepseek-v2-lite-16b", {})}
X_SHAPE = (4, 8)                          # (B, S) of the MoE inputs
TRAIN_BATCH, TRAIN_SEQ = 4, 16            # tests/test_distributed.py's
OPT = dict(lr=1e-3, total_steps=5)        # its AdamW settings
# serve.generate's cache holds prompt + steps + 1 + 8 = 24 positions, which
# divide over 2 and 4 ranks: MLA's latent cache is split on its sequence
# dim over "model" (cache_specs), and every write lands in some rank's
# block of it
SERVE_BATCH, SERVE_PROMPT, SERVE_STEPS = 4, 11, 4
# the serving runs: the TP-MoE on the mesh, and the expert-parallel MoE
# where nothing drops (a rank's capacity sees its own tokens, so at the
# default capacity it drops others than the local run)
SERVE_CASES = {"tp": dict(moe_ep=False),
               "ep": dict(moe_ep=True, capacity_factor=8.0)}


def qwen3_variant(get_config):
    """tests/test_distributed.py's qwen3 variant, in float32."""
    return dataclasses.replace(
        get_config("qwen3-14b", smoke=True), n_heads=8, n_kv=4, pad_heads=8,
        d_model=128, head_dim=16, d_ff=256, dtype="float32")


# the smallest forms that showed each layout fault of the sharded train
# step, and the mesh that shows it (each a train step with FSDP and flash
# attention, as the dry-run's, against the reference's sharded step and
# the port's local one):
#   kv2: 2 kv heads on a model axis of 4 (``DTensor`` split the flash
#        step's k/v gradient's flat heads x head_dim over it, and the
#        projections' unflatten raised; head_dim 128 makes it choose so);
#   ssm6: 6 SSM heads (d_inner 96) on a model axis of 4 (the x heads'
#        reshape raised);
#   fsdp0: a conv weight (8 units, 4, 2048) that the FSDP rule splits on
#        its stacking dim over "data" (the units' unbind raised);
#   whisper: whisper-small's small form at d_model 256 and 256 decoder
#        positions, whose FSDP split of d_model (the tied embedding and
#        the positions) laid the decoder's stream out split on its
#        sequence and d_model, and an attention output's gradient split
#        on (batch, sequence), which torch 2.11's ``DTensor`` cannot
#        flatten.
VARIANT_MESH = {"kv2": (1, 4), "ssm6": (1, 4), "fsdp0": (2, 2),
                "whisper": (2, 2)}


def variant(get_config, name):
    if name == "whisper":
        return dataclasses.replace(
            get_config("whisper-small", smoke=True), dtype="float32",
            d_model=256, head_dim=64, max_dec_len=256)
    if name == "kv2":
        return dataclasses.replace(qwen3_variant(get_config), n_kv=2,
                                   head_dim=128)
    mamba = dataclasses.replace(get_config("mamba2-2.7b", smoke=True),
                                dtype="float32")
    if name == "ssm6":
        return dataclasses.replace(mamba, d_model=48)
    return dataclasses.replace(mamba, n_layers=8, ssm_expand=32)


def moe_config(get_config, name):
    arch, changes = EP_CASES[name]
    return dataclasses.replace(get_config(arch, smoke=True),
                               dtype="float32", **changes)


def moe_inputs(cfg, name):
    """Numpy MoE weights (the reference's tree) and input of a case."""
    rng = np.random.default_rng(list(EP_CASES).index(name))
    d, E, f = cfg.d_model, cfg.n_experts, cfg.expert_dff

    def w(*shape):
        return (0.02 * rng.standard_normal(shape)).astype(np.float32)
    p = {"w_gate_router": w(d, E), "w1": w(E, d, f), "w2": w(E, d, f),
         "w3": w(E, f, d)}
    if cfg.n_shared:
        p["shared"] = {"w_gate": w(d, cfg.n_shared * f),
                       "w_up": w(d, cfg.n_shared * f),
                       "w_down": w(cfg.n_shared * f, d)}
    x = rng.standard_normal(X_SHAPE + (d,)).astype(np.float32)
    return p, x


def batch_arrays(vocab):
    rng = np.random.default_rng(0)
    return {"tokens": rng.integers(0, vocab, (TRAIN_BATCH, TRAIN_SEQ)),
            "labels": rng.integers(0, vocab, (TRAIN_BATCH, TRAIN_SEQ))}


def variant_batch(cfg):
    """A variant's train batch: ``batch_arrays``, or whisper's frames and
    decoder tokens."""
    if not cfg.encdec:
        return batch_arrays(cfg.vocab)
    rng = np.random.default_rng(0)
    return {"frames": rng.standard_normal((TRAIN_BATCH, 24, cfg.d_model))
            .astype(np.float32),
            "tokens": rng.integers(0, cfg.vocab, (TRAIN_BATCH, 8)),
            "labels": rng.integers(0, cfg.vocab, (TRAIN_BATCH, 8))}


def flat(tree, keystr, leaves_with_path):
    return {keystr(p): np.asarray(v) for p, v in leaves_with_path(tree)}


# --------------------------------------------------------------------------
# the JAX package on four host devices
# --------------------------------------------------------------------------

def jax_main(out_dir):
    from repro.launch import env
    env.apply(4)
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as JP
    from repro.compat import make_mesh
    from repro.configs import get_config
    from repro.launch import shardings as JSH
    from repro.models import layers as JL
    from repro.models.common import ShapeCell
    from repro.optim import AdamWConfig
    from repro.parallel.act_sharding import activation_sharding
    from repro.parallel.ep_moe import moe_forward_ep
    from repro.train import init_train_state, make_train_step

    def keyed(tree):
        return flat(tree, jax.tree_util.keystr,
                    lambda t: jax.tree_util.tree_flatten_with_path(t)[0])

    out = {}
    cfgs = {n: moe_config(get_config, n) for n in EP_CASES}
    inputs = {n: moe_inputs(cfgs[n], n) for n in EP_CASES}
    for n, (p, x) in inputs.items():
        out[f"{n}/tp_local"] = np.asarray(jax.jit(
            lambda p_, x_: JL.moe_forward(p_, x_, cfgs[n]))(p, x))
    cfg = qwen3_variant(get_config)
    opt_cfg = AdamWConfig(**OPT)
    batch = {k: jnp.asarray(v) for k, v in batch_arrays(cfg.vocab).items()}
    cell = ShapeCell("t", TRAIN_SEQ, TRAIN_BATCH, "train")
    params0, opt0 = jax.jit(lambda k: init_train_state(cfg, k))(
        jax.random.PRNGKey(0))
    p_loc, _, m_loc = jax.jit(make_train_step(cfg, opt_cfg))(
        params0, opt0, batch)
    out["train/local/loss"] = np.asarray(m_loc["loss"])
    out.update({f"train/local/params{k}": v
                for k, v in keyed(p_loc).items()})
    for name, shape in VARIANT_MESH.items():
        vcfg = variant(get_config, name)
        p0, o0 = jax.jit(lambda k: init_train_state(vcfg, k))(
            jax.random.PRNGKey(0))
        mesh = make_mesh(shape, ("data", "model"))
        pspec = JSH.named(mesh, JSH.param_specs(vcfg, p0, mesh, fsdp=True))
        ospec = {"mu": pspec, "nu": pspec, "step": JSH.named(mesh, JP())}
        bspec = JSH.named(mesh, JSH.batch_specs(vcfg, cell, mesh))
        vbatch = {k: jnp.asarray(v) for k, v in variant_batch(vcfg).items()}
        step = jax.jit(make_train_step(vcfg, opt_cfg, use_flash=True),
                       in_shardings=(pspec, ospec, bspec),
                       out_shardings=(pspec, ospec, None))
        with activation_sharding(mesh):
            p1, o1, m1 = step(p0, o0, vbatch)
        out[f"variant/{name}/loss"] = np.asarray(m1["loss"])
        out.update({f"variant/{name}/params{k}": v
                    for k, v in keyed(p1).items()})
        out.update({f"variant/{name}/mu{k}": v
                    for k, v in keyed(o1["mu"]).items()})
    for shape in MESHES:
        tag = "x".join(map(str, shape))
        mesh = make_mesh(shape, ("data", "model"))
        for n, (p, x) in inputs.items():
            out[f"{n}/ep/{tag}"] = np.asarray(jax.jit(
                lambda p_, x_: moe_forward_ep(p_, x_, cfgs[n], mesh))(p, x))
        for fsdp in (False, True):
            pspec = JSH.named(mesh, JSH.param_specs(cfg, params0, mesh,
                                                    fsdp=fsdp))
            ospec = {"mu": pspec, "nu": pspec,
                     "step": JSH.named(mesh, JP())}
            bspec = JSH.named(mesh, JSH.batch_specs(cfg, cell, mesh))
            step = jax.jit(make_train_step(cfg, opt_cfg),
                           in_shardings=(pspec, ospec, bspec),
                           out_shardings=(pspec, ospec, None))
            with activation_sharding(mesh):
                p1, o1, m1 = step(params0, opt0, batch)
            key = f"train/{tag}/fsdp{int(fsdp)}"
            out[f"{key}/loss"] = np.asarray(m1["loss"])
            out.update({f"{key}/params{k}": v
                        for k, v in keyed(p1).items()})
            out.update({f"{key}/mu{k}": v
                        for k, v in keyed(o1["mu"]).items()})
    np.savez(os.path.join(out_dir, "jax.npz"), **out)


# --------------------------------------------------------------------------
# a rank of the port
# --------------------------------------------------------------------------

def torch_main(out_dir, rank, shape):
    import torch
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.utils import _pytree
    from repro_torch.conv import stage_trace
    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as M
    from repro_torch.launch import serve
    from repro_torch.launch import shardings as SH
    from repro_torch.models import layers as L
    from repro_torch.models import lm as LM
    from repro_torch.models.common import ShapeCell
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.parallel.act_sharding import P, activation_sharding
    from repro_torch.parallel.ep_moe import moe_forward_ep
    from repro_torch.train import make_train_step

    torch.set_num_threads(1)
    tag = "x".join(map(str, shape))
    world = shape[0] * shape[1]
    M.start_process_group("gloo", rank=rank, world_size=world,
                          store_path=os.path.join(out_dir, f"store{tag}"))
    mesh = M.make_host_mesh(*shape)
    out, facts = {}, {}

    def whole(t):
        return t.full_tensor() if hasattr(t, "full_tensor") else t

    def keyed(tree):
        return flat(whole_tree(tree), _pytree.keystr,
                    lambda t: _pytree.tree_flatten_with_path(t)[0])

    def whole_tree(tree):
        return _pytree.tree_map(lambda t: whole(t).detach().numpy(), tree)

    # ---- the expert-parallel MoE --------------------------------------
    for n in EP_CASES:
        cfg = moe_config(get_config, n)
        p, x = moe_inputs(cfg, n)
        p = _pytree.tree_map(torch.from_numpy, p)
        x = torch.from_numpy(x)
        expert = {"w_gate_router": P(), "w1": P("model"), "w2": P("model"),
                  "w3": P("model"),
                  "shared": {"w_gate": P(None, "model"),
                             "w_up": P(None, "model"),
                             "w_down": P("model", None)}}
        specs = {k: expert[k] for k in p}
        with stage_trace() as trace, CommDebugMode() as comm, \
                activation_sharding(mesh):
            y = moe_forward_ep(SH.place(mesh, specs, p), x, cfg, mesh)
        out[f"{n}/ep"] = whole(y).numpy()
        facts[n] = {
            "recorded": trace[("collective", "all_to_all")],
            "comm": {str(k).split(".")[1]: c for k, c in
                     comm.get_comm_counts().items() if c}}
        if n != "mixtral":
            continue
        # the EP gradient against the port's local moe_forward's, under a
        # fixed cotangent
        cot = torch.sin(torch.arange(y.numel(), dtype=torch.float32)
                        ).reshape(y.shape)
        pg = SH.place(mesh, specs, p)
        xg = SH.place_tensor(x, mesh, P())
        for t in _pytree.tree_leaves(pg) + [xg]:
            t.requires_grad_(True)
        with activation_sharding(mesh):
            (whole(moe_forward_ep(pg, xg, cfg, mesh)) * cot).sum().backward()
        pl = _pytree.tree_map(lambda t: t.clone().requires_grad_(True), p)
        xl = x.clone().requires_grad_(True)
        (L.moe_forward(pl, xl, cfg) * cot).sum().backward()
        for k in p:
            out[f"{n}/grad/ep/{k}"] = whole(pg[k].grad).numpy()
            out[f"{n}/grad/local/{k}"] = pl[k].grad.numpy()
        out[f"{n}/grad/ep/x"] = whole(xg.grad).numpy()
        out[f"{n}/grad/local/x"] = xl.grad.numpy()

    # ---- the sharded train step ----------------------------------------
    cfg = qwen3_variant(get_config)
    params = torch.load(os.path.join(out_dir, "qwen3.pt"))
    batch = {k: torch.from_numpy(v)
             for k, v in batch_arrays(cfg.vocab).items()}
    step = make_train_step(cfg, AdamWConfig(**OPT))
    if rank == 0:
        p_loc, o_loc, m_loc = step(params, adamw_init(params), batch)
        out["train/local/loss"] = m_loc["loss"].numpy()
        out.update({f"train/local/params{k}": v
                    for k, v in keyed(p_loc).items()})
        out.update({f"train/local/mu{k}": v
                    for k, v in keyed(o_loc["mu"]).items()})
    cell = ShapeCell("t", TRAIN_SEQ, TRAIN_BATCH, "train")

    def sharded_step(key, cfg, params, batch, fsdp, use_flash=False):
        step = make_train_step(cfg, AdamWConfig(**OPT), use_flash=use_flash)
        pspecs = SH.param_specs(cfg, params, mesh, fsdp=fsdp)
        with CommDebugMode() as comm, activation_sharding(mesh):
            p1, o1, m1 = step(SH.place(mesh, pspecs, params),
                              SH.place(mesh, SH.opt_specs(pspecs),
                                       adamw_init(params)),
                              SH.place(mesh, SH.batch_specs(cfg, cell, mesh),
                                       batch))
        facts[key] = {
            "placed_as_specs": all(
                tuple(t.placements) == SH.placements(s, mesh, t.ndim)
                for t, s in zip(_pytree.tree_leaves(p1), _pytree.tree_leaves(
                    pspecs, is_leaf=lambda s: isinstance(s, P)))),
            "comm": {str(k).split(".")[1]: c for k, c in
                     comm.get_comm_counts().items() if c}}
        out[f"{key}/loss"] = whole(m1["loss"]).numpy()
        out.update({f"{key}/params{k}": v for k, v in keyed(p1).items()})
        out.update({f"{key}/mu{k}": v for k, v in keyed(o1["mu"]).items()})

    for fsdp in (False, True):
        sharded_step(f"train/fsdp{int(fsdp)}", cfg, params, batch, fsdp)

    # ---- the layout faults' smallest forms, each on its mesh -----------
    for name, vshape in VARIANT_MESH.items():
        if vshape != shape:
            continue
        vcfg = variant(get_config, name)
        vparams = torch.load(os.path.join(out_dir, f"{name}.pt"))
        vbatch = {k: torch.from_numpy(v)
                  for k, v in variant_batch(vcfg).items()}
        if rank == 0:
            p_loc, o_loc, m_loc = make_train_step(
                vcfg, AdamWConfig(**OPT), use_flash=True)(
                vparams, adamw_init(vparams), vbatch)
            out[f"variant/{name}/local/loss"] = m_loc["loss"].numpy()
            out.update({f"variant/{name}/local/params{k}": v
                        for k, v in keyed(p_loc).items()})
            out.update({f"variant/{name}/local/mu{k}": v
                        for k, v in keyed(o_loc["mu"]).items()})
        sharded_step(f"variant/{name}/mesh", vcfg, vparams, vbatch, True,
                     use_flash=True)

    # ---- sharded serving: the kv2 form, whose 2 kv heads do not divide a
    # model axis of 4, so its cache is split on its sequence and a decode
    # step merges the ranks' keys by their log-sum-exps ------------------
    rng = np.random.default_rng(3)
    cfg = variant(get_config, "kv2")
    params = LM.init_lm_params(cfg, torch.Generator().manual_seed(0))
    prompts = torch.tensor(rng.integers(1, cfg.vocab,
                                        (SERVE_BATCH, SERVE_PROMPT)))
    local = serve.generate(cfg, params, prompts, SERVE_STEPS + 1)
    placed = SH.place(mesh, SH.param_specs(cfg, params, mesh, fsdp=False),
                      params)
    with CommDebugMode() as comm:
        meshed = serve.generate(cfg, placed, prompts, SERVE_STEPS + 1,
                                mesh=mesh)
    k_spec = SH.cache_specs(cfg, ShapeCell(
        "serve", SERVE_PROMPT + SERVE_STEPS + 9, SERVE_BATCH, "decode"),
        mesh)["u0"]["k"]
    facts["serve/kv2"] = {
        "k_spec": list(k_spec),
        "comm": {str(k).split(".")[1]: c for k, c in
                 comm.get_comm_counts().items() if c},
        "tokens_equal": bool(torch.equal(local.tokens, meshed.tokens))}
    for i, (a, b) in enumerate(zip(meshed.steps, local.steps)):
        out[f"serve/kv2/mesh/{i}"] = a.numpy()
        out[f"serve/kv2/local/{i}"] = b.numpy()

    # ---- sharded serving: deepseek's prefill and greedy decode ---------
    for name, changes in SERVE_CASES.items():
        cfg = dataclasses.replace(get_config("deepseek-v2-lite-16b",
                                             smoke=True),
                                  dtype="float32", **changes)
        params = LM.init_lm_params(cfg, torch.Generator().manual_seed(0))
        prompts = torch.tensor(rng.integers(1, cfg.vocab,
                                            (SERVE_BATCH, SERVE_PROMPT)))
        local = serve.generate(cfg, params, prompts, SERVE_STEPS + 1)
        placed = SH.place(mesh, SH.param_specs(cfg, params, mesh,
                                               fsdp=False), params)
        with stage_trace() as trace:
            meshed = serve.generate(cfg, placed, prompts, SERVE_STEPS + 1,
                                    mesh=mesh)
        c_kv = SH.cache_specs(cfg, ShapeCell(
            "serve", SERVE_PROMPT + SERVE_STEPS + 9, SERVE_BATCH, "decode"),
            mesh)["u0"]["c_kv"]
        facts[f"serve/{name}"] = {
            "recorded": trace[("collective", "all_to_all")],
            "c_kv_spec": list(c_kv),
            "tokens_equal": bool(torch.equal(local.tokens, meshed.tokens))}
        for i, (a, b) in enumerate(zip(meshed.steps, local.steps)):
            out[f"serve/{name}/mesh/{i}"] = a.numpy()
            out[f"serve/{name}/local/{i}"] = b.numpy()

    if rank == 0:
        np.savez(os.path.join(out_dir, f"torch_{tag}.npz"), **out)
        with open(os.path.join(out_dir, f"torch_{tag}.json"), "w") as f:
            json.dump(facts, f)
    M.destroy_process_group()


if __name__ == "__main__":
    role, out_dir = sys.argv[1], sys.argv[2]
    if role == "jax":
        jax_main(out_dir)
    else:
        torch_main(out_dir, int(sys.argv[3]),
                   tuple(int(n) for n in sys.argv[4].split("x")))
