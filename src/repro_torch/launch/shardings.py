"""Sharding rules: param / optimizer / batch / cache ``PartitionSpec``s, and
``place``, which puts a tree of tensors on a mesh as ``DTensor``s.

TP ("model" axis) placement is rule-based on the parameter's leaf name, with
divisibility guards (a dim that doesn't divide the axis is replicated).
FSDP (ZeRO-3): optionally shard the largest remaining dim of every large
leaf over "data"; DTensor gathers it where an op needs it whole.  Train
steps use params+opt FSDP; serve steps shard params over "model" only.

Every spec function takes a ``DeviceMesh`` or a shape-only mesh (any
object with ``.shape``, a dict, and ``.axis_names``), so the rules can be
checked for a 256- or 512-rank mesh without a process group.
"""
from __future__ import annotations

from torch._prims_common import make_contiguous_strides_for
from torch.utils import _pytree

from repro_torch.models.common import ModelConfig, ShapeCell
from repro_torch.parallel.act_sharding import (P, PartitionSpec, axis_sizes,
                                               dp_axes, local_block,
                                               placements)

# leaf-name -> preferred model-sharded axis, counted from the END of shape
_MODEL_AXIS_RULES = {
    "embed": -2, "lm_head": -1,
    "wq": -2, "w_q": -2, "wo": -3,
    "w_uk": -2, "w_uv": -2, "w_dkv": -1,
    "w_gate": -1, "w_up": -1, "w_down": -2,
    "w1": -1, "w2": -1, "w3": -2,
    "w_z": -1, "w_x": -1, "w_out": -2, "w_dt": -1,
    "conv_x": -1, "out_norm": -1,
}
_REPLICATED = {"w_kr", "w_gate_router", "w_B", "w_C", "conv_B", "conv_C",
               "A_log", "D", "dt_bias", "gamma", "beta", "q_norm", "k_norm",
               "meta_tokens", "dec_posemb", "attn_norm", "mamba_norm",
               "step"}
_FSDP_MIN_SIZE = 1 << 16


def _leaf_name(path):
    last = path[-1]
    return str(getattr(last, "key", getattr(last, "idx", last)))


def _leaf_spec(name, shape, cfg: ModelConfig, n_model: int, n_data: int,
               model_axis: str, fsdp: bool):
    ndim = len(shape)
    axes = [None] * ndim
    if name in ("wk", "wv"):
        # GQA: shard kv heads only when they divide the axis. NEVER shard
        # head_dim — that would turn every score einsum into a psum.
        if shape[-2] % n_model == 0:
            axes[-2] = model_axis
    elif name in ("wq", "w_q", "wo", "w_uk", "w_uv"):
        # head-TP only when the (padded) head count divides the axis
        ax = _MODEL_AXIS_RULES[name]
        if shape[ax] % n_model == 0:
            axes[ax] = model_axis
    elif name in _MODEL_AXIS_RULES and name not in _REPLICATED:
        ax = _MODEL_AXIS_RULES[name]
        if ndim >= -ax and shape[ax] % n_model == 0:
            axes[ax] = model_axis
    if fsdp:
        size = 1
        for s in shape:
            size *= s
        if size >= _FSDP_MIN_SIZE:
            # largest unassigned dim divisible by the data axis
            cands = [(shape[i], i) for i in range(ndim)
                     if axes[i] is None and shape[i] % n_data == 0]
            if cands:
                _, i = max(cands)
                axes[i] = "data"
    return P(*axes)


def _is_spec(x):
    return isinstance(x, PartitionSpec)


def param_specs(cfg: ModelConfig, params_struct, mesh, *, fsdp: bool):
    """A spec a leaf of ``params_struct`` (tensors, meta or fake tensors:
    only the shapes are read), by the leaf's name."""
    sizes = axis_sizes(mesh)
    n_model = sizes["model"]
    n_data = sizes["data"]

    def spec_of(path, leaf):
        name = _leaf_name(path)
        if name in _REPLICATED:
            return P()
        return _leaf_spec(name, tuple(leaf.shape), cfg, n_model, n_data,
                          "model", fsdp)

    return _pytree.tree_map_with_path(spec_of, params_struct)


def opt_specs(pspecs):
    """Optimizer state mirrors the parameter sharding (mu/nu)."""
    return {"mu": pspecs, "nu": pspecs, "step": P()}


def batch_specs(cfg: ModelConfig, cell: ShapeCell, mesh):
    dp = dp_axes(mesh)
    dp = dp if cell.global_batch % _axes_size(mesh, dp) == 0 else ()
    dp_spec = dp if dp else None
    if cell.kind == "train":
        if cfg.encdec:
            return {"frames": P(dp_spec, None, None),
                    "tokens": P(dp_spec, None), "labels": P(dp_spec, None)}
        out = {"tokens": P(dp_spec, None), "labels": P(dp_spec, None)}
        if cfg.frontend == "vision_stub":
            out["img_embeds"] = P(dp_spec, None, None)
        return out
    if cell.kind == "prefill":
        if cfg.encdec:
            return {"frames": P(dp_spec, None, None),
                    "tokens": P(dp_spec, None)}
        out = {"tokens": P(dp_spec, None)}
        if cfg.frontend == "vision_stub":
            out["img_embeds"] = P(dp_spec, None, None)
        return out
    return {"tokens": P(dp_spec, None)}          # decode


def _axes_size(mesh, axes):
    sizes = axis_sizes(mesh)
    n = 1
    for a in axes:
        n *= sizes[a]
    return n


def cache_specs(cfg: ModelConfig, cell: ShapeCell, mesh):
    """PartitionSpecs matching the init_cache / init_dec_cache tree.
    Per-unit-position entries can have different sequence extents (ring
    caches), so divisibility checks use each entry's own length."""
    n_model = axis_sizes(mesh)["model"]
    dp = dp_axes(mesh)
    b_ok = cell.global_batch % _axes_size(mesh, dp) == 0
    b_spec = dp if b_ok else None

    def _seq_spec(seq_len):
        # long-context (tiny batch): shard the seq dim over the DP domain
        return dp if (not b_ok and seq_len % _axes_size(mesh, dp) == 0) \
            else None

    def attn_kv(lead, seq_len):
        # kv heads on "model" when they divide; otherwise put "model" on the
        # sequence dim (flash-decoding-style KV sequence sharding). Never on
        # head_dim (that would psum every score einsum).
        seq_spec = _seq_spec(seq_len)
        if cfg.padded_kv % n_model == 0:
            h_ax, s_ax = "model", seq_spec
        else:
            h_ax = None
            s_ax = (seq_spec + ("model",) if seq_spec
                    else "model") if seq_len % n_model == 0 else seq_spec
        return P(*lead, b_spec, h_ax, s_ax, None)

    def kind_specs(kind, lead, seq_len):
        seq_spec = _seq_spec(seq_len)
        c = {}
        if kind in ("G", "L", "H"):
            if cfg.mla:
                # the sequence dim, not the latent, on "model" (flash-
                # decoding style): latent-sharded c_kv would make every
                # score einsum a reduction over ranks
                if seq_len % n_model == 0:
                    s_ax = (seq_spec + ("model",)) if seq_spec else "model"
                    c["c_kv"] = P(*lead, b_spec, s_ax, None)
                    c["k_rope"] = P(*lead, b_spec, s_ax, None)
                else:
                    l_ax = "model" if cfg.kv_lora % n_model == 0 else None
                    c["c_kv"] = P(*lead, b_spec, seq_spec, l_ax)
                    c["k_rope"] = P(*lead, b_spec, seq_spec, None)
            else:
                c["k"] = attn_kv(lead, seq_len)
                c["v"] = attn_kv(lead, seq_len)
        if kind in ("M", "H"):
            if cfg.ssm_heads % n_model == 0:
                h_ax, p_ax = "model", None
            elif cfg.ssm_head_dim % n_model == 0:
                h_ax, p_ax = None, "model"
            else:
                h_ax = p_ax = None
            c["ssm"] = P(*lead, b_spec, h_ax, p_ax, None)
            di_ax = "model" if cfg.d_inner % n_model == 0 else None
            c["conv_x"] = P(*lead, b_spec, None, di_ax)
            c["conv_B"] = P(*lead, b_spec, None, None)
            c["conv_C"] = P(*lead, b_spec, None, None)
        return c

    if cfg.encdec:
        enc_seq = _seq_spec(cell.seq_len)
        if cfg.padded_kv % n_model == 0:      # head-padded MHA: head-TP
            kv = P(None, b_spec, "model", None, None)
            return {"k": kv, "v": kv,
                    "xk": P(None, b_spec, "model", enc_seq, None),
                    "xv": P(None, b_spec, "model", enc_seq, None)}
        self_s = "model" if cfg.max_dec_len % n_model == 0 else None
        if cell.seq_len % n_model == 0:
            x_s = (enc_seq + ("model",)) if enc_seq else "model"
        else:
            x_s = enc_seq
        kv = P(None, b_spec, None, self_s, None)
        return {"k": kv, "v": kv,
                "xk": P(None, b_spec, None, x_s, None),
                "xv": P(None, b_spec, None, x_s, None)}

    unit = cfg.layer_pattern
    locs = cfg.local_flags()[cfg.first_dense:]
    n_units = (cfg.n_layers - cfg.first_dense) // len(unit)
    uniform = all(locs[u * len(unit) + j] == locs[j]
                  for u in range(n_units) for j in range(len(unit)))
    base_len = cell.seq_len + (cfg.n_meta_tokens
                               if cell.kind == "prefill" else 0)
    out = {}
    for j, kind in enumerate(unit):
        ring = (cfg.ring_local_cache and uniform and locs[j]
                and cfg.window > 0)
        len_j = min(base_len, cfg.window) if ring else base_len
        out[f"u{j}"] = kind_specs(kind, (None,), len_j)
    kinds = cfg.layer_kinds()
    for i in range(cfg.first_dense):
        out[f"dense_{i}"] = kind_specs(kinds[i], (), base_len)
    return out


# --------------------------------------------------------------------------
# placing trees on a mesh
# --------------------------------------------------------------------------

def place_tensor(t, mesh, spec):
    """``t`` (whole, on this rank) as a ``DTensor`` laid out as ``spec``,
    built from this rank's block with ``DTensor.from_local``: no
    collective, and no copy where the block is ``t`` itself."""
    from torch.distributed.tensor import DTensor
    places = placements(spec, mesh, t.ndim)
    return DTensor.from_local(local_block(t, mesh, places), mesh, places,
                              run_check=False, shape=t.shape,
                              stride=make_contiguous_strides_for(t.shape))


def place(mesh, spec_tree, tree):
    """``tree``'s tensors as ``DTensor``s on ``mesh`` (a ``DeviceMesh``),
    each laid out as its spec in ``spec_tree`` (the same structure, a
    ``PartitionSpec`` a leaf).  Every rank passes the whole tree; each
    keeps its own block."""
    specs, spec_def = _pytree.tree_flatten(spec_tree, is_leaf=_is_spec)
    leaves, tree_def = _pytree.tree_flatten(tree)
    if spec_def != tree_def:
        raise ValueError(f"place: the spec tree {spec_def} is not the "
                         f"tensor tree {tree_def}")
    return _pytree.tree_unflatten(
        [place_tensor(t, mesh, s) for t, s in zip(leaves, specs)], tree_def)

