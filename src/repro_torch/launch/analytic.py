"""Analytic FLOP / HBM-byte model per (arch x shape) cell (the twin of
``repro.launch.analytic``, arithmetic for arithmetic).

Why analytic: the dry-run traces each step on ``meta`` tensors, which run
no arithmetic and move no byte, so the step's executed work is counted
from the configuration, as the reference counts it:

  * matmul FLOPs 2*m*n*k over every projection (from the config),
  * attention score+AV FLOPs with the blocks actually visited by the flash
    schedule (non-banded causal visits all blocks => the 2x causal
    overcompute is charged; banded local layers charge only the window),
  * MoE expert FLOPs include the capacity-padding waste (x capacity_factor),
  * training charges fwd + 2x bwd + 1x remat recompute = 4x forward,
  * HBM bytes: parameter traffic (incl. optimizer reads/writes), boundary
    activations under nothing_saveable remat, KV-cache read volume (the
    dominant decode term), and logits.

All numbers are GLOBAL (whole step across all ranks); roofline terms divide
by (ranks x per-rank rate).  ``N_MODEL`` is the model-axis width of the
production mesh (``launch.mesh.make_production_mesh``), whatever mesh a
step is traced on.
"""
from __future__ import annotations

from repro_torch.models.common import ModelConfig, ShapeCell

N_MODEL = 16      # model-axis width of the production mesh


def _attn_repl(cfg: ModelConfig) -> float:
    """Executed-work multiplier for attention: head padding when the padded
    count divides the model axis, else full replication over it."""
    Hp = cfg.padded_heads
    if Hp % N_MODEL == 0:
        return Hp / cfg.n_heads
    return float(N_MODEL)


def _attn_visited(cfg: ModelConfig, S: int, *, q_block=512, kv_block=512):
    """Per layer: average kv positions visited per query under the flash
    schedule, for (local, global) layers."""
    nk = max(S // kv_block, 1)
    full = nk * kv_block
    if cfg.window:
        wb = -(-(cfg.window + min(q_block, S)) // kv_block)
        local = min(nk, wb + 1) * kv_block
    else:
        local = full
    return local, full


def _layer_matmul_params(cfg: ModelConfig, kind: str, moe: bool) -> float:
    d = cfg.d_model
    p = 0.0
    if kind in ("G", "L", "H"):
        if cfg.mla:
            p += (d * (cfg.kv_lora + cfg.rope_dim)
                  + cfg.kv_lora * cfg.n_heads * (cfg.head_dim
                                                 + cfg.v_head_dim)
                  + d * cfg.n_heads * (cfg.head_dim + cfg.rope_dim)
                  + cfg.n_heads * cfg.v_head_dim * d)
        else:
            p += (d * cfg.n_heads * cfg.head_dim
                  + 2 * d * cfg.n_kv * cfg.head_dim
                  + cfg.n_heads * cfg.head_dim * d)
    if kind in ("M", "H"):
        di, N = cfg.d_inner, cfg.ssm_state
        p += d * 2 * di + 2 * d * N + d * cfg.ssm_heads + di * d
    if kind != "M" and cfg.d_ff:
        mult = 3 if cfg.mlp in ("swiglu", "geglu") else 2
        if moe:
            # executed: top_k routed (x capacity padding) + shared
            p += mult * d * cfg.expert_dff * cfg.top_k * cfg.capacity_factor
            p += mult * d * cfg.expert_dff * cfg.n_shared
            p += d * cfg.n_experts          # router
        else:
            p += mult * d * cfg.d_ff
    return p


def _ssd_flops_per_token(cfg: ModelConfig) -> float:
    Q, N = cfg.ssm_chunk, cfg.ssm_state
    HP = cfg.d_inner
    # scores 2*Q*N + y_intra 2*Q*HP + states/y_inter ~ 4*N*HP
    return 2.0 * Q * N + 2.0 * Q * HP + 4.0 * N * HP


def analytic_costs(cfg: ModelConfig, cell: ShapeCell) -> dict:
    B, S = cell.global_batch, cell.seq_len
    d, V = cfg.d_model, cfg.vocab
    moe = cfg.n_experts > 0
    kinds = cfg.layer_kinds()
    locs = cfg.local_flags()
    f32, bf16 = 4, 2

    if cfg.encdec:
        enc_p, dec_p = cfg.encdec_split()
        if cell.kind == "train":
            enc_T, dec_T = B * S, B * cfg.max_dec_len
            mm = 2.0 * (enc_p * enc_T + dec_p * dec_T) + 2.0 * dec_T * V * d
            attn = _attn_repl(cfg) * 4.0 * B * cfg.n_heads * cfg.head_dim * (
                cfg.n_enc_layers * S * S
                + cfg.n_layers * (cfg.max_dec_len * cfg.max_dec_len / 2
                                  + cfg.max_dec_len * S))
            flops = 4.0 * (mm + attn)
            n = cfg.n_params()
            bytes_ = (12.0 * n * f32
                      + (cfg.n_enc_layers * enc_T
                         + cfg.n_layers * dec_T) * d * bf16 * 4
                      + dec_T * V * f32 * 2)
        elif cell.kind == "prefill":
            enc_T = B * S
            mm = 2.0 * (enc_p * enc_T + dec_p * B) + 2.0 * B * V * d
            attn = _attn_repl(cfg) * 4.0 * B * cfg.n_heads * cfg.head_dim * (
                cfg.n_enc_layers * S * S + cfg.n_layers * S)
            flops = mm + attn
            n = cfg.n_params()
            bytes_ = (n * bf16 + cfg.n_enc_layers * enc_T * d * bf16 * 4
                      + cfg.n_layers * enc_T * cfg.n_heads * cfg.head_dim
                      * bf16 * 2)
        else:
            mm = 2.0 * dec_p * B + 2.0 * B * V * d
            attn = _attn_repl(cfg) * 4.0 * B * cfg.n_heads * cfg.head_dim \
                * cfg.n_layers * (cfg.max_dec_len + S)
            flops = mm + attn
            n = cfg.n_params()
            cache = cfg.n_layers * B * cfg.n_kv * cfg.head_dim \
                * (cfg.max_dec_len + S) * 2 * bf16
            bytes_ = n * bf16 + cache
        return {"flops": flops, "bytes": bytes_}

    # ---- decoder-only ------------------------------------------------------
    layer_mm = [
        _layer_matmul_params(cfg, k, moe and i >= cfg.first_dense)
        for i, k in enumerate(kinds)]
    mm_params = sum(layer_mm)

    if cell.kind == "train":
        T = B * S
        mm = 2.0 * T * mm_params + 2.0 * T * V * d          # + logits
        attn = 0.0
        local_v, full_v = _attn_visited(cfg, S)
        for i, k in enumerate(kinds):
            if k in ("G", "L", "H"):
                hd_eff = (cfg.head_dim + cfg.rope_dim) if cfg.mla \
                    else cfg.head_dim
                visited = local_v if locs[i] else full_v
                attn += _attn_repl(cfg) * 4.0 * T * visited \
                    * cfg.n_heads * hd_eff
            if k in ("M", "H"):
                attn += T * _ssd_flops_per_token(cfg)
        flops = 4.0 * (mm + attn)                            # fwd+bwd+remat
        n = cfg.n_params()
        act = 4.0 * T * d * len(kinds) * bf16                # unit boundaries
        bytes_ = 12.0 * n * f32 + act + 2.0 * T * V * f32
        if moe:
            # dispatch buffers (x capacity factor), fwd+bwd
            Tk = T * cfg.top_k * cfg.capacity_factor
            bytes_ += 4.0 * Tk * d * bf16 * (len(kinds) - cfg.first_dense)
        return {"flops": flops, "bytes": bytes_}

    if cell.kind == "prefill":
        T = B * S
        mm = 2.0 * T * mm_params + 2.0 * B * V * d           # last-tok logits
        attn = 0.0
        local_v, full_v = _attn_visited(cfg, S)
        for i, k in enumerate(kinds):
            if k in ("G", "L", "H"):
                hd_eff = (cfg.head_dim + cfg.rope_dim) if cfg.mla \
                    else cfg.head_dim
                visited = local_v if locs[i] else full_v
                attn += _attn_repl(cfg) * 4.0 * T * visited \
                    * cfg.n_heads * hd_eff
            if k in ("M", "H"):
                attn += T * _ssd_flops_per_token(cfg)
        flops = mm + attn
        n = cfg.n_params()
        bytes_ = n * bf16 + 2.0 * T * d * len(kinds) * bf16 \
            + _cache_bytes(cfg, B, S)
        return {"flops": flops, "bytes": bytes_}

    # decode: one token per sequence against an S-long cache
    T = B
    mm = 2.0 * T * mm_params + 2.0 * T * V * d
    attn = 0.0
    for i, k in enumerate(kinds):
        if k in ("G", "L", "H"):
            if cfg.mla:
                # absorbed form: scores/AV run in kv_lora space
                attn += 4.0 * T * S * cfg.n_heads * cfg.kv_lora / 8
                attn += 2.0 * T * S * (cfg.kv_lora + cfg.rope_dim) \
                    * cfg.n_heads
            else:
                # the decode einsum runs over the PHYSICAL cache extent:
                # full S unless the layer keeps a ring cache
                ring = cfg.ring_local_cache and locs[i]
                eff = min(cfg.window, S) if ring else S
                attn += _attn_repl(cfg) * 4.0 * T * eff \
                    * cfg.n_heads * cfg.head_dim
        if k in ("M", "H"):
            attn += 4.0 * T * cfg.d_inner * cfg.ssm_state
    flops = mm + attn
    n = cfg.n_params() if not moe else cfg.n_active_params()
    bytes_ = n * bf16 + _cache_bytes(cfg, B, S)
    return {"flops": flops, "bytes": bytes_}


def _cache_bytes(cfg: ModelConfig, B: int, S: int) -> float:
    """Total KV/state cache bytes (read volume of one decode step)."""
    bf16 = 2
    total = 0.0
    locs = cfg.local_flags()
    for i, k in enumerate(cfg.layer_kinds()):
        if k in ("G", "L", "H"):
            ring = cfg.ring_local_cache and locs[i]
            S_eff = min(cfg.window, S) if ring else S
            if cfg.mla:
                total += B * S_eff * (cfg.kv_lora + cfg.rope_dim) * bf16
            else:
                total += 2.0 * B * cfg.padded_kv * S_eff * cfg.head_dim \
                    * bf16
        if k in ("M", "H"):
            total += B * cfg.ssm_heads * cfg.ssm_head_dim * cfg.ssm_state * 4
            total += 3.0 * B * (cfg.conv_width - 1) * cfg.d_inner * bf16
    return total
