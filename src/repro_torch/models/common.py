"""Model configuration shared by the ten LM architectures (a copy of the
JAX package's, so that the port imports nothing of it)."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    head_dim: int
    d_ff: int
    vocab: int

    # --- attention variants -------------------------------------------------
    pad_heads: int = 0              # physical head count for TP (Megatron-
                                    # style padding: dead heads are masked so
                                    # semantics stay exactly n_heads; lets
                                    # e.g. 40 heads shard a 16-wide axis)
    pad_kv: int = 0                 # physical kv-head count (same idea)
    rope_theta: float = 1e4
    rope_theta_local: float = 0.0   # gemma3: different theta for local layers
    qk_norm: bool = False           # qwen3 / gemma3 per-head RMSNorm on q,k
    softcap_attn: float = 0.0       # gemma2 attention-logit softcap
    softcap_final: float = 0.0      # gemma2 final-logit softcap
    window: int = 0                 # sliding-window size for 'L' layers
    # layer kinds, cycled over n_layers: G global attn, L local attn,
    # M mamba2 mixer, H hymba parallel attn+ssm. Overridden by full_attn_idx.
    layer_pattern: Tuple[str, ...] = ("G",)
    full_attn_idx: Tuple[int, ...] = ()   # layers whose attention is global
                                          # even when the pattern is local
                                          # (hymba: first/middle/last)
    mlp: str = "swiglu"             # swiglu | geglu | gelu
    norm: str = "rms"               # rms | ln
    post_norm: bool = False         # gemma2/3 extra post-layer norms

    # --- MLA (deepseek) ------------------------------------------------------
    mla: bool = False
    kv_lora: int = 0
    rope_dim: int = 0
    v_head_dim: int = 0

    # --- MoE -----------------------------------------------------------------
    n_experts: int = 0
    n_shared: int = 0
    top_k: int = 0
    expert_dff: int = 0
    renorm_topk: bool = True
    first_dense: int = 0            # leading dense layers (deepseek: 1)
    capacity_factor: float = 1.25
    moe_groups: int = 1             # dispatch groups; launcher sets this to
                                    # the DP size so sort/scatter stay
                                    # per-shard under GSPMD
    moe_ep: bool = False            # expert-parallel boundary-a2a MoE
                                    # (parallel/ep_moe; needs an active
                                    # activation_sharding mesh context)

    # --- SSM (mamba2 / hymba) ------------------------------------------------
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    conv_width: int = 4
    ssm_chunk: int = 256

    # --- frontends / structure ----------------------------------------------
    frontend: str = "none"          # none | vision_stub | audio_stub
    n_frontend_tokens: int = 0      # vlm: image tokens prepended
    encdec: bool = False            # whisper
    n_enc_layers: int = 0
    max_dec_len: int = 448          # whisper decoder length
    n_meta_tokens: int = 0          # hymba learnable prefix tokens
    tie_embeddings: bool = True
    embed_scale: bool = False       # gemma: scale embeddings by sqrt(d)
    ring_local_cache: bool = False  # sliding-window layers keep a window-
                                    # sized ring KV cache instead of the
                                    # full context (EXPERIMENTS §Perf)

    dtype: str = "bfloat16"

    # --- derived -------------------------------------------------------------
    @property
    def padded_heads(self) -> int:
        return self.pad_heads or self.n_heads

    @property
    def padded_kv(self) -> int:
        return self.pad_kv or self.n_kv

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def layer_kinds(self) -> Tuple[str, ...]:
        return tuple(self.layer_pattern[i % len(self.layer_pattern)]
                     for i in range(self.n_layers))

    def local_flags(self) -> Tuple[bool, ...]:
        """Per-layer: does this layer's attention use the sliding window?"""
        kinds = self.layer_kinds()
        return tuple(
            self.window > 0 and kinds[i] in ("L", "H")
            and i not in self.full_attn_idx
            for i in range(self.n_layers))

    def encdec_split(self):
        """(encoder_params, decoder_params) for enc-dec models."""
        d = self.d_model
        attn_p = 4 * d * self.n_heads * self.head_dim
        mult = 3 if self.mlp in ("swiglu", "geglu") else 2
        enc = self.n_enc_layers * (attn_p + mult * d * self.d_ff)
        dec = self.n_layers * (2 * attn_p + mult * d * self.d_ff)
        return enc, dec

    def n_params(self) -> int:
        """Analytic parameter count (for roofline MODEL_FLOPS)."""
        d, L = self.d_model, self.n_layers
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        if self.encdec:
            enc, dec = self.encdec_split()
            return emb + self.max_dec_len * d + enc + dec
        per = 0
        kinds = self.layer_kinds()
        for i, kind in enumerate(kinds):
            if kind in ("G", "L", "H"):
                if self.mla:
                    per_attn = (d * (self.kv_lora + self.rope_dim)
                                + self.kv_lora * self.n_heads
                                * (self.head_dim + self.v_head_dim)
                                + d * self.n_heads * (self.head_dim + self.rope_dim)
                                + self.n_heads * self.v_head_dim * d)
                else:
                    per_attn = (d * self.n_heads * self.head_dim
                                + 2 * d * self.n_kv * self.head_dim
                                + self.n_heads * self.head_dim * d)
                per += per_attn
            if kind in ("M", "H"):
                di, ns = self.d_inner, self.ssm_state
                per += d * 2 * di + 2 * d * ns + d * self.ssm_heads \
                    + di * d + self.conv_width * (di + 2 * ns)
            # FFN / MoE
            if kind == "M":
                pass                      # mamba2 blocks have no FFN
            elif self.n_experts and i >= self.first_dense:
                mult = 3 if self.mlp in ("swiglu", "geglu") else 2
                per += (self.n_experts + self.n_shared) * mult * d * self.expert_dff
                per += d * self.n_experts
            elif self.d_ff:
                mult = 3 if self.mlp in ("swiglu", "geglu") else 2
                per += mult * d * self.d_ff
        return emb + per

    def n_active_params(self) -> int:
        """Active params per token (MoE: only top_k + shared experts)."""
        if not self.n_experts:
            return self.n_params()
        d = self.d_model
        mult = 3 if self.mlp in ("swiglu", "geglu") else 2
        n_moe_layers = self.n_layers - self.first_dense
        inactive = n_moe_layers * (self.n_experts - self.top_k) * mult * d * self.expert_dff
        return self.n_params() - inactive


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    """One (architecture x input-shape) dry-run cell."""
    name: str                       # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str                       # train | prefill | decode


SHAPES = (
    ShapeCell("train_4k", 4096, 256, "train"),
    ShapeCell("prefill_32k", 32768, 32, "prefill"),
    ShapeCell("decode_32k", 32768, 128, "decode"),
    ShapeCell("long_500k", 524288, 1, "decode"),
)
