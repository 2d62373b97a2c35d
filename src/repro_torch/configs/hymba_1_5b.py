"""hymba-1.5b [hybrid]: 32L d=1600 25H (GQA kv=5) hd=64 d_ff=5504
vocab=32001, ssm_state=16; parallel attention+mamba heads in every layer,
sliding-window attention except first/middle/last (global), 128 learnable
meta tokens prepended. [arXiv:2411.13676; hf]"""
import dataclasses

from repro_torch.models.common import ModelConfig

FULL = ModelConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv=5, head_dim=64,
    pad_heads=48, pad_kv=8,     # 25H/5kv -> 48/8: head-TP over 16 chips
    d_ff=5504, vocab=32001,
    layer_pattern=("H",), window=1024, full_attn_idx=(0, 16, 31),
    rope_theta=1e4,
    ssm_state=16, ssm_expand=2, ssm_head_dim=64, conv_width=4,
    n_meta_tokens=128,
    mlp="swiglu", norm="rms",
    tie_embeddings=True,
)

SMOKE = dataclasses.replace(
    FULL, n_layers=4, d_model=64, n_heads=4, n_kv=2, head_dim=16,
    d_ff=128, vocab=512, window=8, full_attn_idx=(0, 3),
    ssm_state=8, ssm_head_dim=16, n_meta_tokens=4)
