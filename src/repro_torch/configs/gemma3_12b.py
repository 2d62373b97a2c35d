"""gemma3-12b [dense]: 48L d=3840 16H (GQA kv=8) hd=256 d_ff=15360
vocab=262144; 5:1 local:global pattern, window 1024, qk-norm, dual RoPE
theta (1M global / 10k local), sandwich norms.
[hf:google/gemma-3-1b-pt; unverified]"""
import dataclasses

from repro_torch.models.common import ModelConfig

FULL = ModelConfig(
    name="gemma3-12b", family="dense",
    n_layers=48, d_model=3840, n_heads=16, n_kv=8, head_dim=256,
    d_ff=15360, vocab=262144,
    layer_pattern=("L", "L", "L", "L", "L", "G"), window=1024,
    rope_theta=1e6, rope_theta_local=1e4, qk_norm=True,
    mlp="geglu", norm="rms", post_norm=True,
    embed_scale=True, tie_embeddings=True,
)

SMOKE = dataclasses.replace(
    FULL, n_layers=6, d_model=64, n_heads=4, n_kv=2, head_dim=16,
    d_ff=128, vocab=512, window=8)
