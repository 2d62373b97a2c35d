"""starcoder2-15b [dense]: 40L d=6144 48H (GQA kv=4) hd=128 d_ff=24576
vocab=49152; GQA + RoPE, LayerNorm, non-gated GeLU MLP.
[arXiv:2402.19173; hf]"""
import dataclasses

from repro_torch.models.common import ModelConfig

FULL = ModelConfig(
    name="starcoder2-15b", family="dense",
    n_layers=40, d_model=6144, n_heads=48, n_kv=4, head_dim=128,
    d_ff=24576, vocab=49152,
    rope_theta=999999.0,
    mlp="gelu", norm="ln",
    tie_embeddings=False,
)

SMOKE = dataclasses.replace(
    FULL, n_layers=3, d_model=96, n_heads=6, n_kv=2, head_dim=16,
    d_ff=192, vocab=512)
