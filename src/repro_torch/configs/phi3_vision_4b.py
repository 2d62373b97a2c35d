"""phi-3-vision-4.2b [vlm]: 32L d=3072 32H (kv=32, MHA) hd=96 d_ff=8192
vocab=32064; phi3-mini backbone + CLIP frontend STUB (input_specs provides
576 precomputed patch embeddings prepended to the text sequence).
[hf:microsoft/Phi-3-vision-128k-instruct; hf]"""
import dataclasses

from repro_torch.models.common import ModelConfig

FULL = ModelConfig(
    name="phi-3-vision-4.2b", family="vlm",
    n_layers=32, d_model=3072, n_heads=32, n_kv=32, head_dim=96,
    d_ff=8192, vocab=32064,
    rope_theta=1e4,
    mlp="swiglu", norm="rms",
    frontend="vision_stub", n_frontend_tokens=576,
    tie_embeddings=False,
)

SMOKE = dataclasses.replace(
    FULL, n_layers=3, d_model=64, n_heads=4, n_kv=4, head_dim=16,
    d_ff=128, vocab=512, n_frontend_tokens=8)
