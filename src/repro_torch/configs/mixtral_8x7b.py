"""mixtral-8x7b [moe]: 32L d=4096 32H (GQA kv=8) hd=128 d_ff=14336
vocab=32000; 8 experts top-2 (renormalised), sliding-window attention.
[arXiv:2401.04088; hf]"""
import dataclasses

from repro_torch.models.common import ModelConfig

FULL = ModelConfig(
    name="mixtral-8x7b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv=8, head_dim=128,
    d_ff=14336, vocab=32000,
    layer_pattern=("L",), window=4096,
    rope_theta=1e6,
    n_experts=8, n_shared=0, top_k=2, expert_dff=14336,
    renorm_topk=True,
    mlp="swiglu", norm="rms",
    tie_embeddings=False,
)

SMOKE = dataclasses.replace(
    FULL, n_layers=3, d_model=64, n_heads=4, n_kv=2, head_dim=16,
    d_ff=128, vocab=512, window=8, n_experts=4, top_k=2, expert_dff=64)
