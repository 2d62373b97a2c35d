"""deepseek-v2-lite-16b [moe]: 27L d=2048 16H d_ff(expert)=1408
vocab=102400; MLA kv_lora=512 (rope_dim 64, nope head 128, v head 128),
2 shared + 64 routed experts top-6, first layer dense (d_ff 10944).
[arXiv:2405.04434; hf]"""
import dataclasses

from repro_torch.models.common import ModelConfig

FULL = ModelConfig(
    name="deepseek-v2-lite-16b", family="moe",
    n_layers=27, d_model=2048, n_heads=16, n_kv=16, head_dim=128,
    d_ff=10944, vocab=102400,
    rope_theta=1e4,
    mla=True, kv_lora=512, rope_dim=64, v_head_dim=128,
    n_experts=64, n_shared=2, top_k=6, expert_dff=1408,
    renorm_topk=False, first_dense=1,
    mlp="swiglu", norm="rms",
    tie_embeddings=False,
)

SMOKE = dataclasses.replace(
    FULL, n_layers=3, d_model=64, n_heads=4, n_kv=4, head_dim=16,
    d_ff=256, vocab=512, kv_lora=32, rope_dim=8, v_head_dim=16,
    n_experts=8, n_shared=1, top_k=2, expert_dff=32)
