"""qwen3-14b [dense]: 40L d=5120 40H (GQA kv=8) hd=128 d_ff=17408
vocab=151936; per-head q/k RMSNorm, SwiGLU. [hf:Qwen/Qwen3-8B; hf]"""
import dataclasses

from repro_torch.models.common import ModelConfig

FULL = ModelConfig(
    name="qwen3-14b", family="dense",
    n_layers=40, d_model=5120, n_heads=40, n_kv=8, head_dim=128,
    pad_heads=48,        # 40 -> 48 so head-TP divides the 16-wide model axis
    d_ff=17408, vocab=151936,
    rope_theta=1e6, qk_norm=True,
    mlp="swiglu", norm="rms",
    tie_embeddings=False,
)

SMOKE = dataclasses.replace(
    FULL, n_layers=3, d_model=64, n_heads=4, n_kv=2, head_dim=16,
    d_ff=128, vocab=512, pad_heads=6)   # exercise padding in the smoke test
