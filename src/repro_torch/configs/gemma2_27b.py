"""gemma2-27b [dense]: 46L d=4608 32H (GQA kv=16) hd=128 d_ff=36864
vocab=256000; local+global alternating (window 4096), attention-logit
softcap 50 / final-logit softcap 30, sandwich norms. [arXiv:2408.00118; hf]"""
import dataclasses

from repro_torch.models.common import ModelConfig

FULL = ModelConfig(
    name="gemma2-27b", family="dense",
    n_layers=46, d_model=4608, n_heads=32, n_kv=16, head_dim=128,
    d_ff=36864, vocab=256000,
    layer_pattern=("L", "G"), window=4096,
    rope_theta=1e4, softcap_attn=50.0, softcap_final=30.0,
    mlp="geglu", norm="rms", post_norm=True,
    embed_scale=True, tie_embeddings=True,
)

SMOKE = dataclasses.replace(
    FULL, n_layers=4, d_model=64, n_heads=4, n_kv=2, head_dim=16,
    d_ff=128, vocab=512, window=8)
