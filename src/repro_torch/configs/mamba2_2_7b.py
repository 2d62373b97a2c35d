"""mamba2-2.7b [ssm]: 64L d=2560 attn-free, ssm_state=128 vocab=50280;
SSD (state-space duality), d_inner=5120 (expand 2), 80 heads x hd 64,
depthwise conv width 4, no FFN blocks. [arXiv:2405.21060; unverified]"""
import dataclasses

from repro_torch.models.common import ModelConfig

FULL = ModelConfig(
    name="mamba2-2.7b", family="ssm",
    n_layers=64, d_model=2560, n_heads=1, n_kv=1, head_dim=1,
    d_ff=0, vocab=50280,
    layer_pattern=("M",),
    ssm_state=128, ssm_expand=2, ssm_head_dim=64, conv_width=4,
    ssm_chunk=128,
    norm="rms",
    tie_embeddings=True,
)

SMOKE = dataclasses.replace(
    FULL, n_layers=4, d_model=64, vocab=512, ssm_state=16,
    ssm_head_dim=16, ssm_chunk=8)
