"""whisper-small [audio]: 12L enc + 12L dec, d=768 12H (MHA) hd=64
d_ff=3072 vocab=51865; enc-dec, conv frontend STUB (input_specs provides
precomputed frame embeddings). [arXiv:2212.04356; unverified]"""
import dataclasses

from repro_torch.models.common import ModelConfig

FULL = ModelConfig(
    name="whisper-small", family="audio",
    n_layers=12, d_model=768, n_heads=12, n_kv=12, head_dim=64,
    pad_heads=16, pad_kv=16,    # 12 MHA heads -> 16 for head-TP
    d_ff=3072, vocab=51865,
    mlp="gelu", norm="ln",
    frontend="audio_stub", encdec=True, n_enc_layers=12, max_dec_len=448,
    tie_embeddings=True,
)

SMOKE = dataclasses.replace(
    FULL, n_layers=2, n_enc_layers=2, d_model=64, n_heads=4, n_kv=4,
    head_dim=16, d_ff=128, vocab=512, max_dec_len=32)
