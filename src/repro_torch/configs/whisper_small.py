"""Whisper-small [arXiv:2212.04356] — enc-dec; conv/mel frontend STUBBED
(input_specs provides (B, 1500, d) frame embeddings)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="whisper-small", family="audio",
    num_layers=12, d_model=768, num_heads=12, num_kv_heads=12,
    head_dim=64, d_ff=3072, vocab_size=51865,
    pos_embed="abs", norm="layernorm", mlp="gelu", tie_embeddings=True,
    enc_dec=True, enc_layers=12, enc_seq=1500, frontend="audio",
    max_seq=32768, source="arXiv:2212.04356",
)
