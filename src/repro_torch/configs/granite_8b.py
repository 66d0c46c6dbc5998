"""Granite-8B-Code [arXiv:2405.04324] — llama-architecture code model."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="granite-8b", family="dense",
    num_layers=36, d_model=4096, num_heads=32, num_kv_heads=8,
    head_dim=128, d_ff=14336, vocab_size=49152,
    pos_embed="rope", rope_theta=10_000_000.0,
    norm="rmsnorm", mlp="swiglu", tie_embeddings=True,
    max_seq=131072, source="arXiv:2405.04324",
)
