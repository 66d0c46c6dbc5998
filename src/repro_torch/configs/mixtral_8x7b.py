"""Mixtral-8x7B [arXiv:2401.04088] — 8 experts top-2 MoE, GQA kv=8,
sliding-window attention (4096) => eligible for long_500k decode."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="mixtral-8x7b", family="moe",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    head_dim=128, d_ff=14336, vocab_size=32000,
    pos_embed="rope", rope_theta=1_000_000.0, window=4096,
    norm="rmsnorm", mlp="swiglu", tie_embeddings=False,
    num_experts=8, top_k=2,
    max_seq=1_048_576, source="arXiv:2401.04088",
)
