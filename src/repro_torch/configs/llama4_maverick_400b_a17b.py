"""Llama-4-Maverick-400B-A17B [hf:meta-llama/Llama-4-Scout-17B-16E] —
MoE 128 experts top-1 + shared expert, interleaved every 2nd layer
(dense/MoE pairs), early-fusion text backbone."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="llama4-maverick-400b-a17b", family="moe",
    num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8,
    head_dim=128, d_ff=8192, vocab_size=202048,
    pos_embed="rope", rope_theta=500_000.0,
    norm="rmsnorm", mlp="swiglu", tie_embeddings=False,
    num_experts=128, top_k=1, moe_every_n=2, num_shared_experts=1,
    max_seq=1_048_576, source="hf:meta-llama/Llama-4-Scout-17B-16E",
)
