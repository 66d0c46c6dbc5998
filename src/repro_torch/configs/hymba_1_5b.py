"""Hymba-1.5B [arXiv:2411.13676] — hybrid: parallel attention + Mamba heads
per block (SSM heads implemented as Mamba2/SSD scalar-decay variant — see
DESIGN.md hardware-adaptation notes), SWA on attention heads."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="hymba-1.5b", family="hybrid",
    num_layers=32, d_model=1600, num_heads=25, num_kv_heads=5,
    head_dim=64, d_ff=5504, vocab_size=32001,
    pos_embed="rope", rope_theta=10_000.0, window=1024,
    norm="rmsnorm", mlp="swiglu", tie_embeddings=True,
    ssm_state=16, ssm_heads=25,
    max_seq=1_048_576, source="arXiv:2411.13676",
)
