"""RWKV6-3B (Finch) [arXiv:2404.05892] — attention-free, data-dependent
per-channel decay; O(1) decode state => long_500k eligible.
head_size=64 => 40 heads (ssm_state field holds the head size)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="rwkv6-3b", family="ssm",
    num_layers=32, d_model=2560, num_heads=40, num_kv_heads=40,
    head_dim=64, d_ff=8960, vocab_size=65536,
    pos_embed="none", norm="layernorm", mlp="gelu", tie_embeddings=True,
    ssm_state=64,
    max_seq=1_048_576, source="arXiv:2404.05892",
)
