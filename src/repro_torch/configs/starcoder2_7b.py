"""StarCoder2-7B [arXiv:2402.19173] — GQA kv=4, RoPE, GeLU MLP, LayerNorm."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="starcoder2-7b", family="dense",
    num_layers=32, d_model=4608, num_heads=36, num_kv_heads=4,
    head_dim=128, d_ff=18432, vocab_size=49152,
    pos_embed="rope", rope_theta=1_000_000.0,
    norm="layernorm", mlp="gelu", tie_embeddings=True,
    max_seq=16384, source="arXiv:2402.19173",
)
