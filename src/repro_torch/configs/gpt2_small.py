"""GPT-2-small [Radford et al. 2019] — the paper's own LM fine-tuning
architecture (Table 5): 12L d=768 12H MHA, GeLU, LayerNorm, abs pos.
We use RoPE-free learned-position-free causal stack with abs pos via
the dense path (pos_embed='none' + tied embeddings) at paper scale."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="gpt2-small", family="dense",
    num_layers=12, d_model=768, num_heads=12, num_kv_heads=12,
    head_dim=64, d_ff=3072, vocab_size=50257,
    pos_embed="rope", norm="layernorm", mlp="gelu", tie_embeddings=True,
    max_seq=1024, source="Radford et al. 2019 (paper Sec. 3.2)",
)
