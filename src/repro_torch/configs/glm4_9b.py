"""GLM-4-9B [hf:THUDM/glm-4-9b] — dense, RoPE, aggressive GQA (kv=2)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="glm4-9b", family="dense",
    num_layers=40, d_model=4096, num_heads=32, num_kv_heads=2,
    head_dim=128, d_ff=13696, vocab_size=151552,
    pos_embed="rope", rope_theta=10_000.0,
    norm="rmsnorm", mlp="swiglu", tie_embeddings=False,
    max_seq=131072, source="hf:THUDM/glm-4-9b",
)
