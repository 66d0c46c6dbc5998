"""Gemma2-27B [arXiv:2408.00118] — alternating local(4096)/global attention,
attn-logit softcap 50, final-logit softcap 30, sandwich norms, GeGLU."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="gemma2-27b", family="dense",
    num_layers=46, d_model=4608, num_heads=32, num_kv_heads=16,
    head_dim=128, d_ff=36864, vocab_size=256000,
    pos_embed="rope", rope_theta=10_000.0,
    window=4096, local_global_period=2,
    attn_softcap=50.0, final_softcap=30.0,
    norm="rmsnorm", mlp="swiglu", post_norm=True, tie_embeddings=True,
    max_seq=1_048_576, source="arXiv:2408.00118",
)
