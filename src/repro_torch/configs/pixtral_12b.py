"""Pixtral-12B [hf:mistralai/Pixtral-12B-2409] — mistral-nemo decoder
consuming interleaved text tokens + ViT patch embeddings; the vision
encoder + projector is the allowed STUB (input_specs provides
(B, 256, d) patch embeddings)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="pixtral-12b", family="vlm",
    num_layers=40, d_model=5120, num_heads=32, num_kv_heads=8,
    head_dim=128, d_ff=14336, vocab_size=131072,
    pos_embed="rope", rope_theta=1_000_000.0,
    norm="rmsnorm", mlp="swiglu", tie_embeddings=False,
    frontend="vision", num_patches=256,
    max_seq=131072, source="hf:mistralai/Pixtral-12B-2409",
)
