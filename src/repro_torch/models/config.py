"""Model configuration.

One frozen dataclass describes every architecture family in the pool
(dense / moe / ssm / hybrid / audio / vlm).  ``src/repro/configs/<id>.py``
instantiates the exact assigned configs; ``reduced()`` derives the smoke-test
variant (<=2 layer-groups, d_model<=512, <=4 experts).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str                       # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                 # 0 => d_model // num_heads

    # -- attention behaviour -------------------------------------------------
    pos_embed: str = "rope"           # rope | abs
    rope_theta: float = 10_000.0
    window: Optional[int] = None      # sliding-window size (SWA)
    local_global_period: int = 0      # gemma2: 2 => alternate local/global
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None

    # -- block flavour -------------------------------------------------------
    norm: str = "rmsnorm"             # rmsnorm | layernorm
    mlp: str = "swiglu"               # swiglu | gelu
    post_norm: bool = False           # gemma2 sandwich norms
    tie_embeddings: bool = True

    # -- MoE -----------------------------------------------------------------
    num_experts: int = 0
    top_k: int = 0
    moe_every_n: int = 1              # llama4: 2 => dense/MoE interleave
    num_shared_experts: int = 0
    capacity_factor: float = 1.25
    moe_dispatch_quant: bool = False  # BEYOND-PAPER: int8 EP all-to-all

    # -- SSM / linear attention ----------------------------------------------
    ssm_state: int = 0                # rwkv: head_size; mamba: state N
    ssm_heads: int = 0                # hymba: number of mamba heads

    # -- encoder-decoder (audio) ---------------------------------------------
    enc_dec: bool = False
    enc_layers: int = 0
    enc_seq: int = 0                  # stub frontend frame count

    # -- modality stubs ------------------------------------------------------
    frontend: str = "none"            # none | audio | vision
    num_patches: int = 0              # vlm: patch embeddings per example

    max_seq: int = 8192
    source: str = ""                  # citation

    # ------------------------------------------------------------------

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def group_size(self) -> int:
        """Layers per scan group (local/global or dense/moe interleave)."""
        if self.local_global_period:
            return self.local_global_period
        if self.num_experts and self.moe_every_n > 1:
            return self.moe_every_n
        return 1

    @property
    def num_groups(self) -> int:
        assert self.num_layers % self.group_size == 0, \
            f"{self.arch_id}: num_layers {self.num_layers} % group {self.group_size}"
        return self.num_layers // self.group_size

    def layer_kinds(self) -> Tuple[str, ...]:
        """Block kinds inside one group, in order."""
        if self.family == "ssm":
            return ("rwkv",)
        if self.family == "hybrid":
            return ("hymba",)
        if self.local_global_period == 2:
            return ("attn_local", "attn_global")
        if self.num_experts and self.moe_every_n == 2:
            return ("dense", "moe")
        if self.num_experts:
            return ("moe",)
        return ("dense",)

    def supports_long_decode(self) -> bool:
        """True if decode memory is sub-quadratic in context (SSM/hybrid/SWA/
        local-global).  Pure full-attention archs skip long_500k."""
        return (self.family in ("ssm", "hybrid") or self.window is not None
                or self.local_global_period == 2)

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant of the same family: <=2 groups, d<=512,
        <=4 experts, small vocab."""
        group = self.group_size
        d = min(self.d_model, 256)
        heads = 4
        kv = max(1, min(self.num_kv_heads, 2))
        return dataclasses.replace(
            self,
            arch_id=self.arch_id + "-smoke",
            num_layers=2 * group,
            d_model=d,
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=d // heads,
            d_ff=min(self.d_ff, 512),
            vocab_size=min(self.vocab_size, 512),
            num_experts=min(self.num_experts, 4) if self.num_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_heads=min(self.ssm_heads, 2) if self.ssm_heads else 0,
            enc_layers=2 if self.enc_layers else 0,
            enc_seq=min(self.enc_seq, 32) if self.enc_seq else 0,
            num_patches=min(self.num_patches, 8) if self.num_patches else 0,
            window=min(self.window, 16) if self.window else None,
            max_seq=512,
        )


def param_count(cfg: ModelConfig) -> int:
    """Analytic parameter count (used for 6ND model-FLOPs in §Roofline)."""
    d, ff, hd = cfg.d_model, cfg.d_ff, cfg.resolved_head_dim
    h, kv = cfg.num_heads, cfg.num_kv_heads
    attn = d * hd * h + 2 * d * hd * kv + hd * h * d          # q,k,v,o
    mlp_mult = 3 if cfg.mlp == "swiglu" else 2
    dense_mlp = mlp_mult * d * ff
    total = cfg.vocab_size * d * (1 if cfg.tie_embeddings else 2)
    kinds = cfg.layer_kinds() * cfg.num_groups
    for kind in kinds[:cfg.num_layers]:
        if kind in ("dense", "attn_local", "attn_global"):
            total += attn + dense_mlp
        elif kind == "moe":
            total += attn + cfg.num_experts * dense_mlp
            total += cfg.num_shared_experts * dense_mlp
            total += d * cfg.num_experts                       # router
        elif kind == "rwkv":
            # r,k,v,g,w projections + output + channel mix
            total += 6 * d * d + mlp_mult * d * ff
        elif kind == "hymba":
            ssm_d = cfg.ssm_heads * hd
            total += attn + dense_mlp
            total += 2 * d * ssm_d + ssm_d * (2 * cfg.ssm_state + 2) + ssm_d * d
    if cfg.enc_dec:
        total += cfg.enc_layers * (2 * attn + dense_mlp)       # enc + cross-attn
    return total


def active_param_count(cfg: ModelConfig) -> int:
    """Active (per-token) params — MoE counts only top_k experts."""
    if not cfg.num_experts:
        return param_count(cfg)
    dense_like = dataclasses.replace(cfg, num_experts=cfg.top_k + cfg.num_shared_experts,
                                     top_k=cfg.top_k)
    return param_count(dense_like)
