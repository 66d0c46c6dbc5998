"""Architecture registry: the 10 assigned configs + the paper's own models.

Every entry cites its source.  ``get(arch_id)`` returns the exact config;
``get(arch_id, smoke=True)`` returns the reduced smoke variant (2 layer
groups, d_model<=256, <=4 experts) used by per-arch CPU smoke tests.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.models.config import ModelConfig

from repro_torch.configs.glm4_9b import CONFIG as glm4_9b
from repro_torch.configs.granite_8b import CONFIG as granite_8b
from repro_torch.configs.llama4_maverick_400b_a17b import CONFIG as llama4_maverick
from repro_torch.configs.whisper_small import CONFIG as whisper_small
from repro_torch.configs.starcoder2_7b import CONFIG as starcoder2_7b
from repro_torch.configs.mixtral_8x7b import CONFIG as mixtral_8x7b
from repro_torch.configs.hymba_1_5b import CONFIG as hymba_1_5b
from repro_torch.configs.gemma2_27b import CONFIG as gemma2_27b
from repro_torch.configs.pixtral_12b import CONFIG as pixtral_12b
from repro_torch.configs.rwkv6_3b import CONFIG as rwkv6_3b
from repro_torch.configs.gpt2_small import CONFIG as gpt2_small

ARCHS: Dict[str, ModelConfig] = {
    c.arch_id: c for c in [
        glm4_9b, granite_8b, llama4_maverick, whisper_small, starcoder2_7b,
        mixtral_8x7b, hymba_1_5b, gemma2_27b, pixtral_12b, rwkv6_3b,
        gpt2_small,
    ]
}

ASSIGNED = [a for a in ARCHS if a != "gpt2-small"]


def get(arch_id: str, smoke: bool = False) -> ModelConfig:
    cfg = ARCHS[arch_id]
    return cfg.reduced() if smoke else cfg
