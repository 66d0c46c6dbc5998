"""Meta-tensor stand-ins for every (architecture x input-shape) pair.

Port of ``repro/launch/input_specs.py``: where the reference builds
``ShapeDtypeStruct``s, the port builds tensors on the ``meta`` device,
which carry a shape and a dtype and no storage.  The dry run
(``launch/dryrun.py``) runs the port's own steps on them.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch.models import encdec, transformer
from repro_torch.models.common import SHAPE_ONLY
from repro_torch.models.config import ModelConfig

META = torch.device("meta")


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    kind: str          # train | prefill | decode
    seq: int
    batch: int


SHAPES: Dict[str, InputShape] = {
    "train_4k":    InputShape("train_4k", "train", 4_096, 256),
    "prefill_32k": InputShape("prefill_32k", "prefill", 32_768, 32),
    "decode_32k":  InputShape("decode_32k", "decode", 32_768, 128),
    "long_500k":   InputShape("long_500k", "decode", 524_288, 1),
}


def _sd(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def model_module(cfg: ModelConfig):
    return encdec if cfg.enc_dec else transformer


def param_specs(cfg: ModelConfig):
    """The tree of ``init_params`` as meta tensors, nothing drawn (the
    same init code, given ``common.SHAPE_ONLY``)."""
    return model_module(cfg).init_params(SHAPE_ONLY, cfg)


def batch_specs(cfg: ModelConfig, shape: InputShape):
    """The data batch for train/prefill (tokens + modality stubs)."""
    b, s = shape.batch, shape.seq
    batch = {"tokens": _sd((b, s), torch.int32)}
    if cfg.frontend == "vision":
        batch["patch_embeds"] = _sd((b, cfg.num_patches, cfg.d_model),
                                    torch.bfloat16)
    if cfg.enc_dec:
        batch["enc_embeds"] = _sd((b, cfg.enc_seq, cfg.d_model),
                                  torch.bfloat16)
    return batch


def decode_specs(cfg: ModelConfig, shape: InputShape):
    """(token, caches, pos) for one decode step with a filled cache of
    length ``shape.seq``.  ``pos`` is the reference's 0-d int32; the
    port's ``decode_step`` takes the position as a host int (see
    ``dryrun.lower_one``)."""
    b, s = shape.batch, shape.seq
    caches = model_module(cfg).init_caches(cfg, b, s, torch.bfloat16,
                                           device=META)
    if cfg.enc_dec:
        caches = (caches, _sd((b, cfg.enc_seq, cfg.d_model), torch.bfloat16))
    return _sd((b,), torch.int32), caches, _sd((), torch.int32)


def ids_spec(shape: InputShape) -> torch.Tensor:
    return _sd((shape.batch,), torch.int32)


def applicable(cfg: ModelConfig, shape_name: str) -> bool:
    """long_500k only for archs whose decode memory is sub-quadratic."""
    if shape_name != "long_500k":
        return True
    return cfg.supports_long_decode()
