"""ResNet-style CNN for the paper's ResNet18 / CIFAR-10 experiments.

Port of ``repro/models/cnn.py``.  Four stages of residual blocks with a
compression boundary at each of the 3 cuts between them; GroupNorm in
place of BatchNorm.  Float32 throughout.

Layout.  Activations are NHWC tensors, as in the reference: a cut's
``boundary_apply`` flattens each example to ``(B, H*W*C)`` for its
per-tile scales and block TopK (``kernels/ops.py``), so the logical order
must be the reference's.  Each conv views the NHWC activation as a
channels-last NCHW tensor (``permute``, no copy), and ``F.conv2d`` returns
channels-last, viewed back as NHWC.  Parameters keep the reference's
layout (HWIO convs, ``(C,)`` GroupNorm scale and bias), so its parameter
tree crosses through ``checkpoint/convert.py::params_from_numpy`` and the
npz checkpoints unchanged.

"SAME" padding is XLA's: a stride-2 3x3 conv on an even input pads
(0, 1) on each spatial axis, not (1, 1), so asymmetric pads go through
``F.pad`` before the conv.

Entry points:
  init_params(generator, num_classes, width, blocks_per_stage)
  forward_train(params, images, policy, bstates, ids)
                                        -> (logits, new_fw, bw_slots)
  forward_eval(params, images, policy, compress)        -> logits
  boundary_shapes(width, image)         -> the 3 cuts' (H, W, C)
  init_pipeline_params(generator, num_stages, ...)  (the real pipeline's
  homogeneous variant), pipeline_stage_apply, pipeline_stem,
  pipeline_head, pipeline_forward_eval
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.boundary import (boundary_apply, boundary_eval,
                                       empty_boundary_state)
from repro_torch.core.policy import CompressionPolicy, NO_POLICY
from repro_torch.transport.pipeline import _index_tree


def _conv_init(gen: torch.Generator, kh, kw, cin, cout, lead=()):
    std = (2.0 / (kh * kw * cin)) ** 0.5
    return torch.randn((*lead, kh, kw, cin, cout), generator=gen,
                       device=gen.device) * std


def _same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's "SAME" padding of one spatial axis: (low, high)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1):
    """NHWC ``x`` with an HWIO kernel, "SAME" padding -> NHWC.  A 1x1
    kernel needs no padding at any stride: it is a matmul over the
    channels of every ``stride``-th pixel (the CPU's channels-last 1x1
    stride-2 conv backward corrupts memory at batch 100 in torch 2.13)."""
    if w.shape[0] == w.shape[1] == 1:
        return x[:, ::stride, ::stride, :] @ w[0, 0]
    ph = _same_pads(x.shape[1], w.shape[0], stride)
    pw = _same_pads(x.shape[2], w.shape[1], stride)
    xc = x.permute(0, 3, 1, 2)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        pad = (ph[0], pw[0])
    else:
        xc = F.pad(xc, (pw[0], pw[1], ph[0], ph[1]))
        pad = 0
    y = F.conv2d(xc, w.permute(3, 2, 0, 1), stride=stride, padding=pad)
    return y.permute(0, 2, 3, 1)


def _gn_init(c: int, device=None, lead=()):
    return {"scale": torch.ones((*lead, c), device=device),
            "bias": torch.zeros((*lead, c), device=device)}


def _gn(params, x: torch.Tensor, groups: int = 8):
    """GroupNorm over (H, W, C/g) of ``min(groups, C)`` channel groups,
    biased variance, eps 1e-5, then the per-channel affine."""
    b, h, w, c = x.shape
    g = min(groups, c)
    xg = x.reshape(b, h, w, g, c // g)
    var, mu = torch.var_mean(xg, dim=(1, 2, 4), correction=0, keepdim=True)
    xg = (xg - mu) * torch.rsqrt(var + 1e-5)
    return xg.reshape(b, h, w, c) * params["scale"] + params["bias"]


def _block_init(gen: torch.Generator, cin, cout, stride, lead=()):
    p = {"conv1": _conv_init(gen, 3, 3, cin, cout, lead),
         "gn1": _gn_init(cout, gen.device, lead),
         "conv2": _conv_init(gen, 3, 3, cout, cout, lead),
         "gn2": _gn_init(cout, gen.device, lead)}
    if stride != 1 or cin != cout:
        p["proj"] = _conv_init(gen, 1, 1, cin, cout, lead)
    return p


def _block_apply(p, x, stride):
    h = F.relu(_gn(p["gn1"], _conv(x, p["conv1"], stride)))
    h = _gn(p["gn2"], _conv(h, p["conv2"]))
    sc = _conv(x, p["proj"], stride) if "proj" in p else x
    return F.relu(h + sc)


def _stage_strides(num_stages, blocks_per_stage):
    return [[2 if (b == 0 and s > 0) else 1 for b in range(blocks_per_stage)]
            for s in range(num_stages)]


def init_params(generator: torch.Generator, num_classes: int = 10,
                width: int = 64, blocks_per_stage: int = 2):
    """ResNet18 when ``width=64, blocks_per_stage=2``: random params in
    the reference's tree layout, drawn from ``generator`` on its device
    (the same layout, not the same numbers as ``jax.random``)."""
    widths = [width, width * 2, width * 4, width * 8]
    dev = generator.device
    params = {"stem": _conv_init(generator, 3, 3, 3, width),
              "stem_gn": _gn_init(width, dev), "stages": []}
    cin = width
    strides = _stage_strides(len(widths), blocks_per_stage)
    for s, cout in enumerate(widths):
        stage = []
        for stride in strides[s]:
            stage.append(_block_init(generator, cin, cout, stride))
            cin = cout
        params["stages"].append(stage)
    params["fc"] = (torch.randn((cin, num_classes), generator=generator,
                                device=dev) * (1.0 / cin) ** 0.5)
    params["fc_b"] = torch.zeros((num_classes,), device=dev)
    return params


def _stem(params, images):
    return F.relu(_gn(params["stem_gn"], _conv(images, params["stem"])))


def _head(params, x):
    # a mean, not nn.AdaptiveAvgPool2d: its CUDA backward is
    # nondeterministic
    return x.mean(dim=(1, 2)) @ params["fc"] + params["fc_b"]


def forward_train(params, images, policy: CompressionPolicy = NO_POLICY,
                  bstates: Optional[list] = None, ids=None):
    """Returns ``(logits, new_fw_states, bw_slots)``: a boundary at each
    of the cuts between the 4 stages.  ``bw_slots[i].state`` is cut
    ``i``'s new backward state once backward has run."""
    if ids is None:
        ids = torch.zeros((images.shape[0],), dtype=torch.int32,
                          device=images.device)
    x = _stem(params, images)
    new_fw, slots = [], []
    n = len(params["stages"])
    strides = _stage_strides(n, len(params["stages"][0]))
    for s, stage in enumerate(params["stages"]):
        for p, st_ in zip(stage, strides[s]):
            x = _block_apply(p, x, st_)
        if s < n - 1 and policy.num_boundaries > s:
            st = (bstates[s] if bstates is not None
                  else empty_boundary_state(x.dtype, x.device))
            x, nf, slot = boundary_apply(policy.at(s), x, st["fw"],
                                         st["bw"], ids)
            new_fw.append(nf)
            slots.append(slot)
    return _head(params, x), new_fw, slots


def forward_eval(params, images, policy: CompressionPolicy = NO_POLICY,
                 compress: bool = True):
    x = _stem(params, images)
    n = len(params["stages"])
    strides = _stage_strides(n, len(params["stages"][0]))
    for s, stage in enumerate(params["stages"]):
        for p, st_ in zip(stage, strides[s]):
            x = _block_apply(p, x, st_)
        if s < n - 1 and policy.num_boundaries > s:
            x = boundary_eval(policy.at(s), x, compress)
    return _head(params, x)


def boundary_shapes(width: int = 64, image: int = 32
                    ) -> List[Tuple[int, ...]]:
    """Feature shapes (H, W, C) at the 3 cuts (feedback buffer init)."""
    return [(image, image, width),
            (image // 2, image // 2, width * 2),
            (image // 4, image // 4, width * 4)]


# ---------------------------------------------------------------------------
# Homogeneous-stage variant for the real pipeline (transport/pipeline.py)
# ---------------------------------------------------------------------------
# The pipeline runs one stage function at every stage, so the cut tensor
# and the stage params' structure are the same at every stage: constant
# width and resolution through S stages of residual blocks.  Stem and head
# run outside the pipeline.

def init_pipeline_params(generator: torch.Generator, num_stages: int,
                         num_classes: int = 10, width: int = 16,
                         blocks_per_stage: int = 2):
    """Stage params stacked with leading dim ``num_stages``."""
    dev = generator.device
    params = {"stem": _conv_init(generator, 3, 3, 3, width),
              "stem_gn": _gn_init(width, dev),
              "stages": {f"b{i}": _block_init(generator, width, width, 1,
                                              (num_stages,))
                         for i in range(blocks_per_stage)}}
    params["fc"] = (torch.randn((width, num_classes), generator=generator,
                                device=dev) * (1.0 / width) ** 0.5)
    params["fc_b"] = torch.zeros((num_classes,), device=dev)
    return params


def pipeline_stage_apply(stage_params, x):
    """One homogeneous stage: ``blocks_per_stage`` width-preserving
    residual blocks; the pipeline's ``stage_fn``."""
    for i in range(len(stage_params)):
        x = _block_apply(stage_params[f"b{i}"], x, 1)
    return x


def pipeline_stem(params, images):
    return _stem(params, images)


def pipeline_head(params, x):
    return _head(params, x)


def pipeline_forward_eval(params, images,
                          policy: CompressionPolicy = NO_POLICY,
                          compress: bool = True):
    """Sequential eval of the pipeline model on one device, the fw
    compressor between stages when ``compress`` (the codec round trip
    equals C(x)).  With more stacked slices than the policy has cuts
    (interleaved virtual stages) every cut still compresses, as on the
    pipeline's wire."""
    x = pipeline_stem(params, images)
    n = params["stages"]["b0"]["conv1"].shape[0]
    for s in range(n):
        x = pipeline_stage_apply(_index_tree(params["stages"], s), x)
        if s < n - 1 and policy.num_boundaries > 0:
            x = boundary_eval(policy.at(min(s, policy.num_boundaries - 1)),
                              x, compress)
    return pipeline_head(params, x)
