"""PyTorch / CUDA port of ``repro`` for NVIDIA Hopper (H100).

The JAX package ``repro`` is the reference; this package mirrors its module
names (``models/transformer.py``, ``transport/codecs.py``, ...) so each
function has an obvious counterpart, and keeps the JAX layouts at public
functions: weights ``(in, out)`` used as ``x @ w``, layer params stacked
with a leading group dim, KV caches ``(B, C, KV, hd)``.

Every Pallas TPU kernel on a ported path has a hand-written CUDA kernel
under ``csrc/`` with a plain PyTorch twin beside its wrapper
(``kernels/``).  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; see :mod:`repro_torch.device`.
"""
