"""Wire codecs: the byte formats a stage boundary actually sends.

Port of ``repro/transport/codecs.py``.  One codec = one wire scheme:
``pack`` maps a boundary tensor ``(B, ...)`` to a payload dict of tensors,
``unpack`` inverts it given the original shape.

  * ``none`` — raw bf16                            (2    bytes/elem)
  * ``q8``   — uint8 codes + min/scale             (1    byte/elem)
  * ``q4``   — two 4-bit codes packed per uint8    (0.5  byte/elem)
  * ``topk`` — (bf16 values, uint16/int32 indices) (k*(2+idx) bytes/elem)

Quantization stats are per tensor, as in the reference — or, with
``per_request=True``, one (min, scale) per row of the ``(B, ...)`` tensor:
each row then carries exactly the payload the reference's
``jax.vmap``-per-request pack gives it (core/boundary.py).  ``unpack``
reads either form from the shape of ``min``.  TopK is per example in both.

q4 packs through ``kernels/pack4.py`` and TopK selects through
``kernels/topk_select.py`` (CUDA kernels on the card, plain versions on the
CPU); q8 stays per-tensor torch ops, as the reference computes it outside
Pallas when serving.  The TopK unpack scatter is torch ops, as the
reference leaves it to XLA.  Payload fusion (``fuse_payload``) is not
ported yet.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.core.compressors import (Compressor, dequantize_kbit,
                                          quantize_kbit, topk_count,
                                          topk_scatter)
from repro_torch.kernels.pack4 import (minmax_scale, pack4_wire,
                                      unpack4_wire)
from repro_torch.kernels.topk_select import topk_select_wire

# Index dtype threshold: a flattened feature dim of up to 2**16 entries has
# indices 0..65535, exactly the uint16 range.
_U16_MAX_N = 1 << 16


def _flat_n(shape) -> int:
    n = 1
    for s in shape[1:]:
        n *= s
    return n


def _stat_column(v: torch.Tensor) -> torch.Tensor:
    """A scalar or per-row ``(B,)`` stat, broadcastable against (B, n)."""
    return v.reshape(-1, 1)


class WireCodec:
    """Base class: a named wire format with a bytes-per-element cost model.

    ``pack(x, k_frac, per_request)`` : (B, ...) tensor -> payload dict.
    ``unpack(payload, shape, dtype)`` : payload -> (B, ...) tensor.
    ``wire_bytes_per_elem(n, elem_bytes, k_frac)`` : cost model, excluding
    the O(1) scale overhead.
    """

    name: str = "?"

    def payload_keysets(self) -> Tuple[Tuple[str, ...], ...]:
        """The exact key sets this codec's ``pack`` can emit, registered so
        ``unpack_payload`` dispatches on the full key SET."""
        raise NotImplementedError

    def pack(self, x: torch.Tensor, k_frac: float = 1.0,
             per_request: bool = False) -> dict:
        raise NotImplementedError

    def unpack(self, payload: dict, shape, dtype=torch.bfloat16):
        raise NotImplementedError

    def wire_bytes_per_elem(self, n: int, elem_bytes: int = 2,
                            k_frac: float = 1.0) -> float:
        raise NotImplementedError


class NoneCodec(WireCodec):
    """Raw bf16 — the uncompressed baseline wire format."""

    name = "none"

    def payload_keysets(self):
        return (("raw",),)

    def pack(self, x, k_frac: float = 1.0, per_request: bool = False):
        return {"raw": x.to(torch.bfloat16)}

    def unpack(self, payload, shape, dtype=torch.bfloat16):
        return payload["raw"].to(dtype)

    def wire_bytes_per_elem(self, n, elem_bytes: int = 2,
                            k_frac: float = 1.0) -> float:
        return float(elem_bytes)


class QuantCodec(WireCodec):
    """Uniform k-bit min-max quantization; 4-bit packs two codes per byte."""

    def __init__(self, bits: int):
        assert bits in (4, 8), bits
        self.bits = bits
        self.name = f"q{bits}"

    def payload_keysets(self):
        if self.bits == 4:
            return (("codes4", "min", "scale"),)
        return (("codes", "min", "scale"),)

    def pack(self, x, k_frac: float = 1.0, per_request: bool = False):
        flat = x.reshape(x.shape[0], -1).to(torch.float32)
        if self.bits == 4:
            if per_request:
                mn, sc = minmax_scale(flat)
            else:   # one pair over the tensor, the kernel reads it per row
                mn, sc = (v.reshape(()) for v in
                          minmax_scale(flat.reshape(1, -1)))
            m = flat.shape[0]
            packed = pack4_wire(flat, mn.expand(m), sc.expand(m))
            return {"codes4": packed, "min": mn, "scale": sc}
        codes, mn, sc = quantize_kbit(flat, 8, dim=1 if per_request else None)
        if per_request:
            mn, sc = mn.reshape(-1), sc.reshape(-1)
        return {"codes": codes, "min": mn, "scale": sc}

    def unpack(self, payload, shape, dtype=torch.bfloat16):
        n = _flat_n(shape)
        if "codes4" in payload:
            m = payload["codes4"].shape[0]
            flat = unpack4_wire(payload["codes4"], payload["min"].expand(m),
                                payload["scale"].expand(m), n)
        else:
            flat = dequantize_kbit(payload["codes"],
                                   _stat_column(payload["min"]),
                                   _stat_column(payload["scale"]))
        return flat.reshape(shape).to(dtype)

    def wire_bytes_per_elem(self, n, elem_bytes: int = 2,
                            k_frac: float = 1.0) -> float:
        return self.bits / 8.0


class TopKCodec(WireCodec):
    """(values, indices) of the largest-|.| k_frac entries per example.
    Values ride as bf16; indices are uint16 when n <= 65536, else int32."""

    name = "topk"

    def payload_keysets(self):
        return (("idx", "vals"),)

    def pack(self, x, k_frac: float = 0.1, per_request: bool = False):
        flat = x.reshape(x.shape[0], -1)
        n = flat.shape[1]
        vals, idx = topk_select_wire(flat, topk_count(k_frac, n))
        if n <= _U16_MAX_N:
            idx = idx.to(torch.uint16)
        return {"vals": vals.to(torch.bfloat16), "idx": idx}

    def unpack(self, payload, shape, dtype=torch.bfloat16):
        idx = payload["idx"].to(torch.int32)
        return topk_scatter(payload["vals"].to(torch.float32), idx, shape,
                            torch.float32).to(dtype)

    def wire_bytes_per_elem(self, n, elem_bytes: int = 2,
                            k_frac: float = 0.1) -> float:
        idx_bytes = 2 if n <= _U16_MAX_N else 4
        return k_frac * (elem_bytes + idx_bytes)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, WireCodec] = {}

# frozenset(payload keys) -> codec name: the unpack_payload dispatch table.
_PAYLOAD_KEYSETS: Dict[frozenset, str] = {}


def register_codec(codec: WireCodec) -> WireCodec:
    _REGISTRY[codec.name] = codec
    for keys in codec.payload_keysets():
        ks = frozenset(keys)
        owner = _PAYLOAD_KEYSETS.get(ks)
        if owner is not None and owner != codec.name:
            raise ValueError(f"payload key set {sorted(ks)} already "
                             f"registered to codec {owner!r}")
        _PAYLOAD_KEYSETS[ks] = codec.name
    return codec


def get_codec(name: str) -> WireCodec:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown wire scheme {name!r}; "
                         f"registered: {sorted(_REGISTRY)}") from None


def registered_codecs() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


register_codec(NoneCodec())
register_codec(QuantCodec(8))
register_codec(QuantCodec(4))
register_codec(TopKCodec())


def codec_for(comp: Compressor) -> WireCodec:
    """The wire codec realizing a :class:`Compressor` on the network."""
    if comp.kind == "none":
        return get_codec("none")
    if comp.kind == "quant":
        if comp.bits not in (4, 8):
            raise ValueError(f"no wire codec for {comp.bits}-bit quantization"
                             " (registered: q4, q8)")
        return get_codec(f"q{comp.bits}")
    if comp.kind == "topk":
        return get_codec("topk")
    raise ValueError(f"no wire codec for compressor kind {comp.kind!r}")


def pack_payload(x: torch.Tensor, scheme: str, k_frac: float = 0.1) -> dict:
    """x: (B, ...) stage output -> wire payload."""
    return get_codec(scheme).pack(x, k_frac)


def unpack_payload(payload: dict, shape, dtype=torch.bfloat16):
    """Inverse of :func:`pack_payload`: dispatches on the payload's EXACT
    key set, registered per codec via ``payload_keysets()``."""
    name = _PAYLOAD_KEYSETS.get(frozenset(payload))
    if name is None:
        known = sorted(sorted(ks) for ks in _PAYLOAD_KEYSETS)
        raise ValueError(f"payload keys {sorted(payload)} match no "
                         f"registered codec wire format; known: {known}")
    return get_codec(name).unpack(payload, shape, dtype)


def wire_bytes(payload: dict) -> int:
    """Actual bytes-on-wire of a packed payload."""
    return sum(t.numel() * t.element_size() for t in payload.values())
