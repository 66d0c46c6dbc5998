"""Wire codecs: the byte formats a stage boundary actually sends.

Port of ``repro/transport/codecs.py``.  One codec = one wire scheme:
``pack`` maps a boundary tensor ``(B, ...)`` to a payload dict of tensors,
``unpack`` inverts it given the original shape, and ``payload_struct``
gives the payload's leaf shapes and dtypes from the input shape alone.

  * ``none`` — raw bf16                            (2    bytes/elem)
  * ``q8``   — uint8 codes + min/scale             (1    byte/elem)
  * ``q4``   — two 4-bit codes packed per uint8    (0.5  byte/elem)
  * ``topk`` — (bf16 values, uint16/int32 indices) (k*(2+idx) bytes/elem)

Quantization stats are per tensor, as in the reference — or, with
``per_request=True``, one (min, scale) per row of the ``(B, ...)`` tensor:
each row then carries exactly the payload the reference's
``jax.vmap``-per-request pack gives it (core/boundary.py).  ``unpack``
reads either form from the shape of ``min``.  TopK is per example in both.
On the pipeline (``per_request=False``) q8 packs into the per-tile wire
format ``{"codes", "tile_meta"}`` through ``kernels/quantize.py::
quantize_wire`` whenever ``kernels/tiling.wire_tiling`` fits the flattened
shape (8 rows or more), as the reference does on its accelerator; other
shapes keep the per-tensor format.

q4 packs through ``kernels/pack4.py`` and TopK selects through
``kernels/topk_select.py`` (CUDA kernels on the card, plain versions on the
CPU).  The TopK unpack scatter and the q8 dequantizations are torch ops,
as the reference leaves them to XLA.

``fuse_payload`` / ``unfuse_payload`` frame a payload into ONE contiguous
uint8 hop buffer and back (the fused hops of the 1f1b and interleaved
schedules, and each replica's buffer of the DP gradient reduce), through
``kernels/framing.py`` for payloads of two or more leaves.  Leaves go in
``jax.tree.leaves`` order: dict keys sorted, lists in order, nesting
depth first.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.core.compressors import (Compressor, dequantize_kbit,
                                          quantize_kbit, topk_count,
                                          topk_scatter)
from repro_torch.kernels.framing import frame_parts, unframe_parts
from repro_torch.kernels.pack4 import (minmax_scale, pack4_wire,
                                      unpack4_wire)
from repro_torch.kernels.quantize import dequantize_wire, quantize_wire
from repro_torch.kernels.tiling import wire_tiling
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


class LeafStruct(NamedTuple):
    """Shape and dtype of one payload leaf (``jax.ShapeDtypeStruct``)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


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

    def payload_struct(self, shape, k_frac: float = 1.0) -> dict:
        """The leaves' :class:`LeafStruct` of ``pack(x, k_frac)`` for an x
        of ``shape``, worked out without packing."""
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

    def payload_struct(self, shape, k_frac: float = 1.0):
        return {"raw": LeafStruct(tuple(shape), torch.bfloat16)}

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
        return (("codes", "min", "scale"),      # per-tensor format
                ("codes", "tile_meta"))         # per-tile wire format

    def pack(self, x, k_frac: float = 1.0, per_request: bool = False):
        flat = x.reshape(x.shape[0], -1)
        tiling = wire_tiling(flat.shape)
        if self.bits == 8 and not per_request and tiling is not None:
            # the kernel reads bf16 directly; the reference casts to f32
            # first, which is exact
            codes, meta = quantize_wire(flat, 8, block=tiling)
            return {"codes": codes, "tile_meta": meta}
        flat = flat.to(torch.float32)
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
        elif "tile_meta" in payload:
            codes, meta = payload["codes"], payload["tile_meta"]
            gm, gn = meta.shape[0], meta.shape[1] // 2
            block = (codes.shape[0] // gm, codes.shape[1] // gn)
            flat = dequantize_wire(codes, meta, torch.float32, block=block)
        else:
            flat = dequantize_kbit(payload["codes"],
                                   _stat_column(payload["min"]),
                                   _stat_column(payload["scale"]))
        return flat.reshape(shape).to(dtype)

    def payload_struct(self, shape, k_frac: float = 1.0):
        b, n = shape[0], _flat_n(shape)
        scalar = LeafStruct((), torch.float32)
        if self.bits == 4:
            return {"codes4": LeafStruct((b, (n + 1) // 2), torch.uint8),
                    "min": scalar, "scale": scalar}
        codes = LeafStruct((b, n), torch.uint8)
        tiling = wire_tiling((b, n))
        if tiling is None:
            return {"codes": codes, "min": scalar, "scale": scalar}
        meta = (b // tiling[0], 2 * (n // tiling[1]))
        return {"codes": codes, "tile_meta": LeafStruct(meta, torch.float32)}

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

    def payload_struct(self, shape, k_frac: float = 0.1):
        b, n = shape[0], _flat_n(shape)
        k = topk_count(k_frac, n)
        idx = torch.uint16 if n <= _U16_MAX_N else torch.int32
        return {"idx": LeafStruct((b, k), idx),
                "vals": LeafStruct((b, k), torch.bfloat16)}

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


def payload_leaves(payload) -> list:
    """The leaves of a (nested) payload in ``jax.tree.leaves`` order: dict
    keys sorted, lists in order (the DP reduce's one payload per
    parameter leaf), nesting depth first."""
    if isinstance(payload, dict):
        return [leaf for k in sorted(payload)
                for leaf in payload_leaves(payload[k])]
    if isinstance(payload, list):
        return [leaf for p in payload for leaf in payload_leaves(p)]
    return [payload]


def tree_unflatten(struct, leaves):
    """Rebuild ``struct``'s nesting around an iterator over its leaves in
    :func:`payload_leaves` order (the inverse of ``payload_leaves``)."""
    if isinstance(struct, dict):
        return {k: tree_unflatten(struct[k], leaves) for k in sorted(struct)}
    if isinstance(struct, list):
        return [tree_unflatten(s, leaves) for s in struct]
    return next(leaves)


def payload_struct(payload):
    """The :class:`LeafStruct` tree of a packed payload."""
    if isinstance(payload, dict):
        return {k: payload_struct(v) for k, v in payload.items()}
    if isinstance(payload, list):
        return [payload_struct(p) for p in payload]
    return LeafStruct(tuple(payload.shape), payload.dtype)


def _leaf_nbytes(leaf) -> int:
    nb = leaf.dtype.itemsize
    for dim in leaf.shape:
        nb *= dim
    return nb


def wire_bytes(payload) -> int:
    """Bytes-on-wire of a packed payload, nested or not, its leaves given
    as tensors or as :class:`LeafStruct` tuples."""
    return sum(_leaf_nbytes(leaf) for leaf in payload_leaves(payload))


# ---------------------------------------------------------------------------
# Payload fusion: one contiguous byte buffer per hop
# ---------------------------------------------------------------------------

def _leaf_bytes(a: torch.Tensor) -> torch.Tensor:
    """A leaf's bytes as a flat uint8 tensor (a view where it can be)."""
    flat = a.contiguous().reshape(-1)
    return flat.to(torch.uint8) if a.dtype == torch.bool \
        else flat.view(torch.uint8)


def _bytes_to_leaf(seg: torch.Tensor, s: LeafStruct) -> torch.Tensor:
    """Flat uint8 segment -> tensor of the leaf's shape and dtype (the
    inverse of :func:`_leaf_bytes`).  ``seg`` must start at a storage
    offset that is a multiple of the item size; ``unframe_parts`` gives
    every segment its own allocation."""
    if s.dtype == torch.bool:
        return seg.to(torch.bool).reshape(s.shape)
    return seg.view(s.dtype).reshape(s.shape)


def fuse_payload(payload) -> torch.Tensor:
    """Flatten a packed payload into one contiguous uint8 hop buffer:
    byte-identical to concatenating its leaves' bytes in
    :func:`payload_leaves` order.  A one-leaf payload is that leaf's bytes
    as they are; two or more go through ``frame_parts``."""
    parts = [_leaf_bytes(a) for a in payload_leaves(payload)]
    if not parts:
        return torch.zeros((0,), dtype=torch.uint8)
    if len(parts) == 1:
        return parts[0]
    return frame_parts(parts)


def unfuse_payload(buf: torch.Tensor, struct):
    """Inverse of :func:`fuse_payload` given the payload's
    :class:`LeafStruct` tree (``payload_struct`` of the pack, or a codec's
    ``payload_struct``)."""
    leaves = payload_leaves(struct)
    sizes = [_leaf_nbytes(s) for s in leaves]
    segs = unframe_parts(buf, sizes) if len(leaves) > 1 else [buf]
    return tree_unflatten(struct, iter([_bytes_to_leaf(seg, s)
                                     for seg, s in zip(segs, leaves)]))
