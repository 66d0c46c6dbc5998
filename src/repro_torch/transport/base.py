"""The transport interface: what crosses a pipeline-stage cut, both ways.

Port of ``repro/transport/base.py``.  A :class:`Transport` realizes ONE
boundary of a :class:`~repro_torch.core.policy.CompressionPolicy`:

  ``fw(x, fw_state, ids) -> (message, new_fw_state, ctx)``
      the forward activation crossing the cut; ``ctx`` carries what the
      backward direction needs (the forward TopK mask for
      ``reuse_indices``).
  ``bw(g, bw_state, ctx) -> (grad_message, new_bw_state)``
      the backward activation-gradient crossing the cut.

:class:`~repro_torch.transport.simulated.SimulatedTransport` implements
it (a compress-decompress round trip in one program).
:class:`~repro_torch.transport.pipeline.PipelineTransport` (packed wire
payloads both ways) shares the codec helpers below; its hops are
``fw_hop`` / ``bw_hop`` of one cut of the schedule, with the feedback
buffers addressed by the cut.
"""
from __future__ import annotations

from typing import Optional, Tuple

from repro_torch.core.policy import BoundaryPolicy
from repro_torch.transport.codecs import WireCodec, codec_for


class Transport:
    """One stage cut: a forward and a backward wire direction."""

    policy: BoundaryPolicy

    def fw(self, x, fw_state=None, ids=None):
        raise NotImplementedError

    def bw(self, g, bw_state=None, ctx=None):
        raise NotImplementedError

    def fw_codec(self) -> Optional[WireCodec]:
        try:
            return codec_for(self.policy.fw)
        except ValueError:
            return None

    def bw_codec(self) -> Optional[WireCodec]:
        try:
            return codec_for(self.policy.bw)
        except ValueError:
            return None

    def wire_bytes_per_example(self, n: int, elem_bytes: int = 2
                               ) -> Tuple[float, float]:
        """(fw, bw) modelled bytes for one example's boundary tensor of
        ``n`` flattened elements (excluding per-tensor scale overhead)."""
        fw_c, bw_c = self.fw_codec(), self.bw_codec()
        fw = (fw_c.wire_bytes_per_elem(n, elem_bytes, self.policy.fw.k_frac)
              * n if fw_c else float("nan"))
        if self.policy.reuse_indices and bw_c is not None:
            # the indices already live at both ends after the forward send:
            # the backward payload is values only, as many as the forward
            # pack kept
            bw = self.policy.fw.k_frac * n * elem_bytes
        else:
            bw = (bw_c.wire_bytes_per_elem(n, elem_bytes,
                                           self.policy.bw.k_frac) * n
                  if bw_c else float("nan"))
        return fw, bw
