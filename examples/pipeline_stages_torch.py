"""Real pipeline parallelism with compressed stage handoffs, on the
PyTorch port (beyond-paper).

The torch counterpart of ``examples/pipeline_stages.py``: a 4-stage
pipeline whose stages run as lanes of the one card (the reference forces
4 host devices), streaming microbatches through it with the boundary
payload PACKED on the wire (bf16 raw / int8 quant / 4-bit packed / TopK
values+indices).  Prints the measured bytes-per-boundary of each scheme
and the pipelined result's error against the sequential forward, then
demos the pluggable schedules (``repro_torch.transport.schedules``):
1F1B (fused single-buffer hops, rematerialized ticks) and interleaved
virtual stages (each lane runs 2 round-robin stage slices: 1/v the fill
bubble, v*S-1 compressed cuts).  Runs on the card unless given
``--device cpu``.

Run:  PYTHONPATH=src python examples/pipeline_stages_torch.py
"""
import argparse

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.transport.codecs import pack_payload, wire_bytes
from repro_torch.transport.pipeline import SCHEME_POLICIES, pipeline_apply
from repro_torch.transport.schedules import get_schedule

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None, help="default: cuda")
dev = resolve_device(ap.parse_args().device)

S, B, D = 4, 8, 256
gen = torch.Generator(device=dev).manual_seed(0)
x = torch.randn((B, D), generator=gen, device=dev)

# 4 stages, each an MLP block; stage s holds slice s of the stacked params.
w1 = torch.randn((S, D, 4 * D), generator=gen, device=dev) * (1.0 / D) ** 0.5
w2 = torch.randn((S, 4 * D, D), generator=gen, device=dev) \
    * (1.0 / (4 * D)) ** 0.5
params = {"w1": w1, "w2": w2}


def stage_fn(p, h):
    return h + F.gelu(h @ p["w1"], approximate="tanh") @ p["w2"]


def forward(params, scheme, k=0.1, **kw):
    out, _, _ = pipeline_apply(stage_fn, params, x, num_stages=S,
                               policy=SCHEME_POLICIES[scheme](k), **kw)
    return out


def rel_err(out):
    return float((out - ref).abs().max() / ref.abs().max())


# sequential reference
ref = x
for s in range(S):
    ref = stage_fn({k: v[s] for k, v in params.items()}, ref)

print(f"pipeline over {S} stage lanes on {dev} — payload schemes:")
with torch.no_grad():
    for scheme, k in [("none", 0.1), ("q8", 0.1), ("q4", 0.1),
                      ("topk", 0.1)]:
        err = rel_err(forward(params, scheme, k))
        mb = wire_bytes(pack_payload(ref[: B // S], scheme, k))
        raw = ref[: B // S].numel() * 2
        print(f"  {scheme:5s}: bytes/boundary {mb:7d} "
              f"({raw / mb:4.1f}x vs bf16)  rel-err vs sequential {err:.3f}")
    print("-> 'none' must be ~exact; q8 tight; q4/topk lossy by design")

    # --- pluggable schedules -------------------------------------------
    print("\nschedules (mb=8 microbatches on 4 stages):")
    out_1f1b = forward(params, "q8", microbatches=8, schedule="1f1b")
    print(f"  1f1b       : {get_schedule('1f1b').describe(8, 4)}  "
          f"rel-err {rel_err(out_1f1b):.3f}")

    # interleaved: 8 LOGICAL stage slices (2 per lane, round-robin).  To
    # keep the same total model as the 4-stage reference, interleave the
    # 4 real slices with 4 IDENTITY slices (zero-weight residual MLPs):
    # logical order [real0, id, real1, id, real2, id, real3, id].
    order = torch.tensor([0, 4, 1, 5, 2, 6, 3, 7], device=dev)
    params8 = {k: torch.cat([v, torch.zeros_like(v)])[order]
               for k, v in params.items()}
    out_il = forward(params8, "q8", microbatches=8, schedule="interleaved",
                     virtual_stages=2)
    print(f"  interleaved: {get_schedule('interleaved', 2).describe(8, 4)}  "
          f"rel-err {rel_err(out_il):.3f}")
print("-> interleaved shrinks the fill bubble by 1/v and multiplies the "
      "compressed cuts — the regime where the codecs pay off")
