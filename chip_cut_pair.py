#!/usr/bin/env python3
"""Times the kernels of several checkouts of this repository on one card,
in turns.

    python3 chip_cut_pair.py OLD NEW NEW OLD

Each argument is the root of a checkout (``.`` for this one); each runs in
a process of its own, in the order given, with that checkout's kernels
(built from its ``src/repro_torch/csrc``) and wrappers, and this
checkout's measurement (``chip_smoke.py``'s timing: device time a call by
torch.profiler, device ops a call, the plain version's and the library
yardstick's time), so that only the kernels differ:

  cut   the training cut's kernels (``quant_dequant``, ``topk_block``) on
        the cut (8, 128*768) from a seeded generator, in bf16 and f32;
  wire  ``quantize_wire`` and the framing pair at the pipeline hop
        (786,432 + 384 B), the framing pair on the q8, q4, TopK and raw DP
        gradient payloads of gpt2-small, and ``decode_sum_fused`` at
        dp = 4 on the q8 and q4 payloads: ``chip_smoke.py`` phase 2's
        inputs.

Prints the card's name and power limit, then one JSON line a (checkout,
shape, kernel).  Needs a CUDA card and nvcc; torch only.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path


def emit(root, shape, rows):
    for name, row in rows.items():
        print(json.dumps({"tree": str(root), "shape": shape, "kernel": name,
                          **row}), flush=True)


def time_one(root: Path) -> None:
    sys.path.insert(0, str(root / "src"))
    import torch
    from repro_torch import device as D
    from repro_torch.kernels import _build, framing, ops, quantize, tiling
    from repro_torch.transport import codecs, collectives
    assert Path(_build.__file__).resolve().is_relative_to(root.resolve())
    import chip_smoke as smoke   # this checkout's, beside this script
    torch.use_deterministic_algorithms(True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    _build.build()
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(smoke.CUT_SHAPE, generator=gen, device="cuda")
    for dtype in (torch.bfloat16, torch.float32):
        emit(root, f"cut {tuple(x.shape)} {dtype}",
             smoke.time_cut_kernels(torch, D, ops, x.to(dtype)))
    rows = smoke.time_wire_kernels(torch, D, quantize, framing, codecs,
                                   tiling)
    emit(root, smoke.WIRE, {"quantize_wire": rows.pop("quantize_wire")})
    emit(root, smoke.FRAMED, rows)
    shapes, dtypes = smoke.gpt2_leaves(torch)
    timed = smoke.time_dp_kernels(torch, D, codecs, collectives, framing,
                                  shapes, dtypes)
    for label, rows in timed.items():
        emit(root, label, {"decode_sum_fused": rows} if "ms" in rows
             else rows)


def main(argv) -> int:
    if argv[:1] == ["--one"]:
        time_one(Path(argv[1]))
        return 0
    import torch
    if not argv or not torch.cuda.is_available():
        print(__doc__ if not argv else "no CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    for root in argv:
        subprocess.run([sys.executable, __file__, "--one", root], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
