#!/usr/bin/env python3
"""Times the kernels of several checkouts of this repository on one card,
in turns.

    python3 chip_cut_pair.py [--groups cut,wire,q4] OLD NEW NEW OLD

Each argument is the root of a checkout (``.`` for this one); each runs in
a process of its own, in the order given, with that checkout's kernels
(built from its ``src/repro_torch/csrc``) and wrappers, and this
checkout's measurement (``chip_smoke.py``'s timing: device time a call by
torch.profiler, device ops a call, the plain version's and the library
yardstick's time), so that only the kernels differ:

  cut   the training cut's kernels (``quant_dequant``, ``topk_block``) on
        the cut (8, 128*768) from a seeded generator, in bf16 and f32;
  wire  ``quantize_wire`` at the pipeline hop (8, 128*768) in bf16 and
        f32, the framing pair on the hop's payload (786,432 + 384 B) and
        on the q8, q4, TopK and raw DP gradient payloads of gpt2-small,
        and ``decode_sum_fused`` at dp = 4 on the q8 and q4 payloads:
        ``chip_smoke.py`` phase 2's inputs.
  q4    the q4 pair (``pack4_wire``, ``unpack4_wire``) on the 38.6
        M-element DP leaf and every other distinct leaf size of
        gpt2-small, at the pipeline hop (8, 128*768) f32 with the codec's
        expanded per-tensor pair, at serving prefill (4, 64*768) and
        decode (4, 768) with per-row statistics, and over a whole DP lane
        (the 13 leaves in turn, one row).

``--groups`` picks some of them (default: all three).  Prints the card's
name and power limit, then one JSON line a (checkout, shape, kernel).
Needs a CUDA card and nvcc; torch only.
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


GROUPS = ("cut", "wire", "q4")


def time_one(root: Path, groups) -> None:
    sys.path.insert(0, str(root / "src"))
    import torch
    from repro_torch import device as D
    from repro_torch.kernels import _build, framing, ops, pack4, quantize
    from repro_torch.kernels import tiling
    from repro_torch.transport import codecs, collectives
    assert Path(_build.__file__).resolve().is_relative_to(root.resolve())
    import chip_smoke as smoke   # this checkout's, beside this script
    torch.use_deterministic_algorithms(True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    _build.build()
    gen = torch.Generator(device="cuda").manual_seed(1)
    if "cut" in groups:
        x = torch.randn(smoke.CUT_SHAPE, generator=gen, device="cuda")
        for dtype in (torch.bfloat16, torch.float32):
            emit(root, f"cut {tuple(x.shape)} {dtype}",
                 smoke.time_cut_kernels(torch, D, ops, x.to(dtype)))
    shapes, dtypes = smoke.gpt2_leaves(torch)
    if "wire" in groups:
        for label, rows in smoke.time_wire_kernels(
                torch, D, quantize, framing, codecs, tiling).items():
            emit(root, label, rows)
        timed = smoke.time_dp_kernels(torch, D, codecs, collectives,
                                      framing, shapes, dtypes)
        for label, rows in timed.items():
            emit(root, label, {"decode_sum_fused": rows} if "ms" in rows
                 else rows)
    if "q4" in groups:
        inputs = smoke.kernel_inputs(torch)
        for label in (smoke.PREFILL, smoke.DECODE):
            emit(root, label, smoke.time_pack4(torch, D, pack4,
                                               inputs[label]))
        del inputs
        for label, rows in smoke.q4_phase(torch, D, pack4, shapes).items():
            emit(root, label, rows)


def main(argv) -> int:
    if argv[:1] == ["--one"]:
        time_one(Path(argv[1]), argv[2].split(","))
        return 0
    groups = GROUPS
    if argv[:1] == ["--groups"]:
        groups, argv = argv[1].split(","), argv[2:]
        if not set(groups) <= set(GROUPS):
            print(f"groups: {GROUPS}", file=sys.stderr)
            return 1
    import torch
    if not argv or not torch.cuda.is_available():
        print(__doc__ if not argv else "no CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    for root in argv:
        subprocess.run([sys.executable, __file__, "--one", root,
                        ",".join(groups)], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
