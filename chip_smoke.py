#!/usr/bin/env python3
"""On-card smoke test of the PyTorch / H100 port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card and nvcc; exits non-zero, printing no result, without
them or outside a checkout of the repository.  Phases, in order, every
failure fatal:

  1. card name and power limit (nvidia-smi); build every ``csrc/*.cu``
     (one nvcc per source, all started together).  Deterministic
     algorithms are on for the whole run.
  2. every kernel against its plain PyTorch version on the card, bit-exact
     (float outputs compared as integer bits, so NaN and -0.0 count), at
     the serving, training and pipeline shapes and edge cases (the
     training cut's kernels also at batch 256, on a fallback tile wider
     than 2048, and on the cut holding a NaN, a +inf and a -inf; the
     TopK select also on a pipeline microbatch, ties across its chunks,
     zeros and -0.0, and every gradient leaf of a DP lane as (1, n) f32,
     timed at the serving shapes, the microbatch, the two largest leaves
     and the whole lane; the q8 wire quantizer at a full-width
     microbatch in bf16 and f32, a 256-row microbatch (a (256, 2048)
     tile, read twice) and a NaN of its own payload bits in the first
     and the last block of a tile's cluster (the meta keeps those bits;
     a NaN tile's codes 0); framing of
     the q4, q8-tiled, TopK and EF-mixed payloads of one and of odd-sized
     leaves, and of the 39-segment q8 / q4, the 26-segment TopK and the
     13-segment raw DP gradient payloads, one launch a call; the DP
     decode + sum at dp 1, 3 and 4, q8 and q4, on the full-width
     gpt2-small gradient payload and on a ragged tree with misaligned
     meta and a constant leaf, also against the unfused loop); then, at
     the main paths' shapes, device time per call (torch.profiler) of the
     kernel, of its plain version and of the one torch call computing the
     same function, beside the bytes-or-operations bound, with the device
     ops a call (a row whose profiles lost records is printed as LOST):
     the cut's kernels in bf16 and f32; the q8 wire quantizer at the
     pipeline hop in bf16 and f32; the q4 pack pair at serving
     prefill and decode, at the pipeline hop with the codec's expanded
     per-tensor pair (one device op a call), on each distinct gradient
     leaf size and over a whole DP lane (13 leaves in turn, one row;
     checked bit-exact on every leaf, the hop and its edge cases: odd n
     and h, views at element and byte offsets 1-3, many short rows, exact
     ties, NaN and +-inf, constant rows), the decode at dp = 4 on the q8
     and q4 payloads, and the framing pair on the four DP payloads as
     well as at their serving and pipeline shapes.
  3. serve full-width gpt2-small (random weights from a seeded generator)
     with ``ServeEngine`` under the policies none, q4q8 and top10, launch
     counters set to 0 just before and read just after: each compressed
     policy must launch its kernels, and the plain backend on the card
     must give the same tokens.  The smoke model's prefill logits on the
     card must agree with the CPU path's (which the CPU tests hold to the
     JAX package).  Prefill / decode tokens/s from ``throughput_probe``.
  4. train full-width gpt2-small through the simulated stage cuts (batch
     8, seq 128, 4 stages, the launch/train AdamW) for 4 steps under
     none, q4q8, top10, top10reuse and AQ-SGD, launch counters set to 0
     just before and read just after: exact launches per step, finite
     and falling losses, the same losses under the plain backend; eval
     with compression on and off; one step of the smoke model on the
     card against the CPU; tokens/s and a profile of one step per policy.
  5. train full-width gpt2-small through the real compressed pipeline
     (batch 32, seq 128, 4 stages of 3 layer groups, 4 microbatches of 8,
     the launch/train AdamW) for 3 steps: gpipe under none, q4q8, top10,
     top10reuse, ef21top10 and AQ-SGD (64 samples: step 3 revisits step
     1's buffer rows), 1f1b under q4q8 and AQ-SGD, interleaved (2 stages x
     2 virtual) under q4q8; launch counters set to 0 just before and read
     just after.  Holds exact launches per step (12 hops per direction),
     the bytes counted at the hops == ``wire_telemetry`` x hops, 1f1b ==
     gpipe bitwise (losses and params), the same losses under the plain
     backend, falling losses, and the smoke model's pipeline step on the
     card against the CPU; tokens/s per run and a profile of one step per
     schedule.
  6. train full-width gpt2-small data-parallel on the simulated transport
     (dp = 4 lanes of 8, global batch 32, seq 128, 4 stages, the
     launch/train AdamW) for 3 steps with the compressed gradient
     all-reduce, as (DP codec, DP feedback, cut policy): (none, none,
     q4q8), (q8, none, q4q8), (q4, none, q4q8), (q8, ef, q4q8), (q4, ef21,
     q4q8), (topk 0.1, none, q4q8) and (q8, none, AQ-SGD + TopK 10%) with
     ``synthetic_stream(dp=4)``'s ids; launch counters set to 0 just before
     and read just after.  Holds exact launches per step (one
     ``decode_sum_fused`` per q8/q4 step, one framing launch a replica's
     payload), the ring's bytes ==
     ``dp_wire_report`` x dp(dp-1) hops, falling losses, the same losses
     under the plain backend, and the smoke model's DP step on the card
     against the CPU; tokens/s and the reduce's share of the step (CUDA
     events) per run, a profile of one step.
  7. one ``{"kernels": [...]}`` line (launches summed over phases 3-6;
     the select kernels timed at the 38.6 M-element DP leaf), then the
     ``{"ok": true, ...}`` line.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3 (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12        # H100 SXM float32 rate outside the tensor cores
BATCH = 4
D_MODEL = 768                 # gpt2-small
PROMPT_LENS = (64, 17, 40, 5)  # mixed-length static batch, longest 64
NEW_TOKENS = 16
MAX_SEQ = 256
POLICY_KERNELS = {"none": (), "q4q8": ("pack4_wire", "unpack4_wire"),
                  "top10": ("topk_threshold", "topk_compact")}
LOGIT_ATOL = 0.03             # bf16 logits, card vs CPU (tests/test_torch_serve.py)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 128, 4
AQSGD_SAMPLES = 16            # steps 3-4 revisit the rows steps 1-2 wrote
# policy -> (launch/train --policy, --feedback), the kernel its cuts
# launch, launches per train step (3 cuts; top10reuse masks the gradient
# with the forward's exact TopK, so only its 3 forward cuts launch)
TRAIN_POLICIES = {"none": (("none", "none"), None, 0),
                  "q4q8": (("q4q8", "none"), "quant_dequant", 6),
                  "top10": (("top10", "none"), "topk_block", 6),
                  "top10reuse": (("top10reuse", "none"), "topk_block", 3),
                  "aqsgd": (("none", "aqsgd"), "topk_block", 6)}
LOSS_ATOL = 2e-3              # smoke-model loss, card vs CPU (tests/test_torch_train.py)
CUT_SHAPE = (TRAIN_BATCH, TRAIN_SEQ * D_MODEL)
KERNELS = {   # name -> (source, the TPU kernel it replaces)
    "topk_threshold": ("src/repro_torch/csrc/topk_select.cu",
                       "src/repro/kernels/topk_select.py:58"),
    "topk_compact": ("src/repro_torch/csrc/topk_select.cu",
                     "src/repro/kernels/topk_select.py:68"),
    "pack4_wire": ("src/repro_torch/csrc/pack4.cu",
                   "src/repro/kernels/pack4.py:82"),
    "unpack4_wire": ("src/repro_torch/csrc/pack4.cu",
                     "src/repro/kernels/pack4.py:107"),
    "quant_dequant": ("src/repro_torch/csrc/quantize.cu",
                      "src/repro/kernels/quantize.py:58"),
    "topk_block": ("src/repro_torch/csrc/topk_mask.cu",
                   "src/repro/kernels/topk_mask.py:55"),
    "quantize_wire": ("src/repro_torch/csrc/quantize.cu",
                      "src/repro/kernels/quantize.py:80"),
    "frame_parts": ("src/repro_torch/csrc/framing.cu",
                    "src/repro/kernels/framing.py:61"),
    "unframe_parts": ("src/repro_torch/csrc/framing.cu",
                      "src/repro/kernels/framing.py:84"),
    "decode_sum_fused": ("src/repro_torch/csrc/dp_reduce.cu",
                         "src/repro/kernels/dp_reduce.py:148"),
}
SERVE_KERNELS = ("topk_threshold", "topk_compact", "pack4_wire",
                 "unpack4_wire")
SELECT_KERNELS = ("topk_threshold", "topk_compact")
TRAIN_KERNELS = ("quant_dequant", "topk_block")
WIRE_KERNELS = ("quantize_wire", "frame_parts", "unframe_parts")
# the pipeline phase: 4 stages, 4 microbatches of 8 -> 12 hops per
# direction per step (interleaved: 2 stages x 2 virtual, 3 cuts each)
PIPE_BATCH, PIPE_SEQ, PIPE_STEPS, PIPE_MB, PIPE_STAGES = 32, 128, 3, 4, 4
PIPE_SAMPLES = 64             # AQ-SGD: step 3 revisits step 1's rows
PIPE_HOPS = 12
MB_SHAPE = (PIPE_BATCH // PIPE_MB, PIPE_SEQ, D_MODEL)
# bytes of one full-width microbatch's payload
PAYLOAD_BYTES = {"q4": 393224, "q8_tiled": 786816, "top10": 471840,
                 "top10_values": 157280, "none": 1572864}
LM_LOSS_ATOL = 0.02           # compressed smoke loss (tests/test_torch_pipeline.py)


def _per_step(**launches):
    """Expected launches per train step: every kernel 0 but these."""
    return {k: launches.get(k, 0) for k in KERNELS}


_Q4Q8 = dict(pack4_wire=PIPE_HOPS, unpack4_wire=PIPE_HOPS,
             quantize_wire=PIPE_HOPS)
_FRAMED = dict(frame_parts=2 * PIPE_HOPS, unframe_parts=2 * PIPE_HOPS)
_TOPK = dict(topk_threshold=2 * PIPE_HOPS, topk_compact=2 * PIPE_HOPS)
# run -> (launch/train --policy, --feedback, schedule, virtual stages,
#         launches per step, (fw, bw) payload bytes of one microbatch)
PIPE_RUNS = {
    "gpipe/none": ("none", "none", "gpipe", 1, _per_step(),
                   ("none", "none")),
    "gpipe/q4q8": ("q4q8", "none", "gpipe", 1, _per_step(**_Q4Q8),
                   ("q4", "q8_tiled")),
    "gpipe/top10": ("top10", "none", "gpipe", 1, _per_step(**_TOPK),
                    ("top10", "top10")),
    "gpipe/top10reuse": ("top10reuse", "none", "gpipe", 1,
                         _per_step(topk_threshold=PIPE_HOPS,
                                   topk_compact=PIPE_HOPS),
                         ("top10", "top10_values")),
    "gpipe/ef21top10": ("ef21top10", "none", "gpipe", 1,
                        _per_step(**_TOPK), ("top10", "top10")),
    "gpipe/aqsgd": ("none", "aqsgd", "gpipe", 1, _per_step(**_TOPK),
                    ("top10", "top10")),
    "1f1b/q4q8": ("q4q8", "none", "1f1b", 1,
                  _per_step(**_Q4Q8, **_FRAMED), ("q4", "q8_tiled")),
    "1f1b/aqsgd": ("none", "aqsgd", "1f1b", 1,
                   _per_step(**_TOPK, **_FRAMED), ("top10", "top10")),
    "interleaved/q4q8": ("q4q8", "none", "interleaved", 2,
                         _per_step(**_Q4Q8, **_FRAMED), ("q4", "q8_tiled")),
}
MB_ROWS = (PIPE_BATCH // PIPE_MB, PIPE_SEQ * D_MODEL)
WIRE = f"pipeline microbatch {MB_ROWS} bf16"
WIRE32 = f"pipeline microbatch {MB_ROWS} f32"
FRAMED = "q8-tiled backward hop (786432 + 384 B)"
PREFILL = f"prefill ({BATCH}, {max(PROMPT_LENS)}*768)"
DECODE = f"decode ({BATCH}, 768)"
CUT = f"training cut ({TRAIN_BATCH}, {TRAIN_SEQ}*768) bf16"
CUT32 = f"training cut ({TRAIN_BATCH}, {TRAIN_SEQ}*768) f32"
# the TopK DP codec's largest gradient leaves: wte (50257 x 768) and an
# MLP stack (12 x 768 x 3072), one (1, n) f32 row each
SEL_LEAF_N, SEL_LEAF2_N = 38597376, 28311552
SEL_LEAF = f"DP leaf (1, {SEL_LEAF_N}) f32"
SEL_LEAF2 = f"DP leaf (1, {SEL_LEAF2_N}) f32"
SEL_LANE = "DP lane: 13 leaves, each (1, n) f32"
HOP4 = f"pipeline hop {MB_ROWS} f32, the codec's expanded pair"

# the DP phase: 4 lanes of 8 (global batch 32), seq 128, 4 stages (3
# simulated cuts per lane), 13 parameter leaves, Sum n = 123,570,432
DP, DP_BATCH, DP_SEQ, DP_STEPS, DP_STAGES = 4, 32, 128, 3, 4
DP_SAMPLES = 64               # AQ-SGD: 16 rows a lane, step 3 revisits them
LEAVES = 13
# bytes of one replica's fused gradient buffer (one ring hop)
DP_PAYLOAD = {"q8": 123570536, "q4": 61785320, "topk": 74134592,
              "none": 247217664}
_DP = DP * LEAVES             # one pack / select per leaf and replica
_Q_RING = dict(frame_parts=DP, decode_sum_fused=1)   # 39 segments, 1 launch
# run -> (DP codec, DP feedback, k_frac, launch/train --policy,
#         --feedback, launches per step)
DP_RUNS = {
    "none/q4q8": ("none", "none", 0.1, "q4q8", "none",
                  _per_step(quant_dequant=6 * DP, frame_parts=DP,
                            unframe_parts=DP)),
    "q8/q4q8": ("q8", "none", 0.1, "q4q8", "none",
                _per_step(quant_dequant=6 * DP, **_Q_RING)),
    "q4/q4q8": ("q4", "none", 0.1, "q4q8", "none",
                _per_step(quant_dequant=6 * DP, pack4_wire=_DP, **_Q_RING)),
    "q8+ef/q4q8": ("q8", "ef", 0.1, "q4q8", "none",
                   _per_step(quant_dequant=6 * DP, **_Q_RING)),
    "q4+ef21/q4q8": ("q4", "ef21", 0.1, "q4q8", "none",
                     _per_step(quant_dequant=6 * DP, pack4_wire=_DP,
                               unpack4_wire=_DP, **_Q_RING)),
    "topk/q4q8": ("topk", "none", 0.1, "q4q8", "none",
                  _per_step(quant_dequant=6 * DP, topk_threshold=_DP,
                            topk_compact=_DP, frame_parts=DP,
                            unframe_parts=DP)),
    "q8/aqsgd": ("q8", "none", 0.1, "none", "aqsgd",
                 _per_step(topk_block=6 * DP, **_Q_RING)),
}
DP_KERNELS = ("decode_sum_fused",)
DPQ8 = f"DP decode dp={DP} q8, full-width gpt2-small payload"
DPQ4 = f"DP decode dp={DP} q4, full-width gpt2-small payload"
DPF8 = f"q8 DP payload, 39 segments ({DP_PAYLOAD['q8']} B)"
DPF4 = f"q4 DP payload, 39 segments ({DP_PAYLOAD['q4']} B)"
DPFT = f"TopK DP payload, 26 segments ({DP_PAYLOAD['topk']} B)"
DPFN = f"raw DP payload, 13 segments ({DP_PAYLOAD['none']} B)"
# a ragged gradient tree: an odd leaf (misaligned meta), a rank-3 stack,
# a constant leaf (one code) and a leaf of 3 tiles and a bit
RAGGED = [(7,), (5, 33), (2, 3, 17), (6,), (3 * 8192 + 5,)]


def log(*a):
    print(*a, flush=True)



# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def call_ms(torch, fn, iters=50, warm=True):
    """Per-call time of back-to-back calls, CUDA events (host included)."""
    if warm:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_events(prof):
    """(device ms, name) of every kernel / copy on the card in a profile.
    Only device-side events count: a CPU op's self device time repeats
    its kernels' (the rule of torch.profiler's own table total)."""
    from torch.autograd import DeviceType
    return [(ev.self_device_time_total / 1e3, ev.key)
            for ev in prof.key_averages() if ev.device_type == DeviceType.CUDA]


def device_ms(torch, fn, kernel=None, iters=20, warm=True, profiles=1):
    """Device time per call of everything ``fn`` launches (torch.profiler),
    of the kernels whose name contains ``kernel``, the number of device
    ops (kernels, copies, memsets) a call, and whether records were lost.
    Each device op's mean duration counts as many times as it runs a
    call: its records over ``iters``, rounded.  So a few lost or stray
    records change no count: late in a long run CUPTI has dropped the
    first records of a profile (14 of 20 calls seen, which divided by
    ``iters`` understated the time by 30%), and a warm-up cycle before the
    counted one, which makes that rarer, leaves one stray record in it.
    But CUPTI has also dropped most of an op's records (1 device op a
    call recorded of 4), which rounds the op away.  So the call is
    profiled ``profiles`` times and the profile with the most device ops
    a call is kept; while that is fewer than the wrapper launches a call
    (``_build.LAUNCHES``, counted over the profiled calls) it is profiled
    again, up to 3 more times, and is reported lost if still short.  A
    profile that sees no device time counts as short."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    from repro_torch.kernels import _build
    if warm:
        fn()
    torch.cuda.synchronize()
    best, launched = None, 0
    for attempt in range(profiles + 3):
        before = sum(_build.LAUNCHES.values())
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for _ in range(2):
                for _ in range(iters):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        launched = max(launched, round((sum(_build.LAUNCHES.values())
                                        - before) / (2 * iters)))
        total = mine = 0.0
        ops = 0
        for ev in prof.key_averages():
            runs = round(ev.count / iters)
            if ev.device_type != DeviceType.CUDA or not runs:
                continue
            ms = ev.self_device_time_total / 1e3 / ev.count * runs
            total += ms
            mine += ms if kernel and kernel in ev.key else 0.0
            ops += runs
        if total > 0 and (best is None or ops > best[2]):
            best = (total, mine, ops)
        if (attempt + 1 >= profiles and best is not None
                and best[2] >= launched):
            return best + (False,)
    if best is None:
        raise AssertionError(f"torch.profiler saw no device time in "
                             f"{profiles + 3} profiles")
    return best + (True,)


def bound_ms(nbytes, nops):
    """The larger of the bytes the function must move (each input read
    once, each output written once) over HBM's rate, and the float32
    operations it needs over the card's float32 rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def kernel_inputs(torch):
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(m, n):
        return torch.randn((m, n), generator=gen, device="cuda")

    ties = torch.randint(-3, 4, (BATCH, D_MODEL), generator=gen,
                         device="cuda").float()
    # zeros and -0.0 with a few values: the k-th magnitude is a zero
    zeros = torch.zeros((2, 20485), device="cuda")
    zeros[1, ::2] = -0.0
    zeros[:, ::997] = randn(2, 21)
    return {
        DECODE: randn(BATCH, D_MODEL),
        PREFILL: randn(BATCH, max(PROMPT_LENS) * D_MODEL),
        "prefill (1, 128*768)": randn(1, 128 * D_MODEL),
        "odd n (1, 767)": randn(1, 767),
        "constant (4, 768)": torch.full((BATCH, D_MODEL), 3.25,
                                        device="cuda"),
        "heavy ties (4, 768)": ties,
        "int32 index (2, 70001)": randn(2, 70001),
        "heavy ties, many chunks (8, 98304)": torch.randint(
            -3, 4, MB_ROWS, generator=gen, device="cuda").float(),
        "zeros and -0.0 (2, 20485)": zeros,
    }


def kernel_and_plain(torch, D, fn):
    D.KERNEL_BACKEND = "auto"
    got = fn()
    D.KERNEL_BACKEND = "plain"
    try:
        want = fn()
    finally:
        D.KERNEL_BACKEND = "auto"
    torch.cuda.synchronize()
    return got, want


def bits(torch, t):
    """A float tensor's bits as integers (``torch.equal`` fails on NaN and
    takes -0.0 for 0.0); any other tensor as it is."""
    if not t.is_floating_point():
        return t
    return t.view({8: torch.int64, 4: torch.int32,
                   2: torch.int16}[t.element_size()])


def max_err(torch, got, want):
    """0.0 when bit-exact; raises otherwise."""
    for a, b in zip(got, want):
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"{a.shape} {a.dtype} vs {b.shape} {b.dtype}")
        if not torch.equal(bits(torch, a), bits(torch, b)):
            d = (a.double() - b.double()).abs().max().item()
            raise AssertionError(f"kernel not bit-exact: max |diff| {d}")
    return 0.0


def check_select(torch, D, topk, x, k=None):
    """Both select kernels on ``x`` against their plain versions:
    bit-exact, exactly k indices per row, ascending."""
    m, n = x.shape
    k = select_k(n) if k is None else k
    t_k, t_p = kernel_and_plain(torch, D, lambda: topk.topk_threshold(x, k))
    max_err(torch, [t_k], [t_p])
    s_k, s_p = kernel_and_plain(torch, D,
                                lambda: topk.topk_compact(x, t_p, k))
    max_err(torch, s_k, s_p)
    idx = s_k[1]
    assert idx.shape == (m, k) and bool(
        (idx[:, 1:] > idx[:, :-1]).all()), "indices not ascending"


def select_inputs(torch, shapes):
    """The select's main-path tensors beyond serving: a pipeline
    microbatch (bf16, as its hops send it; also in f32) and one DP lane's
    13 gradient leaves of ``shapes``, each (1, n) f32 as
    ``pack_grad_leaf`` passes it."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    mb = torch.randn(MB_ROWS, generator=gen, device="cuda")
    lane = [torch.randn((1, math.prod(s)), generator=gen, device="cuda")
            * 0.01 for s in shapes]
    by_n = {x.shape[1]: x for x in lane}
    return {WIRE: [mb.to(torch.bfloat16)], WIRE32: [mb],
            SEL_LEAF: [by_n[SEL_LEAF_N]], SEL_LEAF2: [by_n[SEL_LEAF2_N]],
            SEL_LANE: lane}


def select_phase(torch, D, topk, inputs, shapes):
    """Phase 2's select part: both kernels bit-exact against their plain
    versions on the serving inputs (bf16 and f32), a pipeline microbatch
    and every gradient leaf of a DP lane, then timed at the serving
    prefill and decode, the microbatch, the two largest leaves and the
    whole lane.  Returns {label: {name: row}}."""
    for label, x32 in inputs.items():
        for dt in (torch.bfloat16, torch.float32):
            check_select(torch, D, topk, x32.to(dt))
        log(f"# select kernels bit-exact vs plain: {label}")
    sel = select_inputs(torch, shapes)
    for label, xs in sel.items():
        for x in xs:
            check_select(torch, D, topk, x)
        log(f"# select kernels bit-exact vs plain: {label}")
    sel[PREFILL] = [inputs[PREFILL].to(torch.bfloat16)]
    sel[DECODE] = [inputs[DECODE].to(torch.bfloat16)]
    timed = {}
    for label in (PREFILL, DECODE, WIRE, SEL_LEAF, SEL_LEAF2, SEL_LANE):
        timed[label] = time_select(torch, D, topk, sel[label])
        for name, row in timed[label].items():
            log(f"# {name} {label}: " + json.dumps(row))
    return timed


def check_kernels(torch, D, pack4, inputs):
    err = dict.fromkeys(SERVE_KERNELS, 0.0)
    for label, x32 in inputs.items():
        got = check_q4(torch, D, pack4, x32, *pack4.minmax_scale(x32))
        for name, e in zip(("pack4_wire", "unpack4_wire"), got):
            err[name] = max(err[name], e)
        log(f"# q4 kernels bit-exact vs plain: {label}")
    return err


def per_tensor_pair(pack4, x):
    """The codec's statistics of ``x`` (``transport/codecs.py``): one
    (min, scale) pair over the tensor, expanded over its rows (stride
    0)."""
    mn, sc = (v.reshape(()) for v in pack4.minmax_scale(x.reshape(1, -1)))
    return mn.expand(x.shape[0]), sc.expand(x.shape[0])


def time_pack4(torch, D, pack4, x32, per_tensor=False):
    """The q4 pair on one f32 tensor or a list of them (a DP lane's
    leaves, one call each in turn), with per-row statistics (serving) or
    the codec's expanded per-tensor pair (the pipeline hop, the DP
    leaves)."""
    xs = x32 if isinstance(x32, list) else [x32]
    stats = [per_tensor_pair(pack4, x) if per_tensor
             else pack4.minmax_scale(x) for x in xs]
    packed = [pack4.pack4_wire_plain(x, mn, sc)
              for x, (mn, sc) in zip(xs, stats)]
    elems = sum(x.numel() for x in xs)
    nbytes = sum(x.numel() * 4 + 8 * (1 if per_tensor else x.shape[0])
                 + p.numel() for x, p in zip(xs, packed))
    return time_cases(torch, D, {
        # (wrapper call, its CUDA kernel's name, library call or None,
        #  bytes the function moves, float32 operations it needs: the
        #  pack sub/div/round/clip and a shift-or per pair, the unpack a
        #  mul and an add)
        "pack4_wire": (lambda: [pack4.pack4_wire(x, mn, sc)
                                for x, (mn, sc) in zip(xs, stats)],
                       "pack4_kernel", None, nbytes, 6 * elems),
        "unpack4_wire": (lambda: [pack4.unpack4_wire(p, mn, sc, x.shape[1])
                                  for x, p, (mn, sc)
                                  in zip(xs, packed, stats)],
                         "unpack4_kernel", None, nbytes, 2 * elems),
    })


def q4_cases(torch, pack4):
    """The q4 pair's edge cases: label -> (x f32, min, scale, the packed
    bytes the unpack reads or None for the plain version's): odd n and odd
    h, x at element offsets 1-3 (rows 4-byte aligned), packed bytes at
    byte offsets 1-3, many short rows, exact ties (min 0, max 7.5, scale
    0.5: every odd element on a half-integer, the IEEE division's
    elements), NaN and +-inf with finite statistics and with their rows'
    own ((NaN, 1), (min, inf), (-inf, inf)), and constant rows."""
    gen = torch.Generator(device="cuda").manual_seed(11)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    def own(x, packed=None):
        return (x, *pack4.minmax_scale(x), packed)
    cases = {f"n = {n} (5, {n})": own(randn(5, n)) for n in (1001, 1002)}
    for off in (1, 2, 3):
        x = randn(3 * 1001 + 3)[off:off + 3 * 1001].view(3, 1001)
        cases[f"x at element offset {off} (3, 1001)"] = own(x)
        y = randn(5, 2006)
        p = pack4.pack4_wire_plain(y, *pack4.minmax_scale(y)).reshape(-1)
        buf = torch.zeros(p.numel() + 3, dtype=torch.uint8, device="cuda")
        buf[off:off + p.numel()] = p
        cases[f"packed at byte offset {off} (5, 1003)"] = own(
            y, buf[off:off + p.numel()].view(5, 1003))
    cases["many short rows (4096, 33)"] = own(randn(4096, 33))
    j = torch.arange(8 * 4096 + 7, device="cuda") % 31
    cases["exact ties (3, 32775)"] = own(
        (j * 0.25).float().reshape(1, -1).repeat(3, 1))
    x = randn(6, 4101)
    x[0, 17] = x[4, 7] = float("nan")
    x[1, 4100] = x[3, 1000] = x[4, 8] = float("inf")
    x[2, 0] = x[3, 1001] = -float("inf")
    clean = torch.nan_to_num(x, nan=0.0, posinf=0.0, neginf=0.0)
    cases["NaN and +-inf, finite statistics (6, 4101)"] = (
        x, *pack4.minmax_scale(clean), None)
    cases["NaN and +-inf, their rows' statistics (6, 4101)"] = own(x)
    const = torch.full((4, 4099), 3.25, device="cuda")
    const[1] = -0.0
    cases["constant rows (4, 4099)"] = own(const)
    return cases


def check_q4(torch, D, pack4, x, mn, sc, packed=None):
    """Both q4 kernels against their plain versions, bit-exact (the
    unpacked floats as integer bits); ``packed`` (default: the plain
    version's bytes) is what the unpack reads.  Returns each kernel's
    max |error| (0.0; raises otherwise)."""
    p_k, p_p = kernel_and_plain(torch, D, lambda: pack4.pack4_wire(x, mn, sc))
    src = p_p if packed is None else packed
    u_k, u_p = kernel_and_plain(
        torch, D, lambda: pack4.unpack4_wire(src, mn, sc, x.shape[1]))
    return max_err(torch, [p_k], [p_p]), max_err(torch, [u_k], [u_p])


def q4_phase(torch, D, pack4, shapes):
    """Phase 2's q4 part beyond serving: the pair bit-exact on its edge
    cases, at the pipeline hop with the codec's expanded pair and on
    every gradient leaf of a DP lane ((1, n) f32, the expanded pair of
    one), then timed at the hop, at each distinct leaf size and over the
    whole lane.  Returns {label: {name: row}}."""
    for label, case in q4_cases(torch, pack4).items():
        check_q4(torch, D, pack4, *case)
        log(f"# q4 kernels bit-exact vs plain: {label}")
    gen = torch.Generator(device="cuda").manual_seed(8)
    hop = torch.randn(MB_ROWS, generator=gen, device="cuda")
    lane = [torch.randn((1, math.prod(s)), generator=gen, device="cuda")
            * 0.01 for s in shapes]
    for label, xs in ((HOP4, [hop]), (SEL_LANE, lane)):
        for x in xs:
            check_q4(torch, D, pack4, x, *per_tensor_pair(pack4, x))
        log(f"# q4 kernels bit-exact vs plain: {label}")
    timed = {HOP4: time_pack4(torch, D, pack4, hop, per_tensor=True)}
    by_n = {x.shape[1]: x for x in lane}
    for n, x in by_n.items():
        label = f"DP leaf (1, {n}) f32"
        timed[label] = time_pack4(torch, D, pack4, x, per_tensor=True)
        for row in timed[label].values():
            row["leaves"] = sum(x.shape[1] == n for x in lane)
    timed[SEL_LANE] = time_pack4(torch, D, pack4, lane, per_tensor=True)
    for label, rows in timed.items():
        for name, row in rows.items():
            log(f"# {name} {label}: " + json.dumps(row))
    return timed


def select_k(n):
    """k of a TopK 10% codec on a row of n (``topk_count(0.1, n)``)."""
    return max(1, int(round(0.1 * n)))


def time_select(torch, D, topk, xs):
    """``topk_threshold`` and ``topk_compact`` over the tensors ``xs``, one
    call each with k = 10% of a row, as the codecs call them (a list of
    (1, n) f32 leaves is one DP lane's select).  Bytes: each input read
    once, the (m, 1) f32 threshold, and the compaction's (m, k) values and
    int32 indices; operations: the threshold one compare per |x| as a
    one-pass select, the compaction two compares and a count.  The
    library yardstick is ``torch.topk`` on magnitudes computed beforehand
    (its values' last column for the threshold)."""
    ks = [select_k(x.shape[1]) for x in xs]
    threshs = [topk.topk_threshold_plain(x, k) for x, k in zip(xs, ks)]
    mags = [x.float().abs() for x in xs]
    read = sum(x.numel() * x.element_size() + 4 * x.shape[0] for x in xs)
    wrote = sum(x.shape[0] * k * (x.element_size() + 4)
                for x, k in zip(xs, ks))
    elems = sum(x.numel() for x in xs)
    return time_cases(torch, D, {
        "topk_threshold": (
            lambda: [topk.topk_threshold(x, k) for x, k in zip(xs, ks)],
            "topk_threshold",
            lambda: [torch.topk(g, k, dim=1).values[:, -1:]
                     for g, k in zip(mags, ks)], read, elems),
        "topk_compact": (
            lambda: [topk.topk_compact(x, t, k)
                     for x, t, k in zip(xs, threshs, ks)],
            "topk_compact",
            lambda: [torch.topk(g, k, dim=1) for g, k in zip(mags, ks)],
            read + wrote, 3 * elems),
    })


def time_cases(torch, D, cases):
    """name -> times and bound of each ``(wrapper call, the name its CUDA
    kernels contain, library call or None, bytes, float32 operations)``,
    the plain version's too.  Calls that take long are timed over fewer
    iterations (the plain compaction takes seconds on a DP leaf)."""
    rows = {}
    for name, (fn, kernel, lib, nbytes, nops) in cases.items():
        it = scaled_iters(torch, fn)
        row = dict(zip(("ms", "kernel_only_ms", "device_ops", "lost"),
                       device_ms(torch, fn, kernel, min(it, 20), warm=False,
                                 profiles=2)))
        row["call_ms"] = call_ms(torch, fn, it, warm=False)
        D.KERNEL_BACKEND = "plain"
        try:
            it = scaled_iters(torch, fn)
            row["plain_ms"], _, _, lost = device_ms(
                torch, fn, iters=min(it, 20), warm=False)
            row["plain_call_ms"] = call_ms(torch, fn, min(it, 10), warm=False)
        finally:
            D.KERNEL_BACKEND = "auto"
        row["library_ms"] = None
        if lib is not None:
            row["library_ms"], _, _, lost_lib = device_ms(
                torch, lib, iters=min(scaled_iters(torch, lib), 20),
                warm=False)
            lost = lost or lost_lib
        row["lost"] = row["lost"] or lost
        row["bound_ms"], row["bound_by"] = bound_ms(nbytes, nops)
        rows[name] = row
    return rows


def scaled_iters(torch, fn, most=50, budget_ms=300.0):
    """Warms ``fn`` up; ``most`` iterations, or as many as fit in
    ``budget_ms`` (at least 1) where one call takes long."""
    return max(1, min(most, int(budget_ms / max(call_ms(torch, fn, 1),
                                                1e-3))))


def cut_inputs(torch):
    """The training cut's tensors: its shape in bf16 and f32, a shorter
    sequence, m = 6 (row tile 2), batch 256 (a (256, 2048) tile), the
    whole-tensor fallback tiles (4, 767) and (2, 5001), a constant, a
    half-zero and a heavily tied tensor, and the cut with a NaN, a +inf
    and a -inf in three tiles, in bf16 and f32."""
    gen = torch.Generator(device="cuda").manual_seed(1)

    def randn(m, n):
        return torch.randn((m, n), generator=gen, device="cuda")

    x = randn(*CUT_SHAPE)
    zero_rows = randn(4, 4096)
    zero_rows[::2] = 0.0
    nonfinite = randn(*CUT_SHAPE)
    nonfinite[0, 5] = float("nan")
    nonfinite[4, 50000] = float("inf")
    nonfinite[7, 98301] = -float("inf")
    bf16 = torch.bfloat16
    return {
        CUT: x.to(bf16),
        CUT32: x,
        "NaN, +inf, -inf in the cut, bf16": nonfinite.to(bf16),
        "NaN, +inf, -inf in the cut, f32": nonfinite,
        "batch 256 (256, 4096) bf16": randn(256, 4096).to(bf16),
        "batch 256 (256, 4096) f32": randn(256, 4096),
        "fallback tile wider than 2048 (2, 5001) bf16":
            randn(2, 5001).to(bf16),
        "(4, 64*768) bf16": randn(4, 64 * D_MODEL).to(bf16),
        "m=6 (6, 4096) bf16": randn(6, 4096).to(bf16),
        "fallback tile (4, 767) bf16": randn(4, 767).to(bf16),
        "fallback tile (4, 767) f32": randn(4, 767),
        "constant (4, 4096) bf16": torch.full((4, 4096), 3.25, device="cuda",
                                              dtype=bf16),
        "all-zero rows (4, 4096) f32": zero_rows,
        "heavy ties (4, 4096) bf16": torch.randint(
            -3, 4, (4, 4096), generator=gen, device="cuda").to(bf16),
    }


def check_cut_kernels(torch, D, ops, inputs):
    """Both training-cut kernels, through the ops layer that picks the
    main path's tiles, against their plain versions: bit-exact."""
    err = dict.fromkeys(TRAIN_KERNELS, 0.0)
    for label, x in inputs.items():
        for bits in (4, 8):
            got, want = kernel_and_plain(
                torch, D, lambda: ops.quant_dequant_op(x, bits))
            err["quant_dequant"] = max(err["quant_dequant"],
                                       max_err(torch, [got], [want]))
        for k_frac in (0.1, 0.3):
            got, want = kernel_and_plain(
                torch, D, lambda: ops.topk_block_op(x, k_frac))
            err["topk_block"] = max(err["topk_block"],
                                    max_err(torch, [got], [want]))
        log(f"# cut kernels bit-exact vs plain: {label}")
    return err


def time_cut_kernels(torch, D, ops, x):
    """Both training-cut kernels at the cut's shape (bf16 or f32).  Each
    function reads x once and writes its output once.  The quantizer
    needs about 9 float32 operations per element (min, max, sub, div,
    round, 2 clamps, mul, add), the TopK mask 3 (abs, compare, select):
    the threshold's select and bisection are the kernel's cost, not the
    function's.  The library
    yardstick of the TopK mask is the EXACT per-(row, tile) k-th largest
    magnitude (``ref.topk_exact_block_ref``'s threshold, not the
    bisection's bits) from ``torch.topk`` on precomputed magnitudes; the
    quantizer has no one-call equivalent."""
    m, n = x.shape
    e = x.element_size()
    bn = 2048                                   # lane_block(128 * 768)
    k = math.ceil(0.1 * bn)
    mag = x.float().abs().view(m * n // bn, bn)
    return time_cases(torch, D, {
        "quant_dequant": (lambda: ops.quant_dequant_op(x, 4),
                          "quant_dequant_kernel", None, 2 * m * n * e,
                          9 * m * n),
        "topk_block": (lambda: ops.topk_block_op(x, 0.1),
                       "topk_block_kernel",
                       lambda: torch.topk(mag, k, dim=1).values[:, -1:],
                       2 * m * n * e, 3 * m * n),
    })


def wire_payload_parts(torch, codecs, x):
    """Flat uint8 leaf segments of the payloads a full-width microbatch
    ``x`` (bf16) sends through the pipeline's fused hops, and odd-sized
    leaves."""
    payloads = {
        "q4": codecs.get_codec("q4").pack(x),
        "q8-tiled": codecs.get_codec("q8").pack(x),
        "top10": codecs.get_codec("topk").pack(x, 0.1),
        "EF-mixed top10": {"x": codecs.get_codec("topk").pack(x, 0.05),
                           "e": codecs.get_codec("topk").pack(-x, 0.05)},
    }
    out = {name: [a.reshape(-1).view(torch.uint8)
                  for a in codecs.payload_leaves(pl)]
           for name, pl in payloads.items()}
    gen = torch.Generator(device="cuda").manual_seed(3)
    out["odd sizes"] = [torch.randint(0, 256, (nb,), generator=gen,
                                      device="cuda", dtype=torch.uint8)
                        for nb in (1, 7, 0, 33, 4097, 2, 16, 15)]
    whole = torch.randint(0, 256, (4098,), generator=gen, device="cuda",
                          dtype=torch.uint8)
    out["misaligned view"] = [whole[1:4097], whole[:5]]
    out["one segment"] = [whole[1:4097]]
    out["one segment and an empty one"] = [whole[:0], whole[:4097]]
    return out


def nan_payload_cases(torch, quantize, tiling, x):
    """The microbatch ``x`` (f32) with a NaN of its own payload bits in the
    first block of the first tile's cluster, in its last block, and one in
    each (the meta keeps the larger bit pattern as a signed integer), in
    bf16 and f32: label -> (tensor, its first tile's meta min's bits)."""
    block = tiling.wire_tiling(tuple(x.shape))
    cases = {}
    for dtype, ints, elem, pay in (
            (torch.float32, torch.int32, 4, (0x7FC00123, 0x7FC00456)),
            (torch.bfloat16, torch.int16, 2, (0x7FC1, 0x7FC3))):
        g = quantize.geometry(x.shape[1], *block, elem, True)
        row_units = block[1] // g.v
        # unit u of a tile is read by block (u // THREADS) % cluster
        at = [max(u for u in range(block[0] * row_units)
                  if u // quantize.THREADS % g.cluster == r) * g.v
              for r in (0, g.cluster - 1)]
        for name, spots in (("first block", [0]), ("last block", [1]),
                            ("both blocks", [0, 1])):
            t = x.to(dtype, copy=True)
            for k in spots:
                t.view(ints)[at[k] // block[1], at[k] % block[1]] = pay[k]
            cases[f"NaN payload, {name}, {MB_ROWS} {8 * elem}-bit"] = (
                t, pay[max(spots)] << 32 - 8 * elem)
    return cases


def check_wire_kernels(torch, D, quantize, framing, codecs, tiling):
    """The q8 wire quantizer and the framing pair against their plain
    versions: bit-exact (a NaN tile's codes, undefined in the plain
    version, are the kernel's 0)."""
    err = dict.fromkeys(WIRE_KERNELS, 0.0)
    gen = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn(MB_ROWS, generator=gen, device="cuda")
    half = torch.randn((16, 4096), generator=gen, device="cuda")
    half[:, :2048] = 0.0
    cases = {
        f"{MB_ROWS} bf16": x.to(torch.bfloat16),
        f"{MB_ROWS} f32": x,
        "256-row microbatch (256, 98304) bf16": torch.randn(
            (256, 128 * D_MODEL), generator=gen,
            device="cuda").to(torch.bfloat16),
        "(16, 4096) f32": torch.randn((16, 4096), generator=gen,
                                      device="cuda"),
        "constant (8, 4096) bf16": torch.full((8, 4096), 3.25, device="cuda",
                                              dtype=torch.bfloat16),
        "half-zero tiles (16, 4096) f32": half,
    }
    for label, t in cases.items():
        block = tiling.wire_tiling(tuple(t.shape))
        got, want = kernel_and_plain(
            torch, D, lambda: quantize.quantize_wire(t, 8, block))
        err["quantize_wire"] = max(err["quantize_wire"],
                                   max_err(torch, got, want))
        log(f"# quantize_wire bit-exact vs plain: {label} tile {block}")
    del cases
    for label, (t, nan_bits) in nan_payload_cases(torch, quantize, tiling,
                                                  x).items():
        block = tiling.wire_tiling(tuple(t.shape))
        (codes, meta), (pcodes, pmeta) = kernel_and_plain(
            torch, D, lambda: quantize.quantize_wire(t, 8, block))
        max_err(torch, [meta], [pmeta])
        got = bits(torch, meta)[0, 0].item() & 0xFFFFFFFF
        if got != nan_bits or meta[0, 1].item() != 1.0:
            raise AssertionError(f"{label}: meta min bits {got:#x}, scale "
                                 f"{meta[0, 1].item()}; want {nan_bits:#x}, 1")
        defined = torch.ones_like(codes, dtype=torch.bool)
        defined[:, :block[1]] = False          # the NaN tile's codes
        max_err(torch, [codes[defined]], [pcodes[defined]])
        if codes[~defined].any():
            raise AssertionError(f"{label}: a NaN tile's code is not 0")
        log(f"# quantize_wire bit-exact vs plain: {label}, meta min "
            f"{got:#x}")
    xb = x.to(torch.bfloat16).reshape(MB_SHAPE)
    for label, parts in wire_payload_parts(torch, codecs, xb).items():
        sizes = [p.numel() for p in parts]
        got, want = kernel_and_plain(torch, D,
                                     lambda: framing.frame_parts(parts))
        err["frame_parts"] = max(err["frame_parts"],
                                 max_err(torch, [got], [torch.cat(parts)]))
        max_err(torch, [got], [want])
        segs, plain = kernel_and_plain(
            torch, D, lambda: framing.unframe_parts(want, sizes))
        err["unframe_parts"] = max(err["unframe_parts"],
                                   max_err(torch, segs, plain))
        max_err(torch, segs, [p.contiguous() for p in parts])
        log(f"# framing bit-exact vs plain: {label} {sizes}")
    idx = torch.randint(0, 1 << 16, (8, 300), generator=gen, device="cuda",
                        dtype=torch.int32).to(torch.uint16)
    seg = idx.reshape(-1).view(torch.uint8)
    back = framing.unframe_parts(framing.frame_parts([seg, seg[:6]]),
                                 [seg.numel(), 6])[0]
    assert torch.equal(back.view(torch.uint16).reshape(8, 300), idx)
    log("# uint16 index leaves view to and from uint8 on the card")
    return err


def time_wire_kernels(torch, D, quantize, framing, codecs, tiling):
    """The wire kernels at the pipeline's shapes: the q8 quantizer on a
    full-width microbatch in bf16 and in f32 (reads 2 or 4 B and writes 1
    B an element, plus the meta; about 7 float32 operations an element:
    min, max, sub, div, round, two clamps), the framing pair on the
    q8-tiled backward hop (each byte read once and written once).
    Library yardsticks: ``torch.cat`` frames,
    ``torch.split_with_sizes_copy`` unframes into fresh tensors; a
    per-tile quantizer has no one-call torch equivalent.  Returns
    {label: {name: row}}."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    x32 = torch.randn(MB_ROWS, generator=gen, device="cuda")
    x = x32.to(torch.bfloat16)
    m, n = x.shape
    block = tiling.wire_tiling((m, n))
    meta_bytes = 4 * 2 * (m // block[0]) * (n // block[1])
    pl = codecs.get_codec("q8").pack(x)
    parts = [a.reshape(-1).view(torch.uint8)
             for a in codecs.payload_leaves(pl)]
    sizes = [p.numel() for p in parts]
    buf = torch.cat(parts)
    total = buf.numel()

    def quantizer(t):
        return {"quantize_wire": (lambda: quantize.quantize_wire(t, 8, block),
                                  "quantize_wire_kernel", None,
                                  m * n * (t.element_size() + 1)
                                  + meta_bytes, 7 * m * n)}
    rows = {WIRE: time_cases(torch, D, quantizer(x)),
            WIRE32: time_cases(torch, D, quantizer(x32)),
            FRAMED: time_cases(torch, D, {
                "frame_parts": (lambda: framing.frame_parts(parts),
                                "framing_kernel", lambda: torch.cat(parts),
                                2 * total, 0),
                "unframe_parts": (
                    lambda: framing.unframe_parts(buf, sizes),
                    "framing_kernel",
                    lambda: torch.split_with_sizes_copy(buf, sizes),
                    2 * total, 0)})}
    for label in (WIRE, WIRE32):
        rows[label]["quantize_wire"]["library"] = (
            "none: no one torch call quantizes per tile")
    rows[FRAMED]["frame_parts"]["library"] = "torch.cat(parts)"
    rows[FRAMED]["unframe_parts"]["library"] = ("torch.split_with_sizes_copy("
                                                "buf, sizes)")
    return rows


def gpt2_leaves(torch):
    """The 13 parameter leaf shapes of full-width gpt2-small, in
    ``tree_leaves`` order (Sum n = 123,570,432), and their dtypes (bf16,
    the layer norms' f32)."""
    from repro_torch.configs.registry import get
    from repro_torch.models import transformer
    from repro_torch.optim.optimizers import tree_leaves
    params = transformer.init_params(
        torch.Generator(device="cuda").manual_seed(0), get("gpt2-small"))
    shapes = [tuple(a.shape) for a in tree_leaves(params)]
    assert len(shapes) == LEAVES, shapes
    return shapes, [a.dtype for a in tree_leaves(params)]


def replica_payload(torch, codecs, collectives, codec, shapes, gen,
                    dtypes=None):
    """One replica's gradient payload, packed from seeded f32 gradients of
    ``shapes`` (cast to ``dtypes``, as the raw codec sends the leaves in
    their own dtype; leaf 3 of the ragged tree constant), and its flat
    uint8 leaf segments as the ring frames them."""
    c = codecs.get_codec(codec)
    payload = []
    for i, s in enumerate(shapes):
        g = torch.randn(s, generator=gen, device="cuda") * 0.01
        if shapes is RAGGED and i == 3:
            g = torch.full(s, 0.75, device="cuda")
        if dtypes is not None:
            g = g.to(dtypes[i])
        payload.append(collectives.pack_grad_leaf(c, g))
    return payload, [a.reshape(-1).view(torch.uint8)
                     for a in codecs.payload_leaves(payload)]


def dp_bank(torch, codecs, collectives, codec, shapes, seed):
    """(dp, nbytes) uint8 bank of ``DP`` replicas' fused gradient buffers,
    its decode plans, payload structs and the last replica's segments."""
    from repro_torch.kernels import dp_reduce
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rows = []
    for _ in range(DP):
        payload, leaves = replica_payload(torch, codecs, collectives, codec,
                                          shapes, gen)
        buf = codecs.fuse_payload(payload)
        if not torch.equal(buf, torch.cat(leaves)):
            raise AssertionError(f"{codec} DP payload: framing != torch.cat")
        rows.append(buf)
    structs = codecs.payload_struct(payload)
    plans = dp_reduce.build_decode_plans(structs, shapes)
    return torch.stack(rows), plans, structs, leaves


def check_dp_kernels(torch, D, codecs, collectives, framing, shapes,
                     dtypes):
    """The DP decode + sum against its plain version and against the
    unfused loop (unfuse -> unpack -> rank-ordered add), bit-exact, at
    dp 1, 3 and 4, on the full-width payload and the ragged tree; framing
    of the 39-segment q8 / q4 payloads, the 26-segment TopK and the
    13-segment raw payload against torch.cat and slices, one launch a
    call."""
    from repro_torch.kernels import _build, dp_reduce
    err = 0.0
    for label, leaf_shapes in (("full-width gpt2-small", shapes),
                               ("ragged", RAGGED)):
        for codec in ("q8", "q4"):
            bank, plans, structs, leaves = dp_bank(
                torch, codecs, collectives, codec, leaf_shapes, 5)
            if leaf_shapes is RAGGED:
                assert any(p.meta_off % 4 for p in plans), "meta aligned"
            sizes = [a.numel() for a in leaves]
            segs, plain = kernel_and_plain(
                torch, D, lambda: framing.unframe_parts(bank[-1], sizes))
            max_err(torch, segs, plain)
            max_err(torch, segs, leaves)
            c = codecs.get_codec(codec)
            for dp in (1, 3, 4):
                slots = bank[:dp]
                got, want = kernel_and_plain(
                    torch, D,
                    lambda: dp_reduce.decode_sum_fused(slots, plans, dp))
                err = max(err, max_err(torch, got, want))
                loop = [None] * len(leaf_shapes)
                for s in range(dp):
                    pls = codecs.unfuse_payload(slots[s], structs)
                    for i, shape in enumerate(leaf_shapes):
                        m = collectives.unpack_grad_leaf(c, pls[i], shape)
                        loop[i] = m if loop[i] is None else loop[i] + m
                max_err(torch, [a.reshape(l.shape) for a, l in
                                zip(got, loop)], loop)
                log(f"# decode_sum_fused bit-exact vs plain and the unfused "
                    f"loop: {label} {codec} dp={dp} ({len(sizes)} segments)")
            del bank, leaves
    gen = torch.Generator(device="cuda").manual_seed(9)
    for codec, segments in (("topk", 2 * LEAVES), ("none", LEAVES)):
        _, leaves = replica_payload(torch, codecs, collectives, codec,
                                    shapes, gen, dtypes)
        sizes = [a.numel() for a in leaves]
        assert len(sizes) == segments, sizes
        _build.reset_launches()
        buf = framing.frame_parts(leaves)
        segs = framing.unframe_parts(buf, sizes)
        torch.cuda.synchronize()
        if _build.LAUNCHES != {"frame_parts": 1, "unframe_parts": 1}:
            raise AssertionError(f"{codec} DP payload framed in "
                                 f"{_build.LAUNCHES} launches, not 1 each")
        max_err(torch, [buf], [torch.cat(leaves)])
        max_err(torch, segs, leaves)
        log(f"# framing bit-exact vs torch.cat and slices, one launch "
            f"each: {codec} DP payload ({segments} segments, {buf.numel()} B)")
        del leaves, buf, segs
    return {"decode_sum_fused": err}


def time_dp_kernels(torch, D, codecs, collectives, framing, shapes,
                    dtypes):
    """``decode_sum_fused`` at dp = 4 on the full-width payload.  The
    function reads each source's code bytes once (dp * nbytes, the meta
    included) and writes Sum n float32; 2 dp float32 operations an
    element (a multiply and an add per source).  No one torch call
    decodes and sums.  Also the framing pair on one replica's payload, as
    the ring frames and unframes it: the 39-segment q8 and q4 payloads
    (labels ``DPF8`` / ``DPF4``, unframed from the bank's row, 8 bytes off
    16-byte alignment), the 26-segment TopK (``DPFT``) and the 13-segment
    raw payload (``DPFN``)."""
    from repro_torch.kernels import dp_reduce
    rows = {}
    for label, flabel, codec in ((DPQ8, DPF8, "q8"), (DPQ4, DPF4, "q4")):
        bank, plans, _, leaves = dp_bank(torch, codecs, collectives, codec,
                                         shapes, 6)
        if bank.shape[1] != DP_PAYLOAD[codec]:
            raise AssertionError(f"{codec} DP payload {bank.shape[1]} B, "
                                 f"expected {DP_PAYLOAD[codec]}")
        total = sum(p.n for p in plans)
        rows[label] = time_cases(torch, D, {"decode_sum_fused": (
            lambda: dp_reduce.decode_sum_fused(bank, plans, DP),
            "decode_sum_kernel", None, DP * bank.shape[1] + 4 * total,
            2 * DP * total)})["decode_sum_fused"]
        rows[label]["shape"] = label
        rows[label]["library"] = "none: no one torch call decodes and sums"
        buf, sizes = bank[-1], [a.numel() for a in leaves]
        rows[flabel] = framing_cases(torch, D, framing, leaves, buf, sizes)
        del bank, buf, leaves
    gen = torch.Generator(device="cuda").manual_seed(10)
    for label, codec in ((DPFT, "topk"), (DPFN, "none")):
        _, leaves = replica_payload(torch, codecs, collectives, codec,
                                    shapes, gen, dtypes)
        buf, sizes = torch.cat(leaves), [a.numel() for a in leaves]
        if buf.numel() != DP_PAYLOAD[codec]:
            raise AssertionError(f"{codec} DP payload {buf.numel()} B, "
                                 f"expected {DP_PAYLOAD[codec]}")
        rows[label] = framing_cases(torch, D, framing, leaves, buf, sizes)
        del buf, leaves
    return rows


def framing_cases(torch, D, framing, leaves, buf, sizes):
    """The framing pair on one payload: each byte read once and written
    once, against ``torch.cat`` and ``torch.split_with_sizes_copy``."""
    return time_cases(torch, D, {
        "frame_parts": (lambda: framing.frame_parts(leaves),
                        "framing_kernel", lambda: torch.cat(leaves),
                        2 * buf.numel(), 0),
        "unframe_parts": (lambda: framing.unframe_parts(buf, sizes),
                          "framing_kernel",
                          lambda: torch.split_with_sizes_copy(buf, sizes),
                          2 * buf.numel(), 0)})


# ---------------------------------------------------------------------------
# phase 3: serving
# ---------------------------------------------------------------------------

def serve(torch, np, D, build):
    from repro_torch.configs.registry import get
    from repro_torch.core.policy import POLICIES
    from repro_torch.models import transformer
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = get("gpt2-small")
    params = transformer.init_params(
        torch.Generator(device="cuda").manual_seed(0), cfg)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, n) for n in PROMPT_LENS]

    def generate(name):
        eng = ServeEngine(params, cfg, POLICIES[name](), max_batch=BATCH,
                          max_seq=MAX_SEQ)
        out = eng.generate([Request(p, NEW_TOKENS) for p in prompts])
        toks = np.stack([r.out for r in out])
        assert toks.shape == (BATCH, NEW_TOKENS)
        assert ((toks >= 0) & (toks < cfg.vocab_size)).all()
        return toks

    tokens, moved = {}, {}
    build.reset_launches()                      # the main path starts here
    for name, kernels in POLICY_KERNELS.items():
        before = dict(build.LAUNCHES)
        tokens[name] = generate(name)
        moved[name] = {k: build.LAUNCHES.get(k, 0) - before.get(k, 0)
                       for k in KERNELS}
        for k in KERNELS:
            if (moved[name][k] > 0) != (k in kernels):
                raise AssertionError(f"policy {name}: {k} launched "
                                     f"{moved[name][k]} times")
        log(f"# served gpt2-small policy={name}: launches {moved[name]} "
            f"tokens[0][:8]={tokens[name][0, :8].tolist()}")
    torch.cuda.synchronize()
    launches = {k: build.LAUNCHES.get(k, 0) for k in KERNELS}  # read here
    per_token = {k: v / (BATCH * NEW_TOKENS) for k, v in launches.items()}
    log(f"# main-path launches {launches}; per token served under the "
        f"kernel's policy: {per_token}")

    D.KERNEL_BACKEND = "plain"
    try:
        for name in POLICY_KERNELS:
            plain = generate(name)
            if not np.array_equal(plain, tokens[name]):
                raise AssertionError(f"policy {name}: plain backend tokens "
                                     f"differ:\n{plain}\n{tokens[name]}")
    finally:
        D.KERNEL_BACKEND = "auto"
    log("# plain backend on the card gives identical tokens for every "
        "policy")
    check_against_cpu(torch, transformer, get)

    for name in POLICY_KERNELS:
        eng = ServeEngine(params, cfg, POLICIES[name](), max_batch=BATCH,
                          max_seq=MAX_SEQ)
        probe = eng.throughput_probe(BATCH, max(PROMPT_LENS), NEW_TOKENS)
        log("# throughput " + json.dumps({"policy": name, **probe}))
        profile_generate(torch, name, eng,
                         [Request(p, NEW_TOKENS) for p in prompts])
    return launches


def profile_generate(torch, name, eng, requests):
    """Where one served batch's time goes: wall time vs summed device time
    (the device's idle share) and the kernels taking the most device time,
    under torch.profiler (whose own cost inflates the wall time)."""
    from torch.profiler import ProfilerActivity, profile
    eng.generate(requests)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.generate(requests)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev = sorted(device_events(prof), reverse=True)
    busy_ms = sum(ms for ms, _ in dev)
    log("# profile " + json.dumps({
        "policy": name, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "device_idle_share": 1 - busy_ms / wall_ms,
        "top_device_ms": [[key[:60], ms] for ms, key in dev[:6]]}))


def check_against_cpu(torch, transformer, get):
    """The smoke model, same params and prompts, on the card and on the
    CPU: finite prefill logits within the bf16 tolerance."""
    import dataclasses
    from repro_torch.core.policy import POLICIES
    cfg = dataclasses.replace(get("gpt2-small", smoke=True), num_layers=4)
    params = transformer.init_params(torch.Generator().manual_seed(1), cfg)
    on_card = _tree_to(params, "cuda")
    gen = torch.Generator().manual_seed(2)
    toks = torch.randint(0, cfg.vocab_size, (BATCH, 16), generator=gen)
    pad = torch.tensor([0, 3, 7, 11])
    cpu, _ = transformer.prefill(params, {"tokens": toks}, cfg,
                                 POLICIES["none"](), cache_len=32,
                                 pad_len=pad, wire=True)
    card, _ = transformer.prefill(on_card, {"tokens": toks.cuda()}, cfg,
                                  POLICIES["none"](), cache_len=32,
                                  pad_len=pad.cuda(), wire=True)
    card = card.float().cpu()
    assert bool(torch.isfinite(card).all()), "non-finite logits on the card"
    gap = (card - cpu.float()).abs().max().item()
    if gap > LOGIT_ATOL:
        raise AssertionError(f"card vs CPU prefill logits differ by {gap}")
    log(f"# smoke prefill logits, card vs CPU: max gap {gap} "
        f"(<= {LOGIT_ATOL})")


# ---------------------------------------------------------------------------
# phase 4: training
# ---------------------------------------------------------------------------

def train_run(torch, cfg, params, name, build, steps=TRAIN_STEPS,
              profile_step=None):
    """``steps`` train steps of ``name`` from ``params``, built as
    ``launch/train`` builds its run.  Returns the losses, each step's
    launches, each step's wall seconds and the profile of step
    ``profile_step`` (1-based) if asked."""
    from repro_torch.core.boundary import init_boundary_state
    from repro_torch.launch.train import build_policy, synthetic_stream
    from repro_torch.models.transformer import segment_bounds
    from repro_torch.optim.optimizers import OptimizerConfig, init_opt_state
    from repro_torch.train.steps import make_lm_train_step

    policy = build_policy(*TRAIN_POLICIES[name][0])
    opt = OptimizerConfig(kind="adamw", lr=1e-3, weight_decay=0.01,
                          schedule="cosine", t_max=steps, grad_clip=1.0)
    cuts = len(segment_bounds(cfg.num_groups, policy.num_stages)) - 1
    bstates = [init_boundary_state(policy.at(i), (TRAIN_SEQ, cfg.d_model),
                                   batch=TRAIN_BATCH,
                                   num_samples=AQSGD_SAMPLES,
                                   dtype=torch.bfloat16, device="cuda")
               for i in range(cuts)]
    step = make_lm_train_step(cfg, policy, opt)
    stream = synthetic_stream(cfg, TRAIN_BATCH, TRAIN_SEQ, 0,
                              num_samples=AQSGD_SAMPLES)
    opt_state = init_opt_state(opt, params)
    losses, launches, seconds, prof = [], [], [], None
    for i in range(1, steps + 1):
        toks, ids = next(stream)
        batch = {"tokens": torch.from_numpy(toks).to("cuda", torch.int64)}
        ids = torch.from_numpy(ids).to("cuda")
        before = dict(build.LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if i == profile_step:
            from torch.profiler import ProfilerActivity, profile
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                params, opt_state, bstates, m = step(params, opt_state,
                                                     bstates, batch, ids)
                torch.cuda.synchronize()
        else:
            params, opt_state, bstates, m = step(params, opt_state, bstates,
                                                 batch, ids)
            torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
        launches.append({k: build.LAUNCHES.get(k, 0) - before.get(k, 0)
                         for k in KERNELS})
    return {"losses": losses, "launches": launches, "seconds": seconds,
            "params": params, "profile": prof}


def train(torch, D, build):
    from repro_torch.configs.registry import get
    from repro_torch.core.policy import POLICIES
    from repro_torch.launch.train import synthetic_stream
    from repro_torch.models import transformer
    from repro_torch.train.steps import make_lm_eval_step

    cfg = get("gpt2-small")
    params = transformer.init_params(
        torch.Generator(device="cuda").manual_seed(0), cfg)
    build.reset_launches()                  # the training path starts here
    runs = {name: train_run(torch, cfg, params, name, build)
            for name in TRAIN_POLICIES}
    torch.cuda.synchronize()
    launches = {k: build.LAUNCHES.get(k, 0) for k in KERNELS}  # read here
    log(f"# training-path launches {launches}")
    for name, (_, kernel, per_step) in TRAIN_POLICIES.items():
        run = runs[name]
        want = {k: per_step if k == kernel else 0 for k in KERNELS}
        for i, got in enumerate(run["launches"]):
            if got != want:
                raise AssertionError(f"train {name} step {i + 1}: launches "
                                     f"{got}, expected {want}")
        losses = run["losses"]
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"train {name}: non-finite loss {losses}")
        if not losses[-1] < losses[0]:
            raise AssertionError(f"train {name}: loss did not fall {losses}")
        tok_s = (TRAIN_BATCH * TRAIN_SEQ * (TRAIN_STEPS - 1)
                 / sum(run["seconds"][1:]))
        log("# train " + json.dumps({
            "policy": name, "losses": losses,
            "launches_per_step": run["launches"][0],
            "step_s": run["seconds"], "tokens_per_s_steps_2_to_4": tok_s}))

    D.KERNEL_BACKEND = "plain"
    try:
        for name in TRAIN_POLICIES:
            plain = train_run(torch, cfg, params, name, build)["losses"]
            if plain != runs[name]["losses"]:
                raise AssertionError(f"train {name}: plain backend losses "
                                     f"{plain} != {runs[name]['losses']}")
    finally:
        D.KERNEL_BACKEND = "auto"
    log("# plain backend on the card gives identical losses for every "
        "policy")

    # finding F3: the q4q8-trained model evaluated with and without it
    policy = POLICIES["q4q8"]()
    toks = next(synthetic_stream(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=7))[0]
    batch = {"tokens": torch.from_numpy(toks).to("cuda", torch.int64)}
    evals = {}
    for compress, want in ((True, 3), (False, 0)):
        before = build.LAUNCHES.get("quant_dequant", 0)
        evals[compress] = float(make_lm_eval_step(cfg, policy, compress)(
            runs["q4q8"]["params"], batch))
        got = build.LAUNCHES.get("quant_dequant", 0) - before
        if got != want or not math.isfinite(evals[compress]):
            raise AssertionError(f"eval compress={compress}: {got} "
                                 f"launches, loss {evals[compress]}")
    log("# eval of the q4q8 model " + json.dumps(
        {"loss_on": evals[True], "loss_off": evals[False],
         "launches_on": 3, "launches_off": 0}))

    check_train_against_cpu(torch, transformer, get)
    for name in TRAIN_POLICIES:
        prof = train_run(torch, cfg, params, name, build, steps=3,
                         profile_step=3)
        dev = sorted(device_events(prof["profile"]), reverse=True)
        busy_ms = sum(ms for ms, _ in dev)
        wall_ms = prof["seconds"][2] * 1e3
        # the profiler inflates the wall time; the unprofiled steps 2-4 of
        # the run above give the idle share without its cost
        step_ms = 1e3 * sorted(runs[name]["seconds"][1:])[1]
        log("# train profile " + json.dumps({
            "policy": name, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1 - busy_ms / wall_ms,
            "unprofiled_step_ms": step_ms,
            "device_idle_share_unprofiled": 1 - busy_ms / step_ms,
            "top_device_ms": [[key[:60], ms] for ms, key in dev[:6]]}))
    return launches


def check_train_against_cpu(torch, transformer, get):
    """Two steps of the smoke model without compression on the card and
    on the CPU (which the CPU tests hold to the JAX package): losses
    within the CPU tests' tolerance."""
    import dataclasses
    import numpy as np
    from repro_torch.core.policy import NO_POLICY
    from repro_torch.optim.optimizers import OptimizerConfig, init_opt_state
    from repro_torch.train.steps import make_lm_train_step
    cfg = dataclasses.replace(get("gpt2-small", smoke=True), num_layers=4)
    params = transformer.init_params(torch.Generator().manual_seed(1), cfg)
    opt = OptimizerConfig(kind="adamw", lr=1e-3, weight_decay=0.01,
                          schedule="cosine", t_max=2, grad_clip=1.0)
    rng = np.random.RandomState(2)
    toks = [torch.from_numpy(rng.randint(0, cfg.vocab_size, (4, 32)))
            for _ in range(2)]
    losses = {}
    for dev in ("cpu", "cuda"):
        p = _tree_to(params, dev)
        o = init_opt_state(opt, p)
        step = make_lm_train_step(cfg, NO_POLICY, opt)
        losses[dev] = []
        for t in toks:
            p, o, _, m = step(p, o, [], {"tokens": t.to(dev)},
                              torch.arange(4, device=dev))
            losses[dev].append(float(m["loss"]))
    gap = max(abs(a - b) for a, b in zip(losses["cpu"], losses["cuda"]))
    if not gap <= LOSS_ATOL:
        raise AssertionError(f"smoke train losses, card {losses['cuda']} "
                             f"vs CPU {losses['cpu']}")
    log(f"# smoke train step losses, card vs CPU: {losses['cuda']} vs "
        f"{losses['cpu']}, max gap {gap} (<= {LOSS_ATOL})")


# ---------------------------------------------------------------------------
# phase 5: the real pipeline
# ---------------------------------------------------------------------------

def pipe_policy(name, stages):
    import dataclasses
    from repro_torch.launch.train import build_policy
    pname, feedback = PIPE_RUNS[name][:2]
    return dataclasses.replace(build_policy(pname, feedback, 0.1),
                               num_stages=stages)


def pipe_run(torch, cfg, params, name, build, steps=PIPE_STEPS,
             profile_step=None):
    """``steps`` pipeline train steps of run ``name`` from ``params``,
    built as ``launch/train --transport pipeline`` builds its run.
    Returns the losses, each step's launches, wire counters and wall
    seconds, the final params and the profile of ``profile_step``."""
    from repro_torch.launch.train import synthetic_stream
    from repro_torch.optim.optimizers import OptimizerConfig, init_opt_state
    from repro_torch.train.loop import _pipeline_bstates
    from repro_torch.train.steps import make_lm_train_step

    _, _, sched, v = PIPE_RUNS[name][:4]
    stages = PIPE_STAGES // v
    policy = pipe_policy(name, stages)
    opt = OptimizerConfig(kind="adamw", lr=1e-3, weight_decay=0.01,
                          schedule="cosine", t_max=steps, grad_clip=1.0)
    bstates = _pipeline_bstates(policy, (PIPE_SEQ, cfg.d_model),
                                batch=PIPE_BATCH, microbatches=PIPE_MB,
                                num_samples=PIPE_SAMPLES,
                                dtype=torch.bfloat16, virtual_stages=v,
                                device="cuda")
    step = make_lm_train_step(cfg, policy, opt, transport="pipeline",
                              pipeline_microbatches=PIPE_MB, schedule=sched,
                              virtual_stages=v)
    stream = synthetic_stream(cfg, PIPE_BATCH, PIPE_SEQ, 0,
                              num_samples=PIPE_SAMPLES)
    opt_state = init_opt_state(opt, params)
    out = {"losses": [], "launches": [], "wire": [], "seconds": [],
           "profile": None}
    for i in range(1, steps + 1):
        toks, ids = next(stream)
        batch = {"tokens": torch.from_numpy(toks).to("cuda", torch.int64)}
        ids = torch.from_numpy(ids).to("cuda")
        before = dict(build.LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if i == profile_step:
            from torch.profiler import ProfilerActivity, profile
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                params, opt_state, bstates, m = step(params, opt_state,
                                                     bstates, batch, ids)
                torch.cuda.synchronize()
            out["profile"] = prof
        else:
            params, opt_state, bstates, m = step(params, opt_state, bstates,
                                                 batch, ids)
            torch.cuda.synchronize()
        out["seconds"].append(time.perf_counter() - t0)
        out["losses"].append(float(m["loss"]))
        out["wire"].append(m["wire"])
        out["launches"].append({k: build.LAUNCHES.get(k, 0) - before.get(k, 0)
                                for k in KERNELS})
    out["params"] = params
    return out


def pipe_expected_wire(name):
    """Bytes and hops per step of run ``name`` from ``wire_telemetry``,
    checked against the payload sizes of one full-width microbatch."""
    from repro_torch.transport.pipeline import (PipelineTransport,
                                                wire_telemetry)
    from repro_torch.transport.schedules import get_schedule
    from repro_torch.train.steps import _uniform_boundary
    _, _, sched, v, _, (fw, bw) = PIPE_RUNS[name]
    schedule = get_schedule(sched, v)
    stages = PIPE_STAGES // v
    tel = wire_telemetry(
        PipelineTransport(_uniform_boundary(pipe_policy(name, stages)),
                          stages, virtual_stages=v,
                          fused=schedule.fused_wire),
        schedule, MB_SHAPE, microbatches=PIPE_MB)
    hops = PIPE_MB * tel["wire_cuts"]
    assert hops == PIPE_HOPS, (name, hops)
    assert tel["fw_payload_bytes_per_hop"] == PAYLOAD_BYTES[fw], (name, tel)
    assert tel["bw_payload_bytes_per_hop"] == PAYLOAD_BYTES[bw], (name, tel)
    return {"fw_hops": hops, "bw_hops": hops,
            "fw_bytes": hops * tel["fw_payload_bytes_per_hop"],
            "bw_bytes": hops * tel["bw_payload_bytes_per_hop"]}


def pipeline(torch, D, build):
    from repro_torch.configs.registry import get
    from repro_torch.models import transformer

    cfg = get("gpt2-small")
    params = transformer.init_params(
        torch.Generator(device="cuda").manual_seed(0), cfg)
    build.reset_launches()                  # the pipeline path starts here
    runs = {name: pipe_run(torch, cfg, params, name, build)
            for name in PIPE_RUNS}
    torch.cuda.synchronize()
    launches = {k: build.LAUNCHES.get(k, 0) for k in KERNELS}  # read here
    log(f"# pipeline-path launches {launches}")
    for name, spec in PIPE_RUNS.items():
        run, want = runs[name], spec[4]
        for i, got in enumerate(run["launches"]):
            if got != want:
                raise AssertionError(f"pipeline {name} step {i + 1}: "
                                     f"launches {got}, expected {want}")
        wire = pipe_expected_wire(name)
        for i, got in enumerate(run["wire"]):
            if got != wire:
                raise AssertionError(f"pipeline {name} step {i + 1}: wire "
                                     f"{got}, expected {wire}")
        losses = run["losses"]
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"pipeline {name}: non-finite loss {losses}")
        if not losses[-1] < losses[0]:
            raise AssertionError(f"pipeline {name}: loss did not fall "
                                 f"{losses}")
        tok_s = (PIPE_BATCH * PIPE_SEQ * (PIPE_STEPS - 1)
                 / sum(run["seconds"][1:]))
        log("# pipeline " + json.dumps({
            "run": name, "losses": losses,
            "launches_per_step": {k: v for k, v in run["launches"][0].items()
                                  if v},
            "wire_per_step": run["wire"][0], "step_s": run["seconds"],
            "tokens_per_s_steps_2_to_3": tok_s}))
    for pol in ("q4q8", "aqsgd"):
        a, b = runs[f"gpipe/{pol}"], runs[f"1f1b/{pol}"]
        if a["losses"] != b["losses"]:
            raise AssertionError(f"1f1b != gpipe under {pol}: "
                                 f"{b['losses']} vs {a['losses']}")
        for (n, x), (_, y) in zip(_leaves(a["params"]), _leaves(b["params"])):
            if not torch.equal(x, y):
                raise AssertionError(f"1f1b != gpipe under {pol}: param {n}")
    log("# 1f1b equals gpipe bitwise (losses and params after 3 steps) "
        "under q4q8 and aqsgd")

    D.KERNEL_BACKEND = "plain"
    try:
        for name in PIPE_RUNS:
            plain = pipe_run(torch, cfg, params, name, build)["losses"]
            if plain != runs[name]["losses"]:
                raise AssertionError(f"pipeline {name}: plain backend "
                                     f"losses {plain} != "
                                     f"{runs[name]['losses']}")
    finally:
        D.KERNEL_BACKEND = "auto"
    log("# plain backend on the card gives identical pipeline losses for "
        "every run")

    check_pipeline_against_cpu(torch, transformer, get)
    for name in ("gpipe/q4q8", "1f1b/q4q8", "interleaved/q4q8"):
        prof = pipe_run(torch, cfg, params, name, build, steps=2,
                        profile_step=2)
        dev = sorted(device_events(prof["profile"]), reverse=True)
        busy_ms = sum(ms for ms, _ in dev)
        wall_ms = prof["seconds"][1] * 1e3
        step_ms = 1e3 * min(runs[name]["seconds"][1:])
        log("# pipeline profile " + json.dumps({
            "run": name, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1 - busy_ms / wall_ms,
            "unprofiled_step_ms": step_ms,
            "device_idle_share_unprofiled": 1 - busy_ms / step_ms,
            "top_device_ms": [[key[:60], ms] for ms, key in dev[:6]]}))
    return launches


def check_pipeline_against_cpu(torch, transformer, get):
    """One pipeline step of the smoke model (4 layer groups, 2 stages, 2
    microbatches) on the card and on the CPU, which the CPU tests hold to
    the JAX package: without compression within the train tolerance,
    under q4q8 / 1f1b within the compressed one."""
    import dataclasses
    import numpy as np
    from repro_torch.core.policy import POLICIES
    from repro_torch.optim.optimizers import OptimizerConfig, init_opt_state
    from repro_torch.train.steps import make_lm_train_step
    cfg = dataclasses.replace(get("gpt2-small", smoke=True), num_layers=4)
    params = transformer.init_params(torch.Generator().manual_seed(1), cfg)
    opt = OptimizerConfig(kind="adamw", lr=1e-3, weight_decay=0.01,
                          schedule="cosine", t_max=1, grad_clip=1.0)
    toks = torch.from_numpy(np.random.RandomState(2).randint(
        0, cfg.vocab_size, (16, 32)))
    for pname, sched, tol in (("none", "gpipe", LOSS_ATOL),
                              ("q4q8", "1f1b", LM_LOSS_ATOL)):
        policy = dataclasses.replace(POLICIES[pname](), num_stages=2)
        losses = {}
        for dev in ("cpu", "cuda"):
            p = _tree_to(params, dev)
            step = make_lm_train_step(cfg, policy, opt, transport="pipeline",
                                      pipeline_microbatches=2,
                                      schedule=sched)
            _, _, _, m = step(p, init_opt_state(opt, p), [],
                              {"tokens": toks.to(dev)},
                              torch.arange(16, device=dev))
            losses[dev] = float(m["loss"])
        gap = abs(losses["cpu"] - losses["cuda"])
        if not (math.isfinite(losses["cuda"]) and gap <= tol):
            raise AssertionError(f"smoke pipeline {pname}/{sched}: card "
                                 f"{losses['cuda']} vs CPU {losses['cpu']}")
        log(f"# smoke pipeline step {pname}/{sched}, card vs CPU: "
            f"{losses['cuda']} vs {losses['cpu']}, gap {gap} (<= {tol})")


# ---------------------------------------------------------------------------
# phase 6: data-parallel training with the compressed gradient all-reduce
# ---------------------------------------------------------------------------

def dp_spec(name):
    from repro_torch.core.parallel import AxisSpec, ParallelSpec
    codec, fb, k_frac = DP_RUNS[name][:3]
    return ParallelSpec({"data": AxisSpec(size=DP, codec=codec, feedback=fb,
                                          k_frac=k_frac)})


def make_timed_dp_step(torch, cfg, policy, opt, spec, reduce_events):
    """``make_lm_train_step(parallel=spec)`` whose reduce records a pair
    of CUDA events around each call into ``reduce_events``."""
    import repro_torch.train.steps as TS
    real = TS.make_grad_all_reduce

    def timed(*a, **kw):
        red = real(*a, **kw)

        def reduce(grads, state):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out = red(grads, state)
            ev[1].record()
            reduce_events.append(ev)
            return out
        return reduce

    TS.make_grad_all_reduce = timed
    try:
        return TS.make_lm_train_step(cfg, policy, opt, parallel=spec)
    finally:
        TS.make_grad_all_reduce = real


def dp_run(torch, cfg, params, name, build, steps=DP_STEPS,
           profile_step=None):
    """``steps`` data-parallel train steps of run ``name`` from ``params``,
    built as ``launch/train --mesh data=4 --wire data=...`` builds its
    run.  Returns the losses, each step's launches, ring bytes, wall
    seconds, CUDA-event step and reduce ms, and the profile of
    ``profile_step``."""
    from repro_torch.core.boundary import init_boundary_state
    from repro_torch.launch.train import build_policy, synthetic_stream
    from repro_torch.models.transformer import segment_bounds
    from repro_torch.optim.optimizers import OptimizerConfig, init_opt_state
    from repro_torch.train.loop import init_lm_dp_state

    _, dfb, _, pname, fb, _ = DP_RUNS[name]
    policy = build_policy(pname, fb, 0.1)
    opt = OptimizerConfig(kind="adamw", lr=1e-3, weight_decay=0.01,
                          schedule="cosine", t_max=steps, grad_clip=1.0)
    cuts = len(segment_bounds(cfg.num_groups, policy.num_stages)) - 1
    bstates = [init_boundary_state(policy.at(i), (DP_SEQ, cfg.d_model),
                                   batch=DP_BATCH, num_samples=DP_SAMPLES,
                                   dtype=torch.bfloat16, device="cuda")
               for i in range(cuts)]
    reduce_events = []
    step = make_timed_dp_step(torch, cfg, policy, opt, dp_spec(name),
                              reduce_events)
    dp_state = init_lm_dp_state(cfg, params, policy, DP, dfb)
    stream = synthetic_stream(cfg, DP_BATCH, DP_SEQ, 0,
                              num_samples=DP_SAMPLES, dp=DP)
    opt_state = init_opt_state(opt, params)
    out = {"losses": [], "launches": [], "dp_bytes": [], "seconds": [],
           "step_ms": [], "reduce_ms": [], "profile": None}
    for i in range(1, steps + 1):
        toks, ids = next(stream)
        batch = {"tokens": torch.from_numpy(toks).to("cuda", torch.int64)}
        ids = torch.from_numpy(ids).to("cuda")
        before = dict(build.LAUNCHES)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev[0].record()
        if i == profile_step:
            from torch.profiler import ProfilerActivity, profile
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                params, opt_state, bstates, dp_state, m = step(
                    params, opt_state, bstates, batch, ids, dp_state)
                torch.cuda.synchronize()
            out["profile"] = prof
        else:
            params, opt_state, bstates, dp_state, m = step(
                params, opt_state, bstates, batch, ids, dp_state)
        ev[1].record()
        torch.cuda.synchronize()
        out["seconds"].append(time.perf_counter() - t0)
        out["step_ms"].append(ev[0].elapsed_time(ev[1]))
        r0, r1 = reduce_events[-1]
        out["reduce_ms"].append(r0.elapsed_time(r1))
        out["losses"].append(float(m["loss"]))
        out["dp_bytes"].append(m["wire"]["dp_bytes"])
        out["launches"].append({k: build.LAUNCHES.get(k, 0) - before.get(k, 0)
                                for k in KERNELS})
    return out


def dp_expected_bytes(name, params):
    """Ring bytes per step: dp (dp - 1) hops of ``dp_wire_report``'s
    buffer, checked against the q8 / q4 payload sizes."""
    from repro_torch.transport.collectives import dp_wire_report
    codec, _, k_frac = DP_RUNS[name][:3]
    rep = dp_wire_report(params, codec, k_frac=k_frac, dp=DP)
    if codec in DP_PAYLOAD:
        assert rep["payload_bytes_per_hop"] == DP_PAYLOAD[codec], rep
    assert rep["n_param_leaves"] == LEAVES, rep
    return DP * rep["wire_bytes_per_reduce"]


def data_parallel(torch, D, build):
    from repro_torch.configs.registry import get
    from repro_torch.models import transformer

    cfg = get("gpt2-small")
    params = transformer.init_params(
        torch.Generator(device="cuda").manual_seed(0), cfg)
    build.reset_launches()                  # the DP path starts here
    runs = {name: dp_run(torch, cfg, params, name, build)
            for name in DP_RUNS}
    torch.cuda.synchronize()
    launches = {k: build.LAUNCHES.get(k, 0) for k in KERNELS}  # read here
    log(f"# dp-path launches {launches}")
    for name, spec in DP_RUNS.items():
        run, want = runs[name], spec[5]
        for i, got in enumerate(run["launches"]):
            if got != want:
                raise AssertionError(f"dp {name} step {i + 1}: launches "
                                     f"{got}, expected {want}")
        nbytes = dp_expected_bytes(name, params)
        if run["dp_bytes"] != [nbytes] * DP_STEPS:
            raise AssertionError(f"dp {name}: ring bytes {run['dp_bytes']}, "
                                 f"expected {nbytes} a step")
        losses = run["losses"]
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"dp {name}: non-finite loss {losses}")
        if not losses[-1] < losses[0]:
            raise AssertionError(f"dp {name}: loss did not fall {losses}")
        tok_s = (DP_BATCH * DP_SEQ * (DP_STEPS - 1)
                 / sum(run["seconds"][1:]))
        log("# dp " + json.dumps({
            "run": name, "losses": losses,
            "launches_per_step": {k: v for k, v in run["launches"][0].items()
                                  if v},
            "dp_bytes_per_step": run["dp_bytes"][0], "step_s": run["seconds"],
            "step_ms_cuda_events": run["step_ms"],
            "reduce_ms_cuda_events": run["reduce_ms"],
            "reduce_share": [r / t for r, t in zip(run["reduce_ms"],
                                                   run["step_ms"])],
            "tokens_per_s_steps_2_to_3": tok_s}))

    D.KERNEL_BACKEND = "plain"
    try:
        for name in DP_RUNS:
            plain = dp_run(torch, cfg, params, name, build)["losses"]
            if plain != runs[name]["losses"]:
                raise AssertionError(f"dp {name}: plain backend losses "
                                     f"{plain} != {runs[name]['losses']}")
    finally:
        D.KERNEL_BACKEND = "auto"
    log("# plain backend on the card gives identical DP losses for every "
        "run")

    check_dp_against_cpu(torch, transformer, get)
    name = "q8/q4q8"
    prof = dp_run(torch, cfg, params, name, build, steps=2, profile_step=2)
    dev = sorted(device_events(prof["profile"]), reverse=True)
    busy_ms = sum(ms for ms, _ in dev)
    wall_ms = prof["seconds"][1] * 1e3
    step_ms = 1e3 * min(runs[name]["seconds"][1:])
    log("# dp profile " + json.dumps({
        "run": name, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "device_idle_share": 1 - busy_ms / wall_ms,
        "unprofiled_step_ms": step_ms,
        "device_idle_share_unprofiled": 1 - busy_ms / step_ms,
        "top_device_ms": [[key[:60], ms] for ms, key in dev[:8]]}))
    return launches


def check_dp_against_cpu(torch, transformer, get):
    """Two DP steps (dp 2, batch 4, seq 32) of the smoke model on the card
    and on the CPU (which the CPU tests hold to the JAX package): the DP
    codec none within the train tolerance, q8 within the compressed one;
    step 2's loss reads step 1's reduced update."""
    import dataclasses
    import numpy as np
    from repro_torch.core.parallel import AxisSpec, ParallelSpec
    from repro_torch.core.policy import NO_POLICY
    from repro_torch.optim.optimizers import OptimizerConfig, init_opt_state
    from repro_torch.train.loop import init_lm_dp_state
    from repro_torch.train.steps import make_lm_train_step
    cfg = dataclasses.replace(get("gpt2-small", smoke=True), num_layers=4)
    params = transformer.init_params(torch.Generator().manual_seed(1), cfg)
    opt = OptimizerConfig(kind="adamw", lr=1e-3, weight_decay=0.01,
                          schedule="cosine", t_max=2, grad_clip=1.0)
    rng = np.random.RandomState(2)
    toks = [torch.from_numpy(rng.randint(0, cfg.vocab_size, (4, 32)))
            for _ in range(2)]
    for codec, tol in (("none", LOSS_ATOL), ("q8", LM_LOSS_ATOL)):
        spec = ParallelSpec({"data": AxisSpec(size=2, codec=codec)})
        losses = {}
        for dev in ("cpu", "cuda"):
            p = _tree_to(params, dev)
            o = init_opt_state(opt, p)
            st = init_lm_dp_state(cfg, p, NO_POLICY, 2)
            step = make_lm_train_step(cfg, NO_POLICY, opt, parallel=spec)
            losses[dev] = []
            for t in toks:
                p, o, _, st, m = step(p, o, [], {"tokens": t.to(dev)},
                                      torch.arange(4, device=dev), st)
                losses[dev].append(float(m["loss"]))
        gap = max(abs(a - b) for a, b in zip(losses["cpu"], losses["cuda"]))
        if not (all(math.isfinite(v) for v in losses["cuda"])
                and gap <= tol):
            raise AssertionError(f"smoke DP step {codec}: card "
                                 f"{losses['cuda']} vs CPU {losses['cpu']}")
        log(f"# smoke DP step dp=2 {codec}, card vs CPU: {losses['cuda']} "
            f"vs {losses['cpu']}, max gap {gap} (<= {tol})")


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


def main() -> int:
    # cuBLAS reads this when it starts, so it goes before any CUDA call
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    torch.use_deterministic_algorithms(True)
    # the wrappers write every element they allocate; no NaN fill kernels
    torch.utils.deterministic.fill_uninitialized_memory = False
    from repro_torch import device as D
    from repro_torch.kernels import _build, framing, ops, pack4, quantize
    from repro_torch.kernels import tiling, topk_select as topk
    from repro_torch.transport import codecs, collectives

    # -- phase 1 ------------------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    log(smi)
    t0 = time.perf_counter()
    reports = _build.build()
    log(f"# built {sorted(reports)} in {time.perf_counter() - t0:.1f} s")
    for name, rep in reports.items():
        print(f"# ptxas {name}:\n{rep}", file=sys.stderr, flush=True)

    # -- phase 2 ------------------------------------------------------------
    inputs = kernel_inputs(torch)
    shapes, dtypes = gpt2_leaves(torch)
    timed = select_phase(torch, D, topk, inputs, shapes)
    torch.cuda.empty_cache()
    err = check_kernels(torch, D, pack4, inputs)
    cuts = cut_inputs(torch)
    err.update(check_cut_kernels(torch, D, ops, cuts))
    for label in (PREFILL, DECODE):
        timed[label].update(time_pack4(torch, D, pack4, inputs[label]))
        for name in ("pack4_wire", "unpack4_wire"):
            log(f"# {name} {label}: " + json.dumps(timed[label][name]))
    for label in (CUT, CUT32):
        timed[label] = time_cut_kernels(torch, D, ops, cuts[label])
        for name, row in timed[label].items():
            log(f"# {name} {label}: " + json.dumps(row))
    err.update(check_wire_kernels(torch, D, quantize, framing, codecs,
                                  tiling))
    wire = time_wire_kernels(torch, D, quantize, framing, codecs, tiling)
    for label, rows in wire.items():
        timed.setdefault(label, {}).update(rows)
        for name, row in rows.items():
            log(f"# {name} {label}: " + json.dumps(row))
    err.update(check_dp_kernels(torch, D, codecs, collectives, framing,
                                shapes, dtypes))
    timed.update(time_dp_kernels(torch, D, codecs, collectives, framing,
                                 shapes, dtypes))
    for label in (DPQ8, DPQ4):
        log(f"# decode_sum_fused {label}: " + json.dumps(timed[label]))
    for label in (DPF8, DPF4, DPFT, DPFN):
        for name, row in timed[label].items():
            log(f"# {name} {label}: " + json.dumps(row))
    for label, rows in q4_phase(torch, D, pack4, shapes).items():
        timed.setdefault(label, {}).update(rows)
    torch.cuda.empty_cache()
    for label, rows in timed.items():
        for name, row in ({"decode_sum_fused": rows} if "ms" in rows
                          else rows).items():
            if row["lost"]:
                log(f"# LOST {name} {label}: its profiles recorded "
                    f"{row['device_ops']} device ops a call, fewer than "
                    f"the launches; its times are not to be used")
    log(f"# phase 2 done at {time.perf_counter() - t0:.1f} s")

    # -- phases 3-6: each main path, its counts set to 0 just before it and
    # read just after; the kernels line sums them
    paths = []
    for phase, run in ((3, lambda: serve(torch, np, D, _build)),
                       (4, lambda: train(torch, D, _build)),
                       (5, lambda: pipeline(torch, D, _build)),
                       (6, lambda: data_parallel(torch, D, _build))):
        paths.append(run())
        log(f"# phase {phase} done at {time.perf_counter() - t0:.1f} s")
    launches = {k: sum(p[k] for p in paths) for k in KERNELS}
    for k, v in launches.items():
        if not v:
            raise AssertionError(f"{k} was launched on no main path")

    # -- phase 7 ------------------------------------------------------------
    line = []
    for name, (src, replaces) in KERNELS.items():
        row = (timed[DPQ8] if name in DP_KERNELS else
               timed[SEL_LEAF if name in SELECT_KERNELS else
                     CUT if name in TRAIN_KERNELS else
                     WIRE if name == "quantize_wire" else
                     FRAMED if name in WIRE_KERNELS else PREFILL][name])
        line.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": err[name], "ms": row["ms"],
                     "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                     "bound_by": row["bound_by"],
                     "library_ms": row["library_ms"]})
    log(json.dumps({"kernels": line}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
