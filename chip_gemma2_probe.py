#!/usr/bin/env python3
"""Two measurements of gemma2-27b at full width (4 layers) on one card,
with ``chip_smoke.py``'s phase-13 code and settings.

    python3 chip_gemma2_probe.py [--part kernels,memory,ties] [--seeds 6]

kernels ``chip_smoke.py``'s phase-2 rows at phase 13's shapes
        (``big_kernels``: the cut kernels at the training cuts, the q4
        pair at the serving wire's rows), bit-exact and timed.

memory  a q4q8 training step of 1 x 8,192 tokens (``big_train_run``, 3
        steps) three ways, each in a process of its own: as the smoke
        runs it (each attention query chunk recomputed in backward, the
        params and AdamW moments donated), without the chunks' recompute
        (``torch.utils.checkpoint`` in ``models/attention.py::_sdpa``
        replaced by a plain call), and without donation
        (``make_lm_train_step(donate=False)``); then the first two again
        at 4,608 and 3,072 tokens.  Prints each run's peak
        ``max_memory_allocated`` and step seconds, or the out-of-memory
        error and the peak before it.
ties    the slab ``ContinuousEngine`` (2 slots, max_seq 8,192) on the
        smoke's three prompt lengths (4,100, 300, 1,000; 16 new tokens)
        drawn from ``--seeds`` seeds, under none and q4q8: each stream of
        the 8-tick drain and of each request served alone by the static
        engine against the single-tick drain, every parting with the
        single-tick stream's top-2 gap there, its top logit and the gap
        in bfloat16 ulps of the top logit.  Then, under none, three
        planted faults in the 8-tick drain's cache after each insert (a
        global layer's key row at the second-to-last prompt position
        overwritten by the next row's; the same in a local layer's ring;
        a global layer's value row zeroed; every local layer's ring
        rolled by one row) and their partings the same way: the gaps at
        which a real fault parts a stream.

Prints the card's name and power limit, then one JSON line a reading;
the same lines go to ``chiprun_out/gemma2_probe.jsonl``.  Needs a CUDA
card and nvcc; torch only.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out" / "gemma2_probe.jsonl"
ARCH = "gemma2-27b"
MEMORY_RUNS = (("smoke", 8192), ("no-chunk-recompute", 8192),
               ("no-donate", 8192), ("smoke", 4608),
               ("no-chunk-recompute", 4608), ("smoke", 3072),
               ("no-chunk-recompute", 3072))


def emit(row):
    line = json.dumps(row)
    print(line, flush=True)
    OUT.parent.mkdir(exist_ok=True)
    with open(OUT, "a") as f:
        f.write(line + "\n")


def setup():
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    sys.path.insert(0, str(ROOT))
    import torch
    import chip_smoke as cs           # puts src/ on the path
    if not torch.cuda.is_available():
        raise SystemExit("chip_gemma2_probe: no CUDA card")
    torch.use_deterministic_algorithms(True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    from repro_torch.kernels import _build
    _build.build()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    return torch, cs, _build, smi


def model_cfg():
    from repro_torch.configs.registry import get
    import chip_smoke as cs
    return dataclasses.replace(get(ARCH), num_layers=cs.BIG_LAYERS)


def kernels():
    torch, cs, build, smi = setup()
    from repro_torch import device as D
    from repro_torch.kernels import ops, pack4
    err, timed = cs.big_kernels(torch, D, ops, pack4)
    emit({"part": "kernels", "card": smi, "max_abs_err": err,
          "timed": timed})


def memory_run(variant: str, seq: int):
    """One q4q8 run of ``big_train_run`` (in this process)."""
    torch, cs, build, smi = setup()
    import repro_torch.models.attention as A
    import repro_torch.train.steps as TS
    if variant == "no-chunk-recompute":
        A.checkpoint = lambda fn, *a, use_reentrant=False: fn(*a)
    elif variant == "no-donate":
        make = TS.make_lm_train_step
        TS.make_lm_train_step = lambda *a, **k: make(*a, **{**k,
                                                        "donate": False})
    batch, _, pols, per_step = cs.BIG_TRAIN[ARCH]
    cs.BIG_TRAIN[ARCH] = (batch, seq, pols, per_step)
    cs.log = lambda *a: None
    row = {"part": "memory", "variant": variant, "seq": seq, "card": smi}
    try:
        got = cs.big_train_run(torch, build, model_cfg(), ARCH, "q4q8", smi)
        row.update(step_s=got["step_s"], losses=got["losses"],
                   max_memory_allocated=got["max_memory_allocated"])
    except torch.cuda.OutOfMemoryError as e:
        row.update(oom=str(e).splitlines()[0][:200],
                   max_memory_allocated=torch.cuda.max_memory_allocated())
    emit(row)


def parts(got, want, gaps, tops, ulp):
    """Every stream's first parting from ``want``: (request, step, gap,
    top, gap in ulps of the top logit); None for an equal stream."""
    out = {}
    for rid, ref in want.items():
        o = got[rid]
        diff = [i for i in range(min(len(o), len(ref))) if o[i] != ref[i]]
        if not diff:
            out[rid] = None
            continue
        i = diff[0]
        g, t = gaps[(rid, i)], tops[(rid, i)]
        out[rid] = {"step": i, "gap": g, "top": t, "ulps": g / ulp(t)}
    return out


def plant(kind):
    """An ``_insert`` that corrupts the inserted slot's cache after the
    real insert (``kind``: see the module docstring)."""
    def insert(self, tokens, pad, slot, gen):
        tok = type(self)._insert(self, tokens, pad, slot, gen)
        r = len(tokens) - 2              # a real prompt position
        b0, b1 = self._caches["b0"], self._caches["b1"]
        if kind == "global key row":
            b1["k"][0, slot, r] = b1["k"][0, slot, r + 1]
        elif kind == "ring key row":
            c = b0["k"].shape[2]
            b0["k"][0, slot, r % c] = b0["k"][0, slot, (r + 1) % c]
        elif kind == "ring rolled one row":
            for leaf in ("k", "v"):
                b0[leaf][:, slot] = b0[leaf][:, slot].roll(1, dims=1)
        else:                            # "global value row zeroed"
            b1["v"][1, slot, r] = 0
        return tok
    return insert


def ties(seeds: int):
    torch, cs, build, smi = setup()
    import functools
    import numpy as np
    from repro_torch.core.policy import POLICIES
    from repro_torch.models import transformer
    from repro_torch.serve.engine import ContinuousEngine
    cs.log = lambda *a: None
    cfg = model_cfg()
    params = transformer.init_params(
        torch.Generator(device="cuda").manual_seed(0), cfg)
    kw = dict(num_slots=cs.G2_CS_SLOTS, max_seq=cs.G2_CS_MAX_SEQ,
              max_prompt=max(cs.G2_CS_PROMPTS))
    for seed in range(seeds):
        rng = np.random.RandomState(seed)
        reqs = [(rng.randint(0, cfg.vocab_size, n).astype(np.int64),
                 cs.BIG_NEW, i) for i, n in enumerate(cs.G2_CS_PROMPTS)]
        for name in ("none", "q4q8"):
            make = functools.partial(ContinuousEngine, params, cfg,
                                     POLICIES[name](), **kw)
            chunked, _ = cs.cs_serve(make(), reqs)
            ref, gaps, tops = cs.cs_gap_run(torch, make, reqs, tops=True)
            alone = cs.cs_static(np, params, cfg, POLICIES[name](), reqs,
                                 max_prompt=max(cs.G2_CS_PROMPTS),
                                 max_seq=cs.G2_CS_MAX_SEQ)
            for what, got in (("8-tick drain", chunked),
                              ("each request alone", alone)):
                emit({"part": "ties", "seed": seed, "policy": name,
                      "vs single ticks": what, "card": smi,
                      "partings": parts(got, ref, gaps, tops, cs.bf16_ulp)})
            if name != "none":
                continue
            for kind in ("global key row", "ring key row",
                         "global value row zeroed", "ring rolled one row"):
                eng = make()
                eng._insert = types.MethodType(plant(kind), eng)
                bad, _ = cs.cs_serve(eng, reqs)
                emit({"part": "fault", "seed": seed, "policy": name,
                      "fault": kind, "card": smi,
                      "partings": parts(bad, ref, gaps, tops, cs.bf16_ulp)})
                del eng
            torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--part", default="kernels,memory,ties")
    ap.add_argument("--seeds", type=int, default=6)
    ap.add_argument("--memory-run", default=None,
                    help="variant:seq, one memory run in this process")
    ap.add_argument("--kernels", action="store_true",
                    help="the kernels part in this process")
    args = ap.parse_args()
    if args.kernels:
        kernels()
        return 0
    if args.memory_run:
        variant, seq = args.memory_run.split(":")
        memory_run(variant, int(seq))
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    rc = 0
    if "kernels" in args.part:
        rc |= subprocess.run([sys.executable, __file__,
                              "--kernels"]).returncode
    if "memory" in args.part:
        for variant, seq in MEMORY_RUNS:
            rc |= subprocess.run([sys.executable, __file__, "--memory-run",
                                  f"{variant}:{seq}"]).returncode
    if "ties" in args.part:
        ties(args.seeds)
    return rc


if __name__ == "__main__":
    sys.exit(main())
