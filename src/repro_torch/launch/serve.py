"""Serving launcher: static batch (port of ``repro/launch/serve.py``).

Initializes a registry architecture from ``--seed`` (or restores ``--ckpt``,
the reference's npz format) and serves a batch of random prompts with the
paper's rule applied: a model trained with boundary compression is served
with the same compression (finding F3), every stage cut packing the real
wire payload.  Runs on ``cuda`` unless ``--device cpu``.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gpt2-small \\
      --engine static --policy top10 --batch 4 --prompt-len 32 \\
      --new-tokens 32

The continuous engine and its features (sampling, EOS, paging, prefix
cache, chunked prefill, speculative decoding, tracing) are not ported yet
and exit with an error saying so.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from repro_torch.checkpoint import io as ckpt_io
from repro_torch.configs.registry import ARCHS, get
from repro_torch.core.policy import POLICIES
from repro_torch.device import resolve_device
from repro_torch.models import transformer
from repro_torch.serve.engine import Request, ServeEngine

# Flags of the reference launcher that belong to features not ported yet.
NOT_PORTED = ("--slots", "--requests", "--temperature", "--top-k", "--top-p",
              "--eos", "--prefix-cache", "--prefill-chunk", "--page-size",
              "--draft", "--spec-k", "--shared-prefix", "--trace",
              "--perfetto", "--metrics")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gpt2-small", choices=sorted(ARCHS))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--engine", default="static",
                    choices=("continuous", "static"))
    ap.add_argument("--policy", default="none", choices=sorted(POLICIES))
    ap.add_argument("--no-compress", action="store_true",
                    help="serve WITHOUT compression (finding-F3 ablation)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--max-seq", type=int, default=256)
    ap.add_argument("--ckpt", default=None, help="restore params from npz")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args, rest = ap.parse_known_args(argv)
    for flag in rest:
        if flag.split("=")[0] in NOT_PORTED:
            ap.error(f"{flag.split('=')[0]} is not yet ported to repro_torch "
                     "(only the static engine is)")
    if rest:
        ap.error(f"unrecognized arguments: {' '.join(rest)}")
    if args.engine != "static":
        ap.error(f"--engine {args.engine} is not yet ported to repro_torch "
                 "(use --engine static)")

    cfg = get(args.arch, smoke=args.smoke)
    try:
        transformer.check_supported(cfg)
    except NotImplementedError as e:
        ap.error(str(e))
    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = transformer.init_params(gen, cfg)
    if args.ckpt:
        params, step = ckpt_io.restore_params(args.ckpt, params)
        print(f"# restored step-{step} params from {args.ckpt}", flush=True)
    policy = POLICIES[args.policy]()
    compress = not args.no_compress
    rng = np.random.RandomState(args.seed)

    engine = ServeEngine(params, cfg, policy, compress=compress,
                         max_batch=args.batch, max_seq=args.max_seq)
    reqs = [Request(rng.randint(0, min(cfg.vocab_size, 1024),
                                args.prompt_len).astype(np.int64),
                    args.new_tokens)
            for _ in range(args.batch)]
    probe = engine.throughput_probe(args.batch, args.prompt_len,
                                    args.new_tokens)
    print(json.dumps({"arch": cfg.arch_id, "engine": "static",
                      "policy": args.policy, "compress": compress, **probe}),
          flush=True)
    done = engine.generate(reqs)
    for i, r in enumerate(done[: min(4, len(done))]):
        print(f"# req{i}: prompt[-4:]={r.prompt[-4:].tolist()} "
              f"-> out[:8]={r.out[:8].tolist()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
