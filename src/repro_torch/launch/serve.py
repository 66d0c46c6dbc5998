"""Serving launcher: static batch or continuous batching (port of
``repro/launch/serve.py``).

Initializes a registry architecture from ``--seed`` (or restores ``--ckpt``,
the reference's npz format) and serves generation requests with the
paper's rule applied: a model trained with boundary compression is served
with the same compression (finding F3), every stage cut packing the real
wire payload.  Runs on ``cuda`` unless ``--device cpu``.

  # continuous batching, mixed Zipf-length workload, temperature sampling
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gpt2-small \\
      --engine continuous --policy top10 --slots 4 --requests 16 \\
      --temperature 0.8 --top-k 40
  # static-batch baseline with the prefill/decode throughput probe
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gpt2-small \\
      --engine static --policy top10 --batch 4 --prompt-len 32 \\
      --new-tokens 32
  # paged serving: prefix-shared KV pages + chunked prefill on a
  # shared-system-prompt workload
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gpt2-small \\
      --engine continuous --policy top10 --prefix-cache \\
      --prefill-chunk 16 --shared-prefix 48
  # speculative decoding: a draft model proposes, the target verifies
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gpt2-small \\
      --engine continuous --policy top10 --draft gpt2-small --spec-k 4

  # telemetry: the JSONL event log and a Chrome trace of a paged run,
  # scheduler / page-pool counters every 2 ticks
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gpt2-small \\
      --smoke --device cpu --policy top10 --prefix-cache \\
      --prefill-chunk 16 --shared-prefix 48 --trace /tmp/s.jsonl \\
      --perfetto /tmp/s.json --metrics 2

``--trace PATH`` turns tracing on and writes the JSONL event log there
(``obs/export.py``'s schema), ``--perfetto PATH`` a Chrome-trace file;
``--metrics N`` sets how often (in ticks) the continuous engine emits its
scheduler and page-pool counters while tracing is on.  The events are
those of ``serve/engine.py``'s ``ContinuousEngine``: warm-up included,
as in the reference.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from repro_torch.checkpoint import io as ckpt_io
from repro_torch.configs.registry import ARCHS, get
from repro_torch.core.policy import POLICIES
from repro_torch.device import resolve_device
from repro_torch.models import encdec, transformer
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.export import to_chrome_trace, to_jsonl
from repro_torch.serve.engine import (ContinuousEngine, Request, ServeEngine,
                                      left_pad_unsupported)
from repro_torch.serve.sampling import SamplingConfig


def zipf_lengths(rng, n, lo, hi, a=1.6):
    """Zipf-distributed lengths in [lo, hi] — the mixed serving workload."""
    return np.clip(lo + (rng.zipf(a, n) - 1), lo, hi).astype(int)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gpt2-small", choices=sorted(ARCHS))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--engine", default=None,
                    choices=("continuous", "static"),
                    help="default: continuous where the arch supports it "
                         "(maskable left-padding), else static")
    ap.add_argument("--policy", default="none", choices=sorted(POLICIES))
    ap.add_argument("--no-compress", action="store_true",
                    help="serve WITHOUT compression (finding-F3 ablation)")
    ap.add_argument("--batch", type=int, default=4,
                    help="static engine batch size")
    ap.add_argument("--slots", type=int, default=4,
                    help="continuous engine decode slots")
    ap.add_argument("--requests", type=int, default=8,
                    help="continuous engine: number of requests to serve")
    ap.add_argument("--prompt-len", type=int, default=32,
                    help="static: exact prompt length; continuous: max of "
                         "the Zipf prompt-length mix")
    ap.add_argument("--new-tokens", type=int, default=32,
                    help="static: decode steps; continuous: max of the "
                         "Zipf max-new-tokens mix")
    ap.add_argument("--max-seq", type=int, default=256)
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 = greedy")
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--eos", type=int, default=None,
                    help="stop decoding a request at this token id")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="continuous engine: prefix-sharing paged KV")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="continuous engine: ingest prompts in chunks of "
                         "this many tokens, one chunk per tick, "
                         "interleaved with decode; implies the paged KV "
                         "cache")
    ap.add_argument("--page-size", type=int, default=16,
                    help="tokens per KV page in paged mode")
    ap.add_argument("--draft", default=None, choices=sorted(ARCHS),
                    help="speculative decoding: draft arch proposing "
                         "--spec-k tokens per tick (greedy only; the draft "
                         "shares --policy/--no-compress)")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="draft proposals per speculative tick")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="workload: prepend a common system-prompt "
                         "prefix of this many tokens to every request")
    ap.add_argument("--ckpt", default=None, help="restore params from npz")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="enable telemetry and write the JSONL event log "
                         "here (obs/export.py schema; default: tracing "
                         "off, zero overhead)")
    ap.add_argument("--perfetto", default=None, metavar="PATH",
                    help="also write a Chrome-trace JSON loadable at "
                         "ui.perfetto.dev / chrome://tracing")
    ap.add_argument("--metrics", type=int, default=1, metavar="N",
                    help="continuous engine: emit scheduler/page-pool "
                         "counters every N ticks when tracing is on "
                         "(default 1)")
    ap.add_argument("--device", default="cuda")
    return ap


def _export_trace(args) -> None:
    """Drain the tracer into the requested --trace / --perfetto files."""
    tr = obs_trace.get_tracer()
    if tr is None:
        return
    events = tr.drain()
    if args.trace:
        print(f"# trace: {to_jsonl(events, args.trace)} events "
              f"-> {args.trace} (dropped {tr.dropped})", flush=True)
    if args.perfetto:
        print(f"# perfetto: {to_chrome_trace(events, args.perfetto)} "
              f"events -> {args.perfetto}", flush=True)


def _init(cfg, seed, dev):
    mod = encdec if cfg.enc_dec else transformer
    return mod.init_params(torch.Generator(device=dev).manual_seed(seed),
                           cfg)


def main(argv=None) -> int:
    ap = _parser()
    args = ap.parse_args(argv)
    if not (args.trace or args.perfetto):
        return _serve(ap, args)
    obs_trace.enable()
    try:
        return _serve(ap, args)
    finally:
        obs_trace.disable()


def _serve(ap, args) -> int:
    """:func:`main` after the parse."""
    cfg = get(args.arch, smoke=args.smoke)
    try:
        transformer.check_supported(cfg)
    except NotImplementedError as e:
        ap.error(str(e))
    unsupported = left_pad_unsupported(cfg)
    if args.engine is None:
        args.engine = "static" if unsupported else "continuous"
        if unsupported:
            print(f"# {cfg.arch_id}: {sorted(unsupported)} cannot mask "
                  "left-padding -> static engine", flush=True)
    elif args.engine == "continuous" and unsupported:
        ap.error(f"--engine continuous: {sorted(unsupported)} cannot mask "
                 "left-padding — use --engine static "
                 "(equal-length batches)")
    if args.engine == "static":
        if args.temperature or args.top_k or args.top_p < 1.0 \
                or args.eos is not None:
            ap.error("--temperature/--top-k/--top-p/--eos need "
                     "--engine continuous (the static engine decodes "
                     "greedily to a fixed length)")
        if args.prefix_cache or args.prefill_chunk or args.draft \
                or args.shared_prefix:
            ap.error("--prefix-cache/--prefill-chunk/--draft/"
                     "--shared-prefix need --engine continuous")
    draft_cfg = None
    if args.draft:
        draft_cfg = get(args.draft, smoke=args.smoke)
        if draft_cfg.vocab_size != cfg.vocab_size:
            ap.error(f"--draft {args.draft}: draft vocab "
                     f"{draft_cfg.vocab_size} != target vocab "
                     f"{cfg.vocab_size} — proposals must share token ids")
        try:
            transformer.check_supported(draft_cfg)
        except NotImplementedError as e:
            ap.error(f"--draft: {e}")
    dev = resolve_device(args.device)
    params = _init(cfg, args.seed, dev)
    if args.ckpt:
        params, step = ckpt_io.restore_params(args.ckpt, params)
        print(f"# restored step-{step} params from {args.ckpt}", flush=True)
    policy = POLICIES[args.policy]()
    compress = not args.no_compress
    rng = np.random.RandomState(args.seed)

    if args.engine == "static":
        engine = ServeEngine(params, cfg, policy, compress=compress,
                             max_batch=args.batch, max_seq=args.max_seq)
        reqs = [Request(rng.randint(0, min(cfg.vocab_size, 1024),
                                    args.prompt_len).astype(np.int64),
                        args.new_tokens)
                for _ in range(args.batch)]
        probe = engine.throughput_probe(args.batch, args.prompt_len,
                                        args.new_tokens)
        print(json.dumps({"arch": cfg.arch_id, "engine": "static",
                          "policy": args.policy, "compress": compress,
                          **probe}), flush=True)
        done = engine.generate(reqs)
        for i, r in enumerate(done[: min(4, len(done))]):
            print(f"# req{i}: prompt[-4:]={r.prompt[-4:].tolist()} "
                  f"-> out[:8]={r.out[:8].tolist()}", flush=True)
        _export_trace(args)
        return 0

    sampling = SamplingConfig(temperature=args.temperature,
                              top_k=args.top_k, top_p=args.top_p)
    draft_params = (_init(draft_cfg, args.seed + 1, dev) if args.draft
                    else None)
    engine = ContinuousEngine(params, cfg, policy, compress=compress,
                              num_slots=args.slots, max_seq=args.max_seq,
                              sampling=sampling,
                              max_prompt=args.prompt_len
                              + args.shared_prefix,
                              prefix_cache=args.prefix_cache,
                              prefill_chunk=args.prefill_chunk,
                              page_size=args.page_size,
                              draft_params=draft_params,
                              draft_cfg=draft_cfg, draft_policy=policy,
                              spec_k=args.spec_k,
                              metrics_every=max(1, args.metrics), device=dev)
    warm = engine.warmup()
    vocab = min(cfg.vocab_size, 1024)
    shared = rng.randint(0, vocab, args.shared_prefix).astype(np.int64)
    plens = zipf_lengths(rng, args.requests, 2, args.prompt_len)
    news = zipf_lengths(rng, args.requests, 1, args.new_tokens)
    t0 = time.perf_counter()
    for i in range(args.requests):
        tail = rng.randint(0, vocab, plens[i]).astype(np.int64)
        engine.submit(np.concatenate([shared, tail]),
                      max_new_tokens=int(news[i]), eos_token=args.eos,
                      seed=args.seed + i)
    done = engine.drain()
    wall = time.perf_counter() - t0
    total_new = sum(len(r.tokens) for r in done)
    print(json.dumps({"arch": cfg.arch_id, "engine": "continuous",
                      "policy": args.policy, "compress": compress,
                      "device": str(engine.device),
                      "requests": args.requests, "slots": args.slots,
                      **warm, "wall_s": wall,
                      "tok_per_s": total_new / wall,
                      **engine.stats()}), flush=True)
    for r in sorted(done, key=lambda r: r.req_id)[:4]:
        print(f"# req{r.req_id}: {json.dumps(r.metrics())} "
              f"out[:8]={r.out[:8].tolist()}", flush=True)
    _export_trace(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
