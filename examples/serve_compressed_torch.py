"""Continuous-batching serving with boundary compression on the PyTorch
port (paper finding F3 at serve time).

The torch counterpart of ``examples/serve_compressed.py``.  Part 1
streams a mixed-length batch of requests through the ContinuousEngine's
submit()/step()/drain() API on a reduced Mixtral-style MoE config with
the Top-10% boundary policy -- each stage cut packs/unpacks the real TopK
wire payload -- first with compression ON, then the same requests with
compression OFF, and shows the generations diverge: compression is part
of the trained model's function.

Part 2 turns on the paged serving path (gpt2-small -- paged mode needs a
full-context arch, not Mixtral's sliding window): every request shares a
system-prompt prefix, so the prefix cache reuses its KV pages instead of
re-prefilling, chunked prefill ingests the rest without stalling decode,
and a draft model speculates ahead -- while the emitted tokens stay
BIT-IDENTICAL to plain greedy decoding.  Runs on the card unless given
``--device cpu``.

Run:  PYTHONPATH=src python examples/serve_compressed_torch.py
"""
import argparse

import numpy as np
import torch

from repro_torch.configs.registry import get
from repro_torch.core.policy import CompressionPolicy, topk_policy
from repro_torch.device import resolve_device
from repro_torch.models import transformer
from repro_torch.serve.engine import ContinuousEngine

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None, help="default: cuda")
dev = resolve_device(ap.parse_args().device)

cfg = get("mixtral-8x7b", smoke=True)
policy = CompressionPolicy(num_stages=4, boundary=topk_policy(0.10))
params = transformer.init_params(torch.Generator(device=dev).manual_seed(0),
                                 cfg)

rng = np.random.RandomState(0)
# mixed prompt lengths + mixed decode budgets: the scheduler packs them
prompts = [rng.randint(0, min(cfg.vocab_size, 512), n).astype(np.int32)
           for n in (24, 9, 17, 5)]
news = (16, 6, 10, 12)

outs = {}
for compress in (True, False):
    engine = ContinuousEngine(params, cfg, policy, compress=compress,
                              num_slots=2, max_seq=128, device=dev)
    engine.warmup()
    for p, n in zip(prompts, news):
        engine.submit(p.copy(), max_new_tokens=n)
    done = {r.req_id: r for r in engine.drain()}
    outs[compress] = [done[i].out for i in range(len(prompts))]
    stats = engine.stats()
    print(f"compress={compress}: util={stats['slot_utilization']} "
          f"mean_ttft={stats['mean_ttft_s']}s "
          f"wire bytes/token={stats['boundary_bytes_per_tok']}")
    for i in range(2):
        print(f"  req{i} ({done[i].metrics()['new_tokens']} toks) "
              f"-> {done[i].out.tolist()}")

same = all(np.array_equal(a, b) for a, b in zip(outs[True], outs[False]))
print(f"generations identical with/without compression: {same}")
print("-> expect False: serving must keep the training-time compression "
      "(finding F3)")

# --- part 2: paged serving — shared prefix + chunked prefill + drafts ---
cfg2 = get("gpt2-small", smoke=True)
policy2 = CompressionPolicy(num_stages=2, boundary=topk_policy(0.10))
params2 = transformer.init_params(
    torch.Generator(device=dev).manual_seed(0), cfg2)

shared = rng.randint(0, min(cfg2.vocab_size, 512), 48).astype(np.int32)
reqs = [np.concatenate([shared,
                        rng.randint(0, min(cfg2.vocab_size, 512), t)
                        .astype(np.int32)]) for t in (7, 3, 9, 5)]

variants = {
    "plain": {},
    "paged": dict(prefix_cache=True, prefill_chunk=16),
    # self-draft: the target proposes for itself -- acceptance is high and
    # the output is still exactly the target's greedy stream
    "paged+spec": dict(prefix_cache=True, prefill_chunk=16,
                       draft_params=params2, draft_cfg=cfg2,
                       draft_policy=policy2, spec_k=4),
}
outs2 = {}
for name, kw in variants.items():
    eng = ContinuousEngine(params2, cfg2, policy2, compress=True,
                           num_slots=2, max_seq=128, max_prompt=64,
                           device=dev, **kw)
    eng.warmup()
    for p in reqs:
        eng.submit(p.copy(), max_new_tokens=8)
    done = {r.req_id: r for r in eng.drain()}
    outs2[name] = [done[i].out for i in range(len(reqs))]
    stats = eng.stats()
    extra = ""
    if "prefix_hits" in stats:
        extra += (f" prefix_hits={stats['prefix_hits']}"
                  f" ({stats['prefix_hit_tokens']} toks reused)")
    if "acceptance_rate" in stats:
        extra += f" draft_acceptance={stats['acceptance_rate']}"
    print(f"{name}: mean_ttft={stats['mean_ttft_s']}s{extra}")

# the prefix cache and the draft are pure accelerations: token streams
# match plain paged greedy decoding bit for bit
for name in ("paged+spec",):
    assert all(np.array_equal(a, b)
               for a, b in zip(outs2["paged"], outs2[name]))
print("paged and speculative outputs are bit-identical: True")
