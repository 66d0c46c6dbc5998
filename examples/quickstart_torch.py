"""Quickstart on the PyTorch port: train a tiny LM with the paper's
boundary compression.

The torch counterpart of ``examples/quickstart.py``: builds a 4-layer
transformer, cuts it into 4 pipeline stages (3 compression boundaries,
the paper's MP degree), trains 64 steps with Top-10% activation +
gradient compression (forward TopK indices reused backward, paper Table
5), then evaluates with compression ON and OFF -- finding F3 in
miniature: the trained model expects its boundary compression at
inference.  Runs on the card unless given ``--device cpu``.

Run:  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse
import math

import torch

from repro_torch.core.boundary import init_boundary_state
from repro_torch.core.policy import CompressionPolicy, topk_policy
from repro_torch.data.synthetic import LMData
from repro_torch.device import resolve_device
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig
from repro_torch.optim.optimizers import OptimizerConfig, init_opt_state
from repro_torch.train.steps import make_lm_eval_step, make_lm_train_step

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None, help="default: cuda")
dev = resolve_device(ap.parse_args().device)

cfg = ModelConfig(
    arch_id="quickstart-lm", family="dense", num_layers=4, d_model=128,
    num_heads=4, num_kv_heads=4, head_dim=32, d_ff=512, vocab_size=256,
    pos_embed="rope", norm="rmsnorm", mlp="swiglu", max_seq=64)

policy = CompressionPolicy(num_stages=4,
                           boundary=topk_policy(0.10, reuse_indices=True))

data = LMData(num_train=256, num_test=64)
opt = OptimizerConfig(kind="adamw", lr=1e-3, schedule="constant",
                      grad_clip=1.0)
params = transformer.init_params(torch.Generator(device=dev).manual_seed(0),
                                 cfg)
opt_state = init_opt_state(opt, params)
bstates = [init_boundary_state(policy.at(i), (data.seq_len, cfg.d_model),
                               batch=16, device=dev) for i in range(3)]
step = make_lm_train_step(cfg, policy, opt, remat=False)


def tokens(toks):
    return {"tokens": torch.from_numpy(toks).to(dev, torch.int64)}


print(f"training {cfg.arch_id} with policy "
      f"{policy.boundary.name} at 3 stage boundaries")
n = 0
for ep in range(4):
    for toks, ids in data.epoch(16, ep):
        params, opt_state, bstates, m = step(
            params, opt_state, bstates, tokens(toks),
            torch.from_numpy(ids).to(dev))
        n += 1
        if n % 16 == 0:
            print(f"  step {n:3d}  loss {float(m['loss']):.3f}")

for compress in (True, False):
    ev = make_lm_eval_step(cfg, policy, compress)
    losses = [float(ev(params, tokens(t))) for t, _ in data.test_batches(16)]
    loss = sum(losses) / len(losses)
    tag = "ON " if compress else "OFF"
    print(f"eval compression {tag}: loss {loss:.3f} "
          f"ppl {math.exp(loss):.1f}")
print("-> the compressed-inference loss should be the lower one (finding F3)")
