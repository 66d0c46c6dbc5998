"""Paper Table 5 in miniature on the PyTorch port: TopK index reuse vs
separate masks.

The torch counterpart of ``examples/finetune_index_reuse.py``: fine-tunes
a pretrained tiny LM with Top-30% boundary compression two ways: (a)
backward gradients compressed with the REUSED forward TopK indices, and
(b) activations and gradients compressed with INDEPENDENT TopK masks.
The paper reports (b) diverges on a pretrained model (ppl 2990 vs 74);
this demo shows the same ordering at toy scale.  Runs on the card unless
given ``--device cpu``.

Run:  PYTHONPATH=src python examples/finetune_index_reuse_torch.py
"""
import argparse
import math

from repro_torch.core.policy import CompressionPolicy, topk_policy
from repro_torch.data.synthetic import LMData
from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.train.loop import pretrain_lm, run_lm_experiment

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None, help="default: cuda")
dev = resolve_device(ap.parse_args().device)

cfg = ModelConfig(
    arch_id="ft-demo", family="dense", num_layers=4, d_model=128,
    num_heads=4, num_kv_heads=4, head_dim=32, d_ff=512, vocab_size=256,
    pos_embed="rope", norm="layernorm", mlp="gelu", max_seq=64)

data = LMData(num_train=256, num_test=64)
print("pretraining (uncompressed)...")
pre, loss = pretrain_lm(cfg, steps=200, data=data, device=dev)
print(f"  pretrain loss {loss:.3f}")

K = 0.30          # paper Table 5 ladder; at toy scale top30 shows the
                  # reuse-vs-separate mechanism without total collapse
for reuse in (True, False):
    pol = CompressionPolicy(
        num_stages=4, boundary=topk_policy(K, reuse_indices=reuse))
    r = run_lm_experiment(cfg, pol, pretrained_params=pre, epochs=2,
                          data=data, name=f"reuse={reuse}", device=dev)
    print(f"top{int(K*100)} reuse_indices={reuse}:  "
          f"eval loss {r.loss_on:.3f}  "
          f"ppl {math.exp(min(r.loss_on, 20)):.1f}")
print("-> separate masks (reuse=False) should be worse (finding F6); the "
      "full-scale version is benchmarks table5")
