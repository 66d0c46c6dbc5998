"""Static-batch serving engine.

Port of ``repro/serve/engine.py::ServeEngine``.  A model trained with
boundary compression is served with compression on (paper Table 2,
finding F3): every stage cut of prefill and decode packs and unpacks the
real wire payload of the policy's forward codec, per request
(core/boundary.boundary_wire_eval) — on the card through the q4 pack /
TopK select kernels.  The continuous-batching engine is not ported yet.

The engine runs where its params live; tokens come back as numpy.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core.policy import CompressionPolicy, NO_POLICY
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass
class Request:
    prompt: np.ndarray                  # (S,) int
    max_new_tokens: int = 16
    out: Optional[np.ndarray] = None


class ServeEngine:
    """Static batch: left-pad prompts to the longest, prefill once, decode
    greedily (argmax, first index on ties) to the batch's max new tokens.
    """

    def __init__(self, params, cfg: ModelConfig,
                 policy: CompressionPolicy = NO_POLICY,
                 compress: bool = True, max_batch: int = 8,
                 max_seq: int = 256):
        transformer.check_supported(cfg)
        self.params, self.cfg, self.policy = params, cfg, policy
        self.compress = compress
        self.max_batch, self.max_seq = max_batch, max_seq
        self.device = params["embed"].device

    def _pack(self, requests: List[Request]):
        """Left-pad prompts to a common length; the per-request pad length
        masks the padding out of attention, so a short prompt generates
        what it would alone."""
        plen = max(len(r.prompt) for r in requests)
        prompts = np.zeros((len(requests), plen), np.int64)
        for i, r in enumerate(requests):
            prompts[i, plen - len(r.prompt):] = r.prompt
        pad_len = [plen - len(r.prompt) for r in requests]
        return (torch.from_numpy(prompts).to(self.device),
                torch.tensor(pad_len, device=self.device), plen)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _prefill(self, prompts, pad_len):
        logits, caches = transformer.prefill(
            self.params, {"tokens": prompts}, self.cfg, self.policy,
            cache_len=self.max_seq, compress=self.compress, pad_len=pad_len,
            wire=True)
        return torch.argmax(logits[:, -1], dim=-1), caches

    def _decode(self, token, caches, pos: int, pad_len):
        logits, caches = transformer.decode_step(
            self.params, token, caches, pos, self.cfg, self.policy,
            compress=self.compress, pad_len=pad_len, wire=True)
        return torch.argmax(logits, dim=-1), caches

    def _check(self, requests: List[Request]):
        if not 1 <= len(requests) <= self.max_batch:
            raise ValueError(f"{len(requests)} requests for a batch of "
                             f"1..{self.max_batch}")
        need = (max(len(r.prompt) for r in requests)
                + max(r.max_new_tokens for r in requests) - 1)
        if need > self.max_seq:
            raise ValueError(f"prompt + new tokens need {need} cache slots, "
                             f"max_seq is {self.max_seq}")

    @torch.inference_mode()
    def generate(self, requests: List[Request]) -> List[Request]:
        self._check(requests)
        prompts, pad_len, plen = self._pack(requests)
        steps = max(r.max_new_tokens for r in requests)
        token, caches = self._prefill(prompts, pad_len)
        outs = [token]
        for i in range(steps - 1):
            token, caches = self._decode(token, caches, plen + i, pad_len)
            outs.append(token)
        gen = torch.stack(outs, dim=1).cpu().numpy()          # (B, steps)
        for i, r in enumerate(requests):
            r.out = gen[i, :r.max_new_tokens]
        return requests

    @torch.inference_mode()
    def throughput_probe(self, batch: int, prompt_len: int,
                         new_tokens: int) -> dict:
        """Prefill and decode tokens/s at one (batch, prompt_len) shape,
        after one warm run of the same shapes (builds the kernels)."""
        rng = np.random.RandomState(0)
        reqs = [Request(rng.randint(0, self.cfg.vocab_size, prompt_len)
                        .astype(np.int64), new_tokens)
                for _ in range(batch)]
        self._check(reqs)
        t0 = time.perf_counter()
        self.generate([Request(r.prompt.copy(), 2) for r in reqs])
        self._sync()
        warm_s = time.perf_counter() - t0

        prompts, pad_len, plen = self._pack(reqs)
        self._sync()
        t0 = time.perf_counter()
        token, caches = self._prefill(prompts, pad_len)
        self._sync()
        prefill_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for i in range(new_tokens - 1):
            token, caches = self._decode(token, caches, plen + i, pad_len)
        self._sync()
        decode_s = time.perf_counter() - t0
        wall = prefill_s + decode_s
        return {"batch": batch, "prompt": prompt_len, "new": new_tokens,
                "device": str(self.device), "warm_s": warm_s,
                "wall_s": wall, "prefill_s": prefill_s,
                "prefill_tok_per_s": batch * prompt_len / prefill_s,
                "decode_s": decode_s,
                "decode_tok_per_s": batch * (new_tokens - 1) / decode_s
                if new_tokens > 1 else 0.0,
                "tok_per_s": batch * new_tokens / wall}
