"""Serving engines: static-batch baseline + continuous batching.

Port of ``repro/serve/engine.py``.  A model trained with boundary
compression is served with compression on (paper Table 2, finding F3):
every stage cut of prefill and decode packs and unpacks the real wire
payload of the policy's forward codec, per request
(core/boundary.boundary_wire_eval), and per (request, token) in
multi-token spans (boundary_wire_eval_tokens) — on the card through the
q4 pack / TopK select kernels.

Two engines:

  * :class:`ServeEngine` — static batch: left-pad every prompt to the
    longest in the batch, decode everyone until the batch's max new
    tokens.  Runs where its params live.
  * :class:`ContinuousEngine` — continuous batching: a streaming
    ``submit()/step()/drain()`` API over ``num_slots`` decode slots.  A
    finished slot (EOS or max-new-tokens) is evicted and refilled from the
    admission queue on the next tick.  All slots advance through one
    decode step with per-slot positions, padding and random streams, and
    prompts prefill at power-of-two length buckets.  Runs on ``cuda``
    unless given ``device="cpu"``.

Tokens come back as numpy.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core.boundary import boundary_wire_bytes_per_token
from repro_torch.core.policy import CompressionPolicy, NO_POLICY
from repro_torch.device import host_ints, resolve_device
from repro_torch.models import encdec, transformer
from repro_torch.models.config import ModelConfig
from repro_torch.obs import trace
from repro_torch.serve import cache as C
from repro_torch.serve import pages as PG
from repro_torch.serve.sampling import (GREEDY, SamplingConfig, request_key,
                                        sample_tokens)
from repro_torch.serve.scheduler import Scheduler, ServeRequest
from repro_torch.serve.speculative import DraftWorker, accept_greedy


@dataclasses.dataclass
class Request:
    prompt: np.ndarray                  # (S,) int
    max_new_tokens: int = 16
    out: Optional[np.ndarray] = None


def left_pad_unsupported(cfg: ModelConfig) -> set:
    """Arch features incompatible with masked left-padding (and so with
    mixed-length static batches and with continuous batching): recurrent
    state and absolute positions carry the padding; the vision patch
    prefix splices into the sequence FRONT, exactly where left-padding
    goes."""
    bad = {"rwkv", "hymba"} & set(cfg.layer_kinds())
    if cfg.enc_dec:
        bad.add("enc-dec")
    if cfg.frontend == "vision":
        bad.add("vision-frontend")
    return bad


def _make_batch(cfg: ModelConfig, tokens: torch.Tensor) -> dict:
    """A prefill batch from (B, S) device tokens: the tokens, and the
    reference's stub inputs: zero (B, num_patches, d_model) bf16 patch
    embeddings for the vision frontend, zero (B, enc_seq, d_model) bf16
    frame embeddings for the encoder-decoder."""
    b = {"tokens": tokens}
    if cfg.frontend == "vision":
        b["patch_embeds"] = torch.zeros(
            (tokens.shape[0], cfg.num_patches, cfg.d_model),
            dtype=torch.bfloat16, device=tokens.device)
    if cfg.enc_dec:
        b["enc_embeds"] = torch.zeros(
            (tokens.shape[0], cfg.enc_seq, cfg.d_model),
            dtype=torch.bfloat16, device=tokens.device)
    return b


class ServeEngine:
    """Static batch: left-pad prompts to the longest, prefill once, decode
    greedily (argmax, first index on ties) to the batch's max new tokens.
    An encoder-decoder config runs ``models/encdec.py`` (its decode state
    is the self-attention caches and the encoder memory).
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
        self.mod = encdec if cfg.enc_dec else transformer

    def _pack(self, requests: List[Request]):
        """Left-pad prompts to a common length; the per-request pad length
        masks the padding out of attention, so a short prompt generates
        what it would alone.  Archs in :func:`left_pad_unsupported` take
        equal-length prompts only."""
        plen = max(len(r.prompt) for r in requests)
        if plen != min(len(r.prompt) for r in requests):
            unsupported = left_pad_unsupported(self.cfg)
            if unsupported:
                raise ValueError(
                    "mixed-length prompts need left-padding, which "
                    f"{sorted(unsupported)} cannot support (see "
                    "left_pad_unsupported) — batch equal-length "
                    "prompts for this arch")
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
        logits, caches = self.mod.prefill(
            self.params, _make_batch(self.cfg, prompts), self.cfg,
            self.policy, cache_len=self.max_seq, compress=self.compress,
            pad_len=pad_len, wire=True)
        return torch.argmax(logits[:, -1], dim=-1), caches

    def _decode(self, token, caches, pos: int, pad_len):
        logits, caches = self.mod.decode_step(
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


class ContinuousEngine:
    """Continuous-batching engine: streaming submit()/step()/drain().

    Restrictions: decoder-only stacks whose attention masks left-padding
    (:func:`left_pad_unsupported` is empty, and the port's
    ``transformer.check_supported``).

    Multi-step decode: when no slot can complete within the next
    ``tick_chunk`` ticks and no active request watches for EOS, the engine
    runs ``tick_chunk`` decode steps with the tokens kept on the device
    and syncs the host once (the reference's ``lax.scan``): the scheduler
    only needs token values back at completion and refill boundaries.

    PAGED MODE (``prefix_cache`` / ``prefill_chunk`` / ``draft_params``):
    the per-slot KV slabs are replaced by a shared refcounted page pool
    (serve/pages.py) addressed through per-slot page maps.  Three coupled
    features ride on it:

      * prefix sharing — a new request whose leading full token pages are
        already cached skips their prefill (refcount++), and its own full
        prompt pages are indexed for future requests once its prefill
        completes;
      * chunked prefill — prompt ingestion runs as ``prefill_chunk``-sized
        ``decode_span`` chunks, ONE chunk per prefilling slot per tick,
        interleaved with the decode tick;
      * speculative decoding — a draft model proposes ``spec_k`` greedy
        tokens per tick and the target verifies all of them in one
        ``decode_span`` forward (serve/speculative.py); stage cuts pack
        per (request, token), so emitted tokens are plain greedy decode's.

    Prompts occupy positions ``[0, L)`` (no left-padding — page sharing
    needs position-stable content), decode continues at ``L``, and masked
    or inactive writes land in the reserved trash page.

    Host syncs: one ``int(tok)`` per inserted request (the first token,
    an honest TTFT, as the reference), one per decode tick or per
    ``tick_chunk`` ticks, one per speculative round (proposals) and one
    per verification.

    Telemetry (``obs/trace.py``), when tracing is on: a
    ``serve.request_done`` instant per completed request (tokens, TTFT,
    decode rate), the ``serve.sched`` counter (and ``serve.pages`` in
    paged mode) every ``metrics_every`` ticks, and ``serve.prefill`` /
    ``serve.decode`` / ``serve.spec`` spans around each tick's phases.
    Each span ends after its phase's host sync (a paged prefill tick that
    samples no first token syncs the card at the span's end, only while
    tracing), so its time holds the device work.  :meth:`stats` has no
    ``*_compiles`` keys: eager PyTorch compiles no programs, so the
    reference's ``compile_stats`` has no counterpart.
    """

    def __init__(self, params, cfg: ModelConfig,
                 policy: CompressionPolicy = NO_POLICY,
                 compress: bool = True, num_slots: int = 4,
                 max_seq: int = 256, sampling: SamplingConfig = GREEDY,
                 max_prompt: Optional[int] = None, tick_chunk: int = 8,
                 prefix_cache: bool = False,
                 prefill_chunk: Optional[int] = None, page_size: int = 16,
                 num_pages: Optional[int] = None, draft_params=None,
                 draft_cfg: Optional[ModelConfig] = None,
                 draft_policy: CompressionPolicy = NO_POLICY,
                 spec_k: int = 4, metrics_every: int = 1, device=None):
        bad = left_pad_unsupported(cfg)
        if bad:
            raise ValueError(
                "continuous batching needs maskable left-padding and "
                f"per-slot positions; {sorted(bad)} supports neither "
                "(see left_pad_unsupported) — use ServeEngine "
                "(--engine static) with equal-length batches")
        transformer.check_supported(cfg)
        dev = resolve_device(device)
        if params["embed"].device.type != dev.type:
            raise ValueError(f"params live on {params['embed'].device}, "
                             f"the engine runs on {dev}")
        self.device = params["embed"].device
        self.params, self.cfg, self.policy = params, cfg, policy
        self.compress, self.sampling = compress, sampling
        self.num_slots, self.max_seq = num_slots, max_seq
        self.tick_chunk = max(1, tick_chunk)
        self.buckets = C.prompt_buckets(min(max_prompt or max_seq // 2,
                                            max_seq))
        self.sched = Scheduler(num_slots)
        self.pos = np.zeros(num_slots, np.int64)     # next decode position
        self.pad = np.zeros(num_slots, np.int64)     # left-pad inside bucket
        self.last_tok = np.zeros(num_slots, np.int64)
        self._gens: List[Optional[torch.Generator]] = [None] * num_slots
        self.ticks = 0
        self.active_slot_ticks = 0
        self.prefill_chunks = 0
        self.metrics_every = max(1, metrics_every)
        self.paged = bool(prefix_cache or prefill_chunk
                          or draft_params is not None)
        self.prefix_cache, self.prefill_chunk = prefix_cache, prefill_chunk
        if not self.paged:
            self._caches = C.init_slot_caches(transformer, cfg, num_slots,
                                              max_seq, device=self.device)
            return
        if prefill_chunk is not None and prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1: {prefill_chunk}")
        self.page_size = page_size
        self.slot_pages = PG.pages_for(max_seq, page_size)
        self.num_pages = num_pages or 1 + num_slots * self.slot_pages
        self._pool = PG.init_page_pool(transformer, cfg, self.num_pages,
                                       page_size, device=self.device)
        self.pages = PG.PageTable(self.num_pages, page_size)
        self.page_map = np.zeros((num_slots, self.slot_pages), np.int64)
        self._owned = [[] for _ in range(num_slots)]
        self.cursor = np.full(num_slots, -1, np.int64)   # -1: not prefill
        self.plen = np.zeros(num_slots, np.int64)
        self.spec = None
        if draft_params is not None:
            if not sampling.greedy:
                raise ValueError(
                    "speculative decoding is greedy-only (acceptance "
                    "compares argmax streams) — use GREEDY sampling")
            self.spec = DraftWorker(
                draft_params, draft_cfg, draft_policy, compress=compress,
                num_slots=num_slots, max_seq=max_seq,
                buckets=list(self.buckets), spec_k=spec_k,
                device=self.device)

    # -- device steps ---------------------------------------------------------

    def _insert(self, tokens, pad: int, slot: int, gen):
        """Prefill one request at its bucket length and splice its KV into
        ``slot``; returns its first sampled token (a device scalar)."""
        logits, one = transformer.prefill(
            self.params, _make_batch(self.cfg, host_ints(tokens, self.device)),
            self.cfg, self.policy, cache_len=self.max_seq,
            compress=self.compress, pad_len=host_ints([pad], self.device),
            wire=True)
        C.write_slot(self._caches, one, slot)
        return sample_tokens(logits.reshape(1, -1), [gen], self.sampling)[0]

    def _decode(self, tokens, pos, pad):
        """One tick for every slot: per-slot position, pad and generator.
        Inactive slots decode garbage into their own row only; it is never
        valid under the position mask and is overwritten by the next
        refill."""
        logits, self._caches = transformer.decode_step(
            self.params, tokens, self._caches, pos, self.cfg, self.policy,
            compress=self.compress, pad_len=pad, wire=True)
        return sample_tokens(logits, self._gens, self.sampling)

    def _decode_chunk(self, active: np.ndarray):
        """``tick_chunk`` decode ticks with the tokens kept on the device:
        inactive slots' tokens and positions are frozen (their garbage
        writes stay in their own row).  Returns the (chunk, B) token
        history after ONE host sync."""
        tokens = host_ints(self.last_tok, self.device)
        pos = host_ints(self.pos, self.device)
        pad = host_ints(self.pad, self.device)
        step = host_ints(active, self.device)
        act = step.bool()
        hist = []
        for _ in range(self.tick_chunk):
            toks = self._decode(tokens, pos, pad)
            tokens = torch.where(act, toks, tokens)
            pos = pos + step
            hist.append(tokens)
        return torch.stack(hist).cpu().numpy()

    # -- streaming API --------------------------------------------------------

    def submit(self, prompt, max_new_tokens: int = 16,
               eos_token: Optional[int] = None, seed: int = 0) -> int:
        """Queue a request; returns its request id."""
        prompt = np.asarray(prompt, np.int64)
        if self.paged:
            k = self.spec.spec_k if self.spec else 0
            need = len(prompt) + max_new_tokens + k
            if need > self.max_seq:
                raise ValueError(
                    f"prompt {len(prompt)} + {max_new_tokens} new tokens"
                    + (f" + spec_k {k}" if k else "")
                    + f" exceeds max_seq={self.max_seq}")
            if PG.pages_for(need, self.page_size) > self.num_pages - 1:
                raise ValueError(
                    f"request needs {PG.pages_for(need, self.page_size)} "
                    f"pages; pool has {self.num_pages - 1}")
            if self.spec:
                bucket = C.bucket_for(len(prompt), self.buckets)
                if bucket + max_new_tokens + k > self.max_seq:
                    raise ValueError(
                        f"draft bucket {bucket} + {max_new_tokens} new + "
                        f"spec_k {k} exceeds draft max_seq={self.max_seq}")
        else:
            bucket = C.bucket_for(len(prompt), self.buckets)
            if bucket + max_new_tokens - 1 > self.max_seq:
                raise ValueError(
                    f"prompt bucket {bucket} + {max_new_tokens} new tokens "
                    f"exceeds max_seq={self.max_seq}")
        return self.sched.submit(prompt, max_new_tokens, eos_token,
                                 seed).req_id

    @torch.inference_mode()
    def step(self) -> List[ServeRequest]:
        """One engine tick: refill free slots from the queue (bucketed
        prefill per new request, or one prefill chunk per prefilling slot
        in paged mode), then one decode step for every decoding slot.
        Returns the requests that completed this tick."""
        finished = self._step_paged() if self.paged else self._step_slab()
        self._trace_tick(finished)
        return finished

    def _trace_tick(self, finished: List[ServeRequest]) -> None:
        """Per-tick telemetry: scheduler occupancy (+ page-pool occupancy
        and prefix-hit counters in paged mode) as counter tracks every
        ``metrics_every`` ticks, one instant per completed request
        carrying its TTFT and decode rate.  Host arithmetic on state the
        tick already computed; a disabled tracer returns on the first
        line."""
        tr = trace.get_tracer()
        if tr is None:
            return
        for r in finished:
            tr.instant("serve.request_done", cat="serve",
                       tokens=len(r.tokens), ttft_s=round(r.ttft_s, 6),
                       decode_tok_per_s=round(r.decode_tok_per_s, 2))
        if self.ticks % self.metrics_every:
            return
        tr.counter("serve.sched", cat="serve", **self.sched.snapshot())
        if self.paged:
            ps = self.pages.stats()
            tr.counter("serve.pages", cat="serve",
                       **{k: ps[k] for k in
                          ("active_pages", "cached_pages", "free_pages",
                           "cow_copies", "prefix_hits",
                           "prefix_hit_tokens")})

    def _step_slab(self) -> List[ServeRequest]:
        """The slab-cache tick body of :meth:`step`."""
        finished = []
        fills = self.sched.fills()
        if fills:
            with trace.span("serve.prefill", cat="serve", slots=len(fills)):
                for slot, req in fills:
                    done = self._fill_slab(slot, req)
                    if done is not None:
                        finished.append(done)
        active = self.sched.active_slots
        if not active:
            return finished
        reqs = [self.sched.slots[s] for s in active]
        min_rem = min(r.max_new_tokens - len(r.tokens) for r in reqs)
        chunkable = (self.tick_chunk > 1
                     and min_rem >= self.tick_chunk
                     and all(r.eos_token is None for r in reqs))
        with trace.span("serve.decode", cat="serve", slots=len(active),
                        ticks=self.tick_chunk if chunkable else 1):
            finished.extend(self._slab_decode(active, chunkable))
        return finished

    def _fill_slab(self, slot: int, req: ServeRequest
                   ) -> Optional[ServeRequest]:
        """Prefill ``req`` at its bucket length into ``slot`` and sample
        its first token; a 1-token request completes right here."""
        bucket = C.bucket_for(len(req.prompt), self.buckets)
        toks = np.zeros((1, bucket), np.int64)
        toks[0, bucket - len(req.prompt):] = req.prompt
        pad = bucket - len(req.prompt)
        self._gens[slot] = request_key(req.seed, self.device)
        tok = self._insert(toks, pad, slot, self._gens[slot])
        self.pos[slot] = bucket
        self.pad[slot] = pad
        self.last_tok[slot] = int(tok)          # blocks => honest TTFT
        done = self.sched.started(slot, int(self.last_tok[slot]))
        if done is not None:
            self._free_slab(slot)
        return done

    def _slab_decode(self, active, chunkable) -> List[ServeRequest]:
        finished = []
        if chunkable:
            # no slot can complete inside the chunk and none watches for
            # EOS => tick_chunk decode steps, one sync
            mask = np.zeros(self.num_slots, bool)
            mask[active] = True
            hist = self._decode_chunk(mask)                 # (chunk, B)
            self.ticks += self.tick_chunk
            self.active_slot_ticks += self.tick_chunk * len(active)
            for slot in active:
                self.pos[slot] += self.tick_chunk
                self.last_tok[slot] = hist[-1, slot]
                for t in hist[:, slot]:
                    done = self.sched.token(slot, t)
                    if done is not None:                    # only the last
                        finished.append(done)
                        self._free_slab(slot)
            return finished
        toks = self._decode(host_ints(self.last_tok, self.device),
                            host_ints(self.pos, self.device),
                            host_ints(self.pad, self.device)).cpu().numpy()
        self.ticks += 1
        self.active_slot_ticks += len(active)
        for slot in active:
            self.pos[slot] += 1
            self.last_tok[slot] = toks[slot]
            done = self.sched.token(slot, toks[slot])
            if done is not None:
                finished.append(done)
                self._free_slab(slot)
        return finished

    def _free_slab(self, slot: int) -> None:
        """A finished slot idles at position 0 with no padding: a request
        that filled the cache leaves ``pos == max_seq``, one row past it,
        where the next tick's garbage write would land."""
        self.pos[slot] = 0
        self.pad[slot] = 0

    # -- paged mode: admission / chunked prefill / decode / speculation ------

    def _can_place(self, req: ServeRequest) -> bool:
        """Admission gate: enough pages (free + LRU-evictable) to cover the
        request's whole span.  Conservative — a prefix hit only reduces
        the fresh-page need."""
        k = self.spec.spec_k if self.spec else 0
        need = PG.pages_for(len(req.prompt) + req.max_new_tokens + k,
                            self.page_size)
        return self.pages.available() >= need

    def _place(self, slot: int, req: ServeRequest) -> None:
        """Claim pages for the whole span [0, L + max_new (+ spec_k)),
        splice any cached prefix in front, and start the prefill cursor
        after the matched tokens."""
        L = len(req.prompt)
        k = self.spec.spec_k if self.spec else 0
        matched = (self.pages.match_prefix(req.prompt)
                   if self.prefix_cache else [])
        n_need = PG.pages_for(L + req.max_new_tokens + k, self.page_size)
        row = np.zeros(self.slot_pages, np.int64)
        row[:len(matched)] = matched
        owned = list(matched)
        for j in range(len(matched), n_need):
            pid = self.pages.alloc()
            row[j] = pid
            owned.append(pid)
        self.page_map[slot] = row
        self._owned[slot] = owned
        self.cursor[slot] = len(matched) * self.page_size
        self.plen[slot] = L

    def _release(self, slot: int) -> None:
        self.pages.release(self._owned[slot])
        self._owned[slot] = []
        self.page_map[slot] = 0
        self.cursor[slot] = -1
        self.pos[slot] = 0

    def _prefill_tick(self, slot: int) -> Optional[ServeRequest]:
        """Advance one prefill chunk for ``slot``.  On the final chunk,
        sample the first token (TTFT) from the last valid position's
        logits, index the prompt's full pages for sharing, and prefill the
        draft; a 1-token request can complete right here."""
        req = self.sched.slots[slot]
        L, cur = int(self.plen[slot]), int(self.cursor[slot])
        c = self.prefill_chunk or C.bucket_for(L - cur, self.buckets)
        cl = min(c, L - cur)
        toks = np.zeros((1, c), np.int64)
        toks[0, :cl] = req.prompt[cur:cur + cl]
        logits, self._pool = transformer.decode_span(
            self.params, host_ints(toks, self.device), self._pool,
            host_ints([cur], self.device), self.cfg, self.policy,
            compress=self.compress,
            page_map=host_ints(self.page_map[slot:slot + 1], self.device),
            valid_len=host_ints([cl], self.device), wire=True)
        self.prefill_chunks += 1
        cur += cl
        if cur < L:
            self.cursor[slot] = cur
            return None
        self._gens[slot] = request_key(req.seed, self.device)
        tok = sample_tokens(logits[:, cl - 1], [self._gens[slot]],
                            self.sampling)[0]
        self.cursor[slot] = -1
        self.pos[slot] = L
        self.last_tok[slot] = int(tok)          # blocks => honest TTFT
        if self.prefix_cache:
            full = (L - 1) // self.page_size
            self.pages.register_prefix(
                req.prompt, [int(p) for p in self.page_map[slot, :full]])
        if self.spec:
            self.spec.insert(slot, req.prompt)
        done = self.sched.started(slot, int(self.last_tok[slot]))
        if done is not None:
            self._release(slot)
        return done

    def _cow_guard(self, slots: List[int], span: int) -> None:
        """Before a decode tick writes positions [pos, pos + span), route
        every logical page FIRST touched this tick through
        ``PageTable.writable`` — a shared or prefix-indexed page is
        copy-on-write swapped for a private one.  The engine's own
        invariants (prefix match capped at full prompt pages, decode
        pages allocated fresh) make a copy rare, but the gate is what
        guarantees a shared page is never written in place."""
        p = self.page_size
        for s in slots:
            t = int(self.pos[s])
            for j in range(-(-t // p), (t + span - 1) // p + 1):
                pid = int(self.page_map[s, j])
                if pid == PG.TRASH_PAGE:
                    continue            # beyond the allocated span
                new, copy = self.pages.writable(pid)
                if new != pid:
                    if copy:
                        PG.copy_pages(self._pool, pid, new)
                    self.page_map[s, j] = new
                    own = self._owned[s]
                    own[own.index(pid)] = new

    def _step_paged(self) -> List[ServeRequest]:
        """One paged tick: admit while pages last, advance ONE chunk per
        prefilling slot, then one decode (or speculative) tick for every
        decoding slot — prefill chunks interleave with decode instead of
        stalling it."""
        finished = []
        for slot, req in self.sched.fills(self._can_place):
            self._place(slot, req)
        pref = [s for s in self.sched.active_slots if self.cursor[s] >= 0]
        if pref:
            with trace.span("serve.prefill", cat="serve", slots=len(pref)):
                for slot in pref:
                    done = self._prefill_tick(slot)
                    if done is not None:
                        finished.append(done)
                if (self.device.type == "cuda"
                        and trace.get_tracer() is not None):
                    # a chunk that samples no token syncs nothing: the
                    # span waits for the card so that it holds the work
                    torch.cuda.synchronize(self.device)
        dec = [s for s in self.sched.active_slots if self.cursor[s] < 0]
        if not dec:
            return finished
        span = 1 + (self.spec.spec_k if self.spec else 0)
        self._cow_guard(dec, span)
        toks = self.last_tok.copy()
        posv = np.zeros(self.num_slots, np.int64)
        pmap = np.zeros_like(self.page_map)
        posv[dec] = self.pos[dec]
        pmap[dec] = self.page_map[dec]
        self.ticks += 1
        self.active_slot_ticks += len(dec)
        if self.spec:
            with trace.span("serve.spec", cat="serve", slots=len(dec),
                            spec_k=self.spec.spec_k):
                finished.extend(self._spec_tick(dec, toks, posv, pmap))
            return finished
        with trace.span("serve.decode", cat="serve", slots=len(dec),
                        ticks=1):
            logits, self._pool = transformer.decode_span(
                self.params, host_ints(toks, self.device)[:, None],
                self._pool, host_ints(posv, self.device), self.cfg,
                self.policy, compress=self.compress,
                page_map=host_ints(pmap, self.device), wire=True)
            gens = [g if s in dec else None
                    for s, g in enumerate(self._gens)]
            t_np = sample_tokens(logits[:, 0], gens,
                                 self.sampling).cpu().numpy()
        for s in dec:
            self.pos[s] += 1
            self.last_tok[s] = t_np[s]
            done = self.sched.token(s, t_np[s])
            if done is not None:
                finished.append(done)
                self._release(s)
        return finished

    def _spec_tick(self, dec, toks, posv, pmap) -> List[ServeRequest]:
        """Draft proposes k tokens per slot; target verifies all k+1
        positions in one span; the longest matching prefix (bonus capped
        at k, see speculative.accept_greedy) is emitted.  Every emitted
        token is the target's own argmax — output is plain greedy's."""
        finished = []
        k = self.spec.spec_k
        props = self.spec.propose(toks)                     # (B, k)
        span = np.concatenate([toks[:, None], props], 1)    # (B, k+1)
        logits, self._pool = transformer.decode_span(
            self.params, host_ints(span, self.device), self._pool,
            host_ints(posv, self.device), self.cfg, self.policy,
            compress=self.compress, page_map=host_ints(pmap, self.device),
            wire=True)
        g_np = torch.argmax(logits.to(torch.float32), dim=-1).cpu().numpy()
        for s in dec:
            a = accept_greedy(props[s], g_np[s], k)
            self.spec.record(k, a)
            req = self.sched.slots[s]
            e = min(a + 1, k, req.max_new_tokens - len(req.tokens))
            e = max(e, 1)
            used, done = 0, None
            for tok in g_np[s, :e]:
                used += 1
                done = self.sched.token(s, int(tok))
                if done is not None:
                    break
            self.pos[s] += used
            self.last_tok[s] = int(g_np[s, used - 1])
            self.spec.commit(s, used)
            if done is not None:
                finished.append(done)
                self._release(s)
        return finished

    def drain(self) -> List[ServeRequest]:
        """Run steps until queue and slots are empty; returns everything
        that finished during the drain (in completion order)."""
        out = []
        while not self.sched.idle:
            out.extend(self.step())
        return out

    def warmup(self) -> dict:
        """Serve dummy requests at every prompt bucket (and run the
        multi-tick decode once), which builds the kernels and warms the
        libraries, then reset the scheduler and the metrics.  Returns
        ``{"warm_s": seconds}``."""
        t0 = time.perf_counter()
        if self.paged:
            self._warmup_paged()
        else:
            for b in self.buckets:
                new = min(self.tick_chunk + 2, self.max_seq - b + 1)
                self.submit(np.zeros(b, np.int64), max_new_tokens=new)
            self.drain()
            if self.tick_chunk > 1:
                # an all-inactive mask freezes every slot's token and
                # position; only garbage rows invalid under the position
                # mask are written
                with torch.inference_mode():
                    self._decode_chunk(np.zeros(self.num_slots, bool))
            self.sched = Scheduler(self.num_slots)
            self.ticks = self.active_slot_ticks = 0
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return {"warm_s": time.perf_counter() - t0}

    def _warmup_paged(self) -> None:
        """Serve dummy requests at every chunk shape (prefix matching off,
        so every shape really runs), then reset the scheduler, the page
        table and all metrics."""
        k = self.spec.spec_k if self.spec else 0
        prefix, self.prefix_cache = self.prefix_cache, False
        lens = {b for b in self.buckets if b + 2 + k <= self.max_seq}
        for n in sorted(lens):
            self.submit(np.zeros(n, np.int64), max_new_tokens=2)
        self.drain()
        self.prefix_cache = prefix
        self.pages = PG.PageTable(self.num_pages, self.page_size)
        self.page_map[:] = 0
        self._owned = [[] for _ in range(self.num_slots)]
        self.cursor[:] = -1
        self.pos[:] = 0
        self.last_tok[:] = 0
        self.sched = Scheduler(self.num_slots)
        self.ticks = self.active_slot_ticks = self.prefill_chunks = 0
        if self.spec:
            self.spec.proposed = self.spec.accepted = 0

    # -- metrics --------------------------------------------------------------

    def stats(self) -> dict:
        s = self.sched.stats()
        s.update({
            "ticks": self.ticks,
            "slot_utilization": (round(
                self.active_slot_ticks / (self.ticks * self.num_slots), 3)
                if self.ticks else 0.0),
            "slot_cache_bytes": (
                PG.pool_bytes(self._pool) // self.num_slots if self.paged
                else C.slot_bytes(self._caches, self.num_slots)),
            "boundary_bytes_per_tok": (
                round(boundary_wire_bytes_per_token(
                    self.policy, self.cfg.d_model,
                    num_cuts=max(0, len(transformer.segment_bounds(
                        self.cfg.num_groups,
                        self.policy.num_stages)) - 1)), 1)
                if self.compress else 0.0),
            "sampling": self.sampling.name,
        })
        if self.paged:
            s["prefill_chunks"] = self.prefill_chunks
            s["prefill_chunk"] = self.prefill_chunk or 0
            s.update(self.pages.stats())
            if self.spec:
                s.update(self.spec.stats())
        return s
