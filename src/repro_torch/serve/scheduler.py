"""Continuous-batching scheduler: admission queue + per-slot lifecycle.

Port of ``repro/serve/scheduler.py``, a copy (host-side numpy, no torch).
The engine owns the device work; the scheduler owns WHO runs WHERE:

  submit(..)        -> request enters the FIFO admission queue
  fills()           -> (slot, request) placements for every free slot
  started(..)       -> request is prefilled and decoding (records TTFT)
  token(..)         -> append a decoded token; reports completion
                       (EOS or max_new_tokens)
  finished(..)      -> slot freed (immediately refillable), request done

Completion semantics: the EOS token, when configured, is appended to the
output and ends the request (the standard "include the stop token" rule);
``max_new_tokens`` bounds the output length either way.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Deque, List, Optional, Tuple

import numpy as np

FREE, ACTIVE = "free", "active"


@dataclasses.dataclass
class ServeRequest:
    """One generation request and its per-request serve metrics."""
    req_id: int
    prompt: np.ndarray                    # (L,) int32
    max_new_tokens: int = 16
    eos_token: Optional[int] = None
    seed: int = 0
    # -- lifecycle / results (filled by the scheduler) ----------------------
    tokens: List[int] = dataclasses.field(default_factory=list)
    submit_t: float = 0.0
    first_token_t: float = 0.0
    finish_t: float = 0.0
    slot: int = -1

    @property
    def out(self) -> np.ndarray:
        return np.asarray(self.tokens, np.int32)

    @property
    def ttft_s(self) -> float:
        """Submit -> first token (queue wait + prefill)."""
        return self.first_token_t - self.submit_t

    @property
    def decode_tok_per_s(self) -> float:
        dt = self.finish_t - self.first_token_t
        n = len(self.tokens) - 1                  # tokens after the first
        return n / dt if dt > 0 and n > 0 else 0.0

    def metrics(self) -> dict:
        return {"req_id": self.req_id, "prompt_len": int(len(self.prompt)),
                "new_tokens": len(self.tokens),
                "ttft_s": round(self.ttft_s, 4),
                "decode_tok_per_s": round(self.decode_tok_per_s, 1)}


class Scheduler:
    """FIFO admission over ``num_slots`` decode slots."""

    def __init__(self, num_slots: int):
        self.num_slots = num_slots
        self.queue: Deque[ServeRequest] = deque()
        self.slots: List[Optional[ServeRequest]] = [None] * num_slots
        self.done: List[ServeRequest] = []
        self._next_id = 0

    # -- admission ----------------------------------------------------------

    def submit(self, prompt: np.ndarray, max_new_tokens: int = 16,
               eos_token: Optional[int] = None, seed: int = 0,
               now: Optional[float] = None) -> ServeRequest:
        req = ServeRequest(self._next_id, np.asarray(prompt, np.int32),
                           max_new_tokens, eos_token, seed,
                           submit_t=time.time() if now is None else now)
        if req.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        self._next_id += 1
        self.queue.append(req)
        return req

    def fills(self, can_place=None) -> List[Tuple[int, ServeRequest]]:
        """Pop queued requests into free slots (FIFO, lowest slot first).

        ``can_place(req) -> bool``: optional admission gate (e.g. "enough
        KV pages free").  Admission stops at the first non-placeable
        request — later queue entries never jump the FIFO order.
        """
        placements = []
        for slot in range(self.num_slots):
            if not self.queue:
                break
            if self.slots[slot] is None:
                if can_place is not None and not can_place(self.queue[0]):
                    break
                req = self.queue.popleft()
                req.slot = slot
                self.slots[slot] = req
                placements.append((slot, req))
        return placements

    # -- per-tick lifecycle -------------------------------------------------

    def started(self, slot: int, first_token: int,
                now: Optional[float] = None) -> Optional[ServeRequest]:
        """Prefill produced the request's first token (TTFT point)."""
        req = self.slots[slot]
        req.first_token_t = time.time() if now is None else now
        return self._append(req, first_token, req.first_token_t)

    def token(self, slot: int, token: int,
              now: Optional[float] = None) -> Optional[ServeRequest]:
        """A decode tick produced ``token`` for ``slot``.  Returns the
        request iff it just completed (slot is freed for refill)."""
        return self._append(self.slots[slot], token,
                            time.time() if now is None else now)

    def _append(self, req: ServeRequest, token: int,
                now: float) -> Optional[ServeRequest]:
        req.tokens.append(int(token))
        eos = req.eos_token is not None and int(token) == req.eos_token
        if eos or len(req.tokens) >= req.max_new_tokens:
            req.finish_t = now
            self.slots[req.slot] = None
            self.done.append(req)
            return req
        return None

    # -- state --------------------------------------------------------------

    @property
    def active_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.slots) if r is not None]

    @property
    def idle(self) -> bool:
        return not self.queue and not any(self.slots)

    def snapshot(self) -> dict:
        """Instantaneous occupancy counters — the per-tick telemetry grain
        (:func:`stats` aggregates the whole run; this is one moment).
        Cheap enough to call every tick: pure host-side len() arithmetic."""
        active = len(self.active_slots)
        return {
            "queued": len(self.queue),
            "active_slots": active,
            "free_slots": len(self.slots) - active,
            "completed": len(self.done),
        }

    def stats(self) -> dict:
        done = self.done
        return {
            "completed": len(done),
            "queued": len(self.queue),
            "active": len(self.active_slots),
            "mean_ttft_s": (round(float(np.mean([r.ttft_s for r in done])), 4)
                            if done else 0.0),
            "mean_decode_tok_per_s": (
                round(float(np.mean([r.decode_tok_per_s for r in done])), 1)
                if done else 0.0),
        }
