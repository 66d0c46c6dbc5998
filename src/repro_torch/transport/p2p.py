"""Stage ranks: one process a pipeline stage, payloads over point-to-point.

The port's counterpart of the mesh axis that the reference's ``ppermute``
runs over (``repro/transport/pipeline.py``).  :class:`StageGroup` joins
this process to a ``torch.distributed`` group of ``world`` ranks, one a
pipeline stage, and moves the rank-per-stage pipeline's payloads
(``transport/pipeline.py::pipeline_apply_rank``) between them.  Both ends
know every payload's struct in advance (the codec's ``payload_struct`` of
the cut's feature shape), so only the payload's bytes cross: no size
header, no pickled metadata.

The caller names the backend; nothing switches between them silently.

  * ``"nccl"``: one card a rank, the rank with local rank ``r`` (its rank
    on its own node) on that node's ``cuda:r``, the payloads sent from the
    card.  Ranks may span nodes.  Two ranks on one card are refused before
    the group is made (NCCL cannot run them).
  * ``"gloo"``: any machine.  Gloo sends host tensors only, so a rank on a
    card STAGES every payload through pinned host memory: each leaf's
    bytes are copied to a pinned host buffer (a copy that waits for the
    card), sent, received into a pinned host buffer and copied back to
    the card.  A rank on the CPU sends its tensors as they are.

:meth:`StageGroup.exchange` posts all of one pipeline tick's sends and
receives of this rank together (``dist.batch_isend_irecv``) and waits for
them.  Every rank walks the same ticks and each send pairs with a receive
posted at the same tick, so no schedule can hang on the order of its hops:
interleaved's wrap-around hop from the last rank to rank 0 included.
The group is made with a timeout of ``TIMEOUT_S`` (60 s), so a hang
fails.

  group = StageGroup(rank, world, "gloo", device="cpu",
                     init_method="file:///tmp/stage_store")
  moved = group.recv_payload(struct, src=rank - 1)
"""
from __future__ import annotations

import datetime
from typing import Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.device import stage_device
from repro_torch.transport.codecs import (LeafStruct, _bytes_to_leaf,
                                          _leaf_bytes, _leaf_nbytes,
                                          payload_leaves, tree_unflatten)

BACKENDS = ("gloo", "nccl")
TIMEOUT_S = 60.0


class StageGroup:
    """This process's place in a rank-per-stage pipeline: ``rank`` of
    ``world``, its ``device`` (``device.py::stage_device`` of its local
    rank) and the ``backend``'s process group.  ``local_rank`` /
    ``local_world``: its rank on its node and that node's count of ranks
    (``LOCAL_RANK`` / ``LOCAL_WORLD_SIZE`` under ``torch.distributed.run``);
    by default ``rank`` / ``world``, all ranks on one node.
    ``init_method``: ``"env://"`` (the variables ``torch.distributed.run``
    sets) or a ``file://`` store.  Close it (or use it as a context
    manager) to leave the group."""

    def __init__(self, rank: int, world: int, backend: str, device=None, *,
                 init_method: str = "env://", local_rank=None,
                 local_world=None):
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; name one of "
                             f"{BACKENDS}")
        if not 0 <= rank < world:
            raise ValueError(f"rank {rank} is not in a group of {world}")
        self.rank, self.world, self.backend = rank, world, backend
        local_rank = rank if local_rank is None else local_rank
        local_world = world if local_world is None else local_world
        self.device = stage_device(local_rank, device)
        if backend == "nccl":
            if self.device.type != "cuda":
                raise ValueError(
                    "backend='nccl' sends from cards: pass a CUDA device, or "
                    "backend='gloo' for ranks on the CPU")
            cards = torch.cuda.device_count()
            if cards < local_world or self.device.index != local_rank:
                raise ValueError(
                    f"backend='nccl' takes one card a rank: {local_world} "
                    f"ranks on a node of {cards} card(s) would put two "
                    f"ranks on one card (rank {rank}, local rank "
                    f"{local_rank}, asked for {self.device}), and NCCL "
                    "refuses that; run backend='gloo' (payloads staged "
                    "through the host) or use as many cards as ranks")
        if self.device.type == "cuda":
            # the rank's current device, also for autograd's device thread
            torch.cuda.set_device(self.device)
        # gloo moves host tensors only: a rank on a card stages its payloads
        self.staged = backend == "gloo" and self.device.type == "cuda"
        dist.init_process_group(
            backend, init_method=init_method, rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=TIMEOUT_S))
        # every rank joins once here, so that later batches of sends and
        # receives may involve only some of the ranks
        self.all_reduce_ints([1])

    # -- lifetime -------------------------------------------------------------

    def close(self) -> None:
        if dist.is_initialized():
            dist.destroy_process_group()

    def __enter__(self) -> "StageGroup":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- point to point -------------------------------------------------------

    def _wire(self) -> torch.device:
        """Where the tensors handed to the backend live."""
        return torch.device("cpu") if self.staged else self.device

    def _outgoing(self, leaf: torch.Tensor) -> torch.Tensor:
        """One leaf's bytes as the backend sends them: a flat uint8 view
        of the leaf, or its copy in pinned host memory when staged."""
        raw = _leaf_bytes(leaf)
        if not self.staged:
            return raw
        host = torch.empty(raw.shape, dtype=torch.uint8, pin_memory=True)
        host.copy_(raw)
        return host

    def _landing(self, s: LeafStruct) -> torch.Tensor:
        return torch.empty((_leaf_nbytes(s),), dtype=torch.uint8,
                           device=self._wire(), pin_memory=self.staged)

    def _arrived(self, buf: torch.Tensor, s: LeafStruct) -> torch.Tensor:
        if self.staged:
            buf = buf.to(self.device, non_blocking=True)
        return _bytes_to_leaf(buf, s)

    def exchange(self, sends: Sequence[Tuple[int, object]] = (),
                 recvs: Sequence[Tuple[int, object]] = ()) -> list:
        """Send each ``(dst, payload)`` of ``sends`` (a tensor or a tree of
        tensors, leaf by leaf in ``payload_leaves`` order) and receive each
        ``(src, struct)`` of ``recvs`` (a :class:`LeafStruct` tree), all
        posted as one batch, and wait for them.  Returns one payload tree a
        ``recvs`` entry, on this rank's device.  Between two ranks the
        payloads pair in the order both sides list them."""
        ops = []
        for dst, payload in sends:
            for leaf in payload_leaves(payload):
                if leaf.numel():
                    ops.append(dist.P2POp(dist.isend, self._outgoing(leaf),
                                          dst))
        landed = []
        for src, struct in recvs:
            bufs = []
            for s in payload_leaves(struct):
                bufs.append((self._landing(s), s))
                if bufs[-1][0].numel():
                    ops.append(dist.P2POp(dist.irecv, bufs[-1][0], src))
            landed.append((struct, bufs))
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        return [tree_unflatten(struct, iter([self._arrived(b, s)
                                             for b, s in bufs]))
                for struct, bufs in landed]

    def send_payload(self, payload, dst: int) -> None:
        """Send one payload to rank ``dst`` and wait for it."""
        self.exchange(sends=[(dst, payload)])

    def recv_payload(self, struct, src: int):
        """Receive one payload of the :class:`LeafStruct` tree ``struct``
        from rank ``src``."""
        return self.exchange(recvs=[(src, struct)])[0]

    # -- reductions -----------------------------------------------------------

    def all_reduce_ints(self, values) -> list:
        """Every rank's ``values`` (Python ints) summed element-wise."""
        t = torch.tensor(list(values), dtype=torch.int64, device=self._wire())
        dist.all_reduce(t)
        return [int(v) for v in t.tolist()]

    def all_gather_lengths(self, n: int) -> list:
        """Every rank's ``n``, in rank order."""
        return self.all_reduce_ints([n if r == self.rank else 0
                                     for r in range(self.world)])

    def all_gather_floats(self, vec: torch.Tensor, lens) -> list:
        """Every rank's 1-D float32 ``vec``, in rank order, on this rank's
        device, in one collective.  ``lens``: every rank's length
        (:meth:`all_gather_lengths`, gathered once where they stay fixed)."""
        if vec.numel() != lens[self.rank]:
            raise ValueError(f"rank {self.rank} gathers {vec.numel()} "
                             f"floats, not the {lens[self.rank]} of lens")
        mine = torch.zeros(max(lens), dtype=torch.float32,
                           device=self._wire())
        mine[:vec.numel()] = vec.to(mine.device, torch.float32)
        rows = [torch.empty_like(mine) for _ in range(self.world)]
        dist.all_gather(rows, mine)
        return [r[:k].to(self.device) for r, k in zip(rows, lens)]

