"""Dry run: every (arch x input shape) on the production grids, on the
``meta`` device.

Port of ``repro/launch/dryrun.py``.  The reference lowers and compiles
each combination against ``ShapeDtypeStruct``s on 512 forced host devices
and reads XLA's cost and memory analyses.  The port runs its own step --
``make_lm_train_step`` (simulated cuts, AdamW with bf16 moments),
``prefill`` or ``decode_step`` -- on meta tensors (``launch/
input_specs.py``) under :func:`run_shape_only`, which counts matrix
products and attention as ``torch.utils.flop_counter.FlopCounterMode``
does and refuses any result that is not on ``meta``: the dry run draws,
allocates and computes nothing, on the CPU or the card.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch glm4-9b \\
      --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]
  ... [--policy none|q4q8|top10|top10reuse] [--no-remat] [--json out.json]

One JSON line per combination, then ``# n/m OK``; the exit code is 1 if
any combination failed.  Keys that mean what the reference's mean keep
its names: ``arch``, ``shape``, ``policy``, ``mesh``, ``devices``,
``skipped``, ``reason``, ``error``, ``model_flops`` (6 or 2 x active
params x tokens) and ``argument_bytes`` (what one lane holds of the
step's arguments under ``sharding/specs.py``).  The port's own counts:

  matmul_flops_global  FlopCounterMode's count over the whole step, every
                       layer and chunk loop included: matrix products and
                       attention only (XLA's ``flops`` counts every op, so
                       the two are different quantities)
  run_s                the meta run's seconds

Left out, with the reason: the compile time, ``temp_bytes`` /
``peak_bytes`` (XLA's buffer assignment), ``flops_scanned_global`` /
``flops_unrolled_global`` (the port's layer stacks are Python loops,
counted in full; no ``scan_config`` switch), and ``collectives``: on the
simulated cuts the port partitions nothing, so the step sends nothing.
:func:`collective_bytes` / :func:`collective_counts` read the wire events
of a traced step instead of HLO (a pipeline, DP or tensor-axis step run
under :func:`run_shape_only` or for real under :func:`wire_record`).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
import time
from typing import Dict, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.configs.registry import ARCHS, ASSIGNED, get
from repro_torch.core.parallel import ParallelSpec
from repro_torch.core.policy import (CompressionPolicy, NO_POLICY,
                                     quant_policy, topk_policy)
from repro_torch.launch import mesh as meshlib
from repro_torch.launch.input_specs import (SHAPES, InputShape, applicable,
                                            batch_specs, decode_specs,
                                            ids_spec, model_module,
                                            param_specs)
from repro_torch.launch.mesh import LaneGrid
from repro_torch.models.config import active_param_count
from repro_torch.obs import trace
from repro_torch.obs.probes import pairs_key, ring_pairs
from repro_torch.optim.optimizers import OptimizerConfig, init_opt_state
from repro_torch.sharding import ctx
from repro_torch.sharding.specs import (batch_shardings, cache_shardings,
                                        device_bytes, opt_state_shardings,
                                        param_shardings, replicated)
from repro_torch.train.loop import init_lm_dp_state
from repro_torch.train.steps import make_lm_train_step
from repro_torch.transport.tp_collectives import init_tp_state

POLICIES: Dict[str, CompressionPolicy] = {
    "none": NO_POLICY,
    "q4q8": CompressionPolicy(num_stages=4, boundary=quant_policy(4, 8)),
    "top10": CompressionPolicy(num_stages=4, boundary=topk_policy(0.10)),
    "top10reuse": CompressionPolicy(
        num_stages=4, boundary=topk_policy(0.10, reuse_indices=True)),
}

_ATOMS = (int, float, bool, str, type(None), torch.dtype, torch.device,
          torch.memory_format, torch.layout)


def _sig(a):
    """What an op's output metadata can depend on: each tensor's shape,
    strides, dtype and device, and every other argument's type and value."""
    if isinstance(a, torch.Tensor):
        return (a.shape, a.stride(), a.dtype, a.device.type)
    if isinstance(a, (list, tuple)):
        return tuple(_sig(x) for x in a)
    if isinstance(a, _ATOMS):
        return (type(a), a)
    raise TypeError(type(a))


class _ShapeOnlyMode(TorchDispatchMode):
    """Counts flops as ``FlopCounterMode`` does (its formulas, and its
    decomposition of an op with a CompositeImplicitAutograd kernel) and
    raises on any op result that is not a meta tensor, but for an empty
    one (no bytes: torch's non-reentrant checkpoint makes a (0,) marker).

    Meta kernels of pointwise ops are Python in torch (``torch._refs``),
    ~0.3 ms a call, and the linear-attention chunk loops run a million of
    them at full size.  An op that returns fresh tensors (no alias, no
    mutation) gives the same output shapes, strides and dtypes for the
    same input metadata, so those are kept by input metadata and later
    calls build their outputs with ``torch.empty_strided`` on ``meta``."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self._fresh: Dict = {}          # op -> returns fresh tensors only
        self._no_decomp = set()
        self._memo: Dict = {}

    def _is_fresh(self, func) -> bool:
        got = self._fresh.get(func)
        if got is None:
            s = func._schema
            got = self._fresh[func] = (
                not s.is_mutable and len(s.returns) > 0
                and all(r.alias_info is None and str(r.type) == "Tensor"
                        for r in s.returns))
        return got

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func not in self._no_decomp:
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
            self._no_decomp.add(func)
        key = None
        if self._is_fresh(func):
            try:
                key = (func, _sig(args), _sig(tuple(kwargs.items())))
            except TypeError:
                pass
        got = self._memo.get(key) if key is not None else None
        if got is not None:
            single, metas = got
            outs = tuple(torch.empty_strided(s, st, dtype=d, device="meta")
                         for s, st, d in metas)
            out = outs[0] if single else outs
        else:
            out = func(*args, **kwargs)
            flat = out if isinstance(out, (tuple, list)) else (out,)
            for t in flat:
                if (isinstance(t, torch.Tensor) and not t.is_meta
                        and t.numel()):
                    raise RuntimeError(
                        f"shape-only run: {func} returned a tensor on "
                        f"{t.device}")
            if key is not None and all(isinstance(t, torch.Tensor)
                                       and t.storage_offset() == 0
                                       for t in flat):
                self._memo[key] = (not isinstance(out, (tuple, list)),
                                   [(t.shape, t.stride(), t.dtype)
                                    for t in flat])
        count = flop_registry.get(func._overloadpacket)
        if count is not None:
            self.flops += count(*args, **kwargs, out_val=out)
        return out


@contextlib.contextmanager
def wire_record():
    """Trace the wire events (``pipeline.wire``, ``dp.wire``,
    ``tp.wire``) of what runs in the block into the yielded list.  A step
    emits them at its first call with a new input key (``obs/keyed.py``):
    trace a step object that has not run before."""
    events: List[trace.TraceEvent] = []
    with trace.recording() as tr:
        try:
            yield events
        finally:
            events.extend(e for e in tr.drain() if e.cat == "wire")


@dataclasses.dataclass
class ShapeRun:
    matmul_flops: int        # FlopCounterMode's count
    events: list             # the wire events (see wire_record)
    seconds: float


def run_shape_only(fn, *args, **kwargs) -> ShapeRun:
    """Run ``fn(*args, **kwargs)`` on meta tensors, shape only: count its
    flops, record its wire events, and raise if any op would give a
    tensor with storage."""
    mode = _ShapeOnlyMode()
    t0 = time.perf_counter()
    with wire_record() as events, mode:
        fn(*args, **kwargs)
    return ShapeRun(mode.flops, events, time.perf_counter() - t0)


# ---------------------------------------------------------------------------
# Collectives from the wire record
# ---------------------------------------------------------------------------

def wire_terms(e):
    """(axis, launches, bytes) of one wire event: launches of the axis
    ring in the traced step (a hop of every ring along the axis is one
    launch, as one ``collective-permute`` in the reference's SPMD
    program), and the bytes every lane together puts on the wire.

    The events are the reference's trace-time reports, and the bytes are
    theirs: the step's ``metrics["wire"]`` counts the same for the stage
    ring, the simulated DP ring and the tensor ring alone.  Where the DP
    reduce is split into stage or tensor columns, each column frames its
    own leaves (a few hundred bytes of metadata more than the event's one
    payload), and the 3D step's tensor rings emit no ``tp.wire``."""
    name, a = e.name, e.args
    if name == "pipeline.wire":
        hops = a["microbatches"] * a["wire_cuts"]       # a direction, a row
        launches = hops * (a["launches_per_fw_hop"]
                           + a["launches_per_bw_hop"])
        nbytes = a["dp"] * hops * (a["fw_payload_bytes_per_hop"]
                                   + a["bw_payload_bytes_per_hop"])
        return "stage", launches, nbytes
    if name == "dp.wire":
        rings = a.get("columns", 1) * a.get("tensor_columns", 1)
        return ("data", a["launches_per_hop"] * a["hops_per_reduce"],
                rings * a["dp"] * a["wire_bytes_per_reduce"])
    if name == "tp.wire":
        # a forward's gathers and scatters; a train step's backward sends
        # the same again (each collective's gradient is the other one)
        coll = 2 * a["sites_per_forward"]
        return ("tensor",
                2 * coll * a["hops_per_collective"] * a["launches_per_hop"],
                2 * a["tp"] * a["wire_bytes_per_forward"])
    raise ValueError(f"not a wire event: {name!r}")


def collective_bytes(events) -> Dict[str, int]:
    """Bytes on the wire by op kind in a traced step (every ring of the
    port is a ``collective-permute``, as the reference's are)."""
    total = sum(wire_terms(e)[2] for e in events)
    return {"collective-permute": total} if events else {}


def collective_counts(events, grid: Optional[LaneGrid] = None,
                      by_pairs: bool = False) -> Dict[str, int]:
    """Ring launches by op kind in a traced step; ``by_pairs=True`` keys
    them ``"collective-permute|" + probes.pairs_key(ring_pairs(...))`` of
    the event's axis on ``grid``, the reference's keying, so that a probe
    of one ring and its launches share a key."""
    counts: Dict[str, int] = {}
    for e in events:
        axis, launches, _ = wire_terms(e)
        key = "collective-permute"
        if by_pairs:
            key += "|" + pairs_key(ring_pairs(grid.shape, grid.axis_names,
                                              axis))
        counts[key] = counts.get(key, 0) + launches
    return counts


# ---------------------------------------------------------------------------
# The dry run
# ---------------------------------------------------------------------------

def _adamw() -> OptimizerConfig:
    """The dry run's optimizer: AdamW with bf16 moments."""
    return OptimizerConfig(kind="adamw", lr=1e-4, moment_dtype=torch.bfloat16,
                           weight_decay=0.0, schedule="constant")


def _inputs(cfg, shape: InputShape, device):
    """The batch and ids of ``shape``: the meta specs, or drawn from seed
    0 on a real device (tokens in the vocabulary, N(0, 1) stub
    embeddings)."""
    if torch.device(device).type == "meta":
        return batch_specs(cfg, shape), ids_spec(shape)
    gen = torch.Generator().manual_seed(0)
    batch = {}
    for k, spec in batch_specs(cfg, shape).items():
        if k == "tokens":
            t = torch.randint(0, cfg.vocab_size, tuple(spec.shape),
                              generator=gen, dtype=spec.dtype)
        else:
            t = torch.randn(tuple(spec.shape), generator=gen).to(spec.dtype)
        batch[k] = t.to(device)
    ids = torch.arange(shape.batch, dtype=torch.int32, device=device)
    return batch, ids


def train_case(cfg, shape: InputShape, policy: CompressionPolicy, device, *,
               parallel: Optional[ParallelSpec] = None,
               pipeline_microbatches: Optional[int] = None,
               remat: bool = True):
    """A train step of ``cfg`` at ``shape`` and its arguments: on
    ``meta`` the dry run's (params and inputs shape only), on a real
    device params and inputs drawn from seed 0.  ``parallel``: the
    data / stage / tensor grid (a stage axis trains through the pipeline,
    with ``policy`` cut into its stages; the tensor axis without one
    takes a cut-free policy).  Feedback-free policies only (the
    reference's dry run passes no boundary state).  Returns ``(step,
    args)``; the step is new, so its first traced call emits its wire
    events."""
    opt = _adamw()
    if torch.device(device).type == "meta":
        params = param_specs(cfg)
    else:
        params = model_module(cfg).init_params(
            torch.Generator(device=device).manual_seed(0), cfg)
    batch, ids = _inputs(cfg, shape, device)
    args = [params, init_opt_state(opt, params), [], batch, ids]
    kw = {}
    if parallel is not None:
        transport = "pipeline" if parallel.stages > 1 else "simulated"
        if transport == "pipeline":
            policy = dataclasses.replace(policy, num_stages=parallel.stages)
        kw = dict(parallel=parallel, transport=transport,
                  pipeline_microbatches=pipeline_microbatches)
        if parallel.dp > 1:
            args.append(init_lm_dp_state(cfg, params, policy, parallel.dp,
                                         parallel.data.feedback,
                                         transport=transport,
                                         tp=parallel.tp))
        if parallel.tp > 1 and transport == "simulated":
            args.append(init_tp_state(
                (shape.batch, shape.seq, cfg.d_model),
                model_module(cfg).tp_sites(cfg), parallel.tensor.feedback,
                device=device))
    step = make_lm_train_step(cfg, policy, opt, remat=remat, **kw)
    return step, tuple(args)


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            yield from _tensors(getattr(tree, f.name))


def nbytes(tree) -> int:
    """The bytes of every tensor of a tree (dicts, lists, tuples and
    dataclasses such as a ``FeedbackState``), meta ones included."""
    return sum(t.nbytes for t in _tensors(tree))


def train_argument_bytes(grid: LaneGrid, args) -> int:
    """Bytes one lane holds of a :func:`train_case`'s arguments on
    ``grid``: params, optimizer state, batch and ids under their rules;
    boundary, DP and TP feedback state replicated."""
    params, opt_state, bstates, batch, ids, *rest = args
    return (device_bytes(grid, params, param_shardings(grid, params))
            + device_bytes(grid, opt_state,
                           opt_state_shardings(grid, opt_state))
            + device_bytes(grid, batch, batch_shardings(grid, batch))
            + device_bytes(grid, ids, batch_shardings(grid, ids))
            + nbytes(bstates) + nbytes(rest))


def report(cfg, shape: InputShape, grid: LaneGrid,
           policy: CompressionPolicy, remat: bool = True) -> dict:
    """The measured part of a dry-run report: ``matmul_flops_global``,
    ``argument_bytes`` on ``grid``, ``model_flops`` and ``run_s``.  A
    decode step takes the position as a host int: the last row of the
    filled cache (any position gives the same shapes and flops:
    attention reads the whole cache under a mask)."""
    mod = model_module(cfg)
    with ctx.use_mesh(grid):
        if shape.kind == "train":
            step, args = train_case(cfg, shape, policy, "meta", remat=remat)
            args_bytes = train_argument_bytes(grid, args)
            run = run_shape_only(step, *args)
        elif shape.kind == "prefill":
            params, batch = param_specs(cfg), batch_specs(cfg, shape)
            args_bytes = (
                device_bytes(grid, params, param_shardings(grid, params))
                + device_bytes(grid, batch, batch_shardings(grid, batch)))
            with torch.no_grad():
                run = run_shape_only(mod.prefill, params, batch, cfg,
                                     policy, cache_len=shape.seq)
        else:
            params = param_specs(cfg)
            token, caches, pos = decode_specs(cfg, shape)
            if cfg.enc_dec:
                cspec = (cache_shardings(grid, caches[0], batch_dim=1),
                         batch_shardings(grid, caches[1]))
            else:
                cspec = cache_shardings(grid, caches, batch_dim=1)
            args_bytes = (
                device_bytes(grid, params, param_shardings(grid, params))
                + device_bytes(grid, token, batch_shardings(grid, token))
                + device_bytes(grid, caches, cspec)
                + device_bytes(grid, pos, replicated(grid, pos)))
            with torch.no_grad():
                run = run_shape_only(mod.decode_step, params, token, caches,
                                     shape.seq - 1, cfg, policy)
    tokens = shape.batch * (shape.seq if shape.kind != "decode" else 1)
    mult = 6 if shape.kind == "train" else 2
    return {"run_s": round(run.seconds, 1),
            "matmul_flops_global": run.matmul_flops,
            "argument_bytes": args_bytes,
            "model_flops": float(mult * active_param_count(cfg) * tokens)}


def lower_one(arch: str, shape_name: str, multi_pod: bool = False,
              policy_name: str = "none", remat: bool = True) -> dict:
    """Run one combination shape-only on the production grid; return the
    report."""
    cfg = get(arch)
    if not applicable(cfg, shape_name):
        return {"arch": arch, "shape": shape_name, "skipped": True,
                "reason": "full-attention arch: no sub-quadratic decode"}
    grid = meshlib.make_production_mesh(multi_pod=multi_pod)
    rep = report(cfg, SHAPES[shape_name], grid, POLICIES[policy_name], remat)
    return {"arch": arch, "shape": shape_name, "policy": policy_name,
            "mesh": "2x16x16" if multi_pod else "16x16",
            "devices": grid.size, "run_s": rep.pop("run_s"),
            "skipped": False, **rep}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=sorted(ARCHS))
    ap.add_argument("--shape", default=None, choices=sorted(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--policy", default="none", choices=sorted(POLICIES))
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    torch.set_num_threads(1)          # meta ops compute nothing

    if args.all:
        combos = [(a, s) for a in ASSIGNED for s in SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        combos = [(args.arch, args.shape)]

    reports = []
    for arch, shape in combos:
        try:
            r = lower_one(arch, shape, args.multi_pod, args.policy,
                          remat=not args.no_remat)
        except Exception as e:  # noqa: BLE001 -- report and continue
            r = {"arch": arch, "shape": shape, "error": repr(e)[:500],
                 "skipped": False}
        reports.append(r)
        print(json.dumps(r), flush=True)

    if args.json:
        with open(args.json, "w") as f:
            json.dump(reports, f, indent=1)
    bad = [r for r in reports if r.get("error")]
    print(f"# {len(reports) - len(bad)}/{len(reports)} OK", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
