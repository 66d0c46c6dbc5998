"""The dry run (``launch/dryrun.py``) at smoke size, against the JAX
package's formulas and against the port run for real on the CPU.

  * ``model_flops`` equals the reference's formula (``dryrun.py:215-219``
    with the reference's ``active_param_count``) for every arch and kind;
  * ``matmul_flops_global`` of the shape-only run equals
    ``FlopCounterMode`` over the same step, prefill or decode on real CPU
    tensors, exactly, for every arch (train under q4q8 and top10);
  * ``argument_bytes`` on a 1 x 1 grid equals the real arguments'
    ``nbytes``;
  * the wire record of a traced ``data=2, stage=2`` step (q4q8 cuts, q8
    gradient ring, 2 pipeline microbatches), a ``data=2`` and a
    ``tensor=2`` step gives the same events and ``collective_bytes`` /
    ``collective_counts(by_pairs=True)`` shape only and for real, keyed
    by ``probes.pairs_key(ring_pairs(...))``; the stage ring's, the
    simulated DP ring's and the tensor ring's bytes are the step's own
    ``metrics["wire"]`` bytes;
  * ``lower_one("glm4-9b", "train_4k")`` at full width creates no tensor
    with storage (an outer dispatch mode that raises on any result that
    is not on ``meta`` and holds a byte: some torch versions' checkpoint
    makes an empty CPU marker), and the CLI prints the reference's lines.
"""
import dataclasses
import json

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro.configs.registry import get as jget
from repro.models.config import active_param_count as j_active

from repro_torch.configs.registry import ARCHS, get
from repro_torch.core.parallel import spec_from_cli
from repro_torch.launch import dryrun as D
from repro_torch.launch.input_specs import InputShape, model_module
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.obs.probes import pairs_key, ring_pairs
from repro_torch.sharding.specs import tree_paths

torch.set_num_threads(1)

SMOKE = {"train": InputShape("t", "train", 32, 4),
         "prefill": InputShape("p", "prefill", 48, 2),
         "decode": InputShape("d", "decode", 40, 3)}


def _real(cfg, shape, policy_name):
    """The real CPU run of what ``dryrun.report`` runs shape only, under
    FlopCounterMode; returns (flops, the arguments' nbytes)."""
    policy = D.POLICIES[policy_name]
    mod = model_module(cfg)
    fc = FlopCounterMode(display=False)
    if shape.kind == "train":
        step, args = D.train_case(cfg, shape, policy, "cpu")
        with fc:
            step(*args)
        args = [a for i, a in enumerate(args) if i != 2]
    else:
        params = mod.init_params(torch.Generator().manual_seed(0), cfg)
        batch, _ = D._inputs(cfg, shape, "cpu")
        with fc, torch.no_grad():
            if shape.kind == "prefill":
                mod.prefill(params, batch, cfg, policy, cache_len=shape.seq)
                args = [params, batch]
            else:
                token = batch["tokens"][:, 0].contiguous()
                caches = mod.init_caches(cfg, shape.batch, shape.seq,
                                         torch.bfloat16, device="cpu")
                if cfg.enc_dec:
                    caches = (caches, batch["enc_embeds"])
                mod.decode_step(params, token, caches, shape.seq - 1, cfg,
                                policy)
                args = [params, token, caches,
                        torch.zeros((), dtype=torch.int32)]
    nbytes = sum(l.nbytes for _, l in tree_paths(args))
    return fc.get_total_flops(), nbytes


@pytest.mark.parametrize("kind", list(SMOKE))
@pytest.mark.parametrize("arch", list(ARCHS))
def test_flops_and_bytes_match_the_real_run(arch, kind):
    cfg, shape = get(arch, smoke=True), SMOKE[kind]
    if kind == "train" and cfg.enc_dec:
        shape = dataclasses.replace(shape, seq=16)
    rep = D.report(cfg, shape, make_local_mesh(), D.POLICIES["q4q8"])
    flops, nbytes = _real(cfg, shape, "q4q8")
    assert rep["matmul_flops_global"] == flops > 0
    assert rep["argument_bytes"] == nbytes
    tokens = shape.batch * (shape.seq if kind != "decode" else 1)
    mult = 6 if kind == "train" else 2
    assert rep["model_flops"] == float(
        mult * j_active(jget(arch, smoke=True)) * tokens)


@pytest.mark.parametrize("arch", ["gpt2-small", "mixtral-8x7b",
                                  "rwkv6-3b"])
def test_topk_train_flops_match_the_real_run(arch):
    cfg, shape = get(arch, smoke=True), SMOKE["train"]
    rep = D.report(cfg, shape, make_local_mesh(), D.POLICIES["top10"])
    assert rep["matmul_flops_global"] == _real(cfg, shape, "top10")[0]


def test_model_flops_at_full_width_is_the_reference_formula():
    for arch in D.ASSIGNED:
        r = D.lower_one(arch, "decode_32k", policy_name="q4q8")
        assert r["model_flops"] == float(2 * j_active(jget(arch)) * 128)
        assert r["devices"] == 256 and r["mesh"] == "16x16"


def _grid_step(cfg, device, mesh, wire, shape, policy, mb=None):
    spec = spec_from_cli(mesh, wire)
    step, args = D.train_case(cfg, shape, D.POLICIES[policy], device,
                              parallel=spec, pipeline_microbatches=mb)
    return spec, step, args


@pytest.mark.parametrize("mesh,wire,policy,mb,metric", [
    ("data=2,stage=2", "data=q8", "q4q8", 2, ("stage", "fw_bytes",
                                              "bw_bytes")),
    ("data=2", "data=q4", "q4q8", None, ("data", "dp_bytes")),
    ("tensor=2", "tensor=q8", "none", None, ("tensor", "tp_bytes"))])
def test_wire_record_shape_only_equals_the_real_step(mesh, wire, policy, mb,
                                                     metric):
    cfg = get("gpt2-small", smoke=True)
    shape = InputShape("t", "train", 32, 8)
    spec, step, args = _grid_step(cfg, "meta", mesh, wire, shape, policy, mb)
    run = D.run_shape_only(step, *args)
    _, rstep, rargs = _grid_step(cfg, "cpu", mesh, wire, shape, policy, mb)
    with D.wire_record() as events:
        out = rstep(*rargs)
    names = sorted(e.name for e in events)
    assert names == sorted(e.name for e in run.events) and names
    assert [e.args for e in run.events] == [e.args for e in events]
    grid = D.meshlib.LaneGrid(
        tuple(spec.axis(a).size for a in ("data", "stage", "tensor")),
        ("data", "stage", "tensor"))
    assert D.collective_bytes(run.events) == D.collective_bytes(events)
    counts = D.collective_counts(events, grid, by_pairs=True)
    assert D.collective_counts(run.events, grid, by_pairs=True) == counts
    assert set(counts) == {"collective-permute|" + pairs_key(ring_pairs(
        grid.shape, grid.axis_names, e.args["axis"])) for e in events}
    assert sum(counts.values()) == sum(D.collective_counts(events).values())
    # the axis' bytes are the step's own count of them
    axis, keys = metric[0], metric[1:]
    got = sum(D.wire_terms(e)[2] for e in events
              if D.wire_terms(e)[0] == axis)
    assert got == sum(out[-1]["wire"][k] for k in keys) > 0


class _NoStorage(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor) and not t.is_meta and t.numel():
                raise AssertionError(f"{func} made a {t.device} tensor")
        return out


def test_full_width_dry_run_reaches_no_storage():
    with _NoStorage():
        r = D.lower_one("glm4-9b", "train_4k", policy_name="q4q8")
    assert r["matmul_flops_global"] > r["model_flops"] > 0
    assert r["argument_bytes"] > 0


def test_cli_lines(capsys, tmp_path):
    out = tmp_path / "r.json"
    rc = D.main(["--arch", "whisper-small", "--shape", "long_500k",
                 "--json", str(out)])
    lines = capsys.readouterr().out.splitlines()
    assert rc == 0 and lines[-1] == "# 1/1 OK"
    rep = json.loads(lines[0])
    assert rep == {"arch": "whisper-small", "shape": "long_500k",
                   "skipped": True,
                   "reason": "full-attention arch: no sub-quadratic decode"}
    assert json.loads(out.read_text()) == [rep]
