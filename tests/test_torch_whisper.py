"""whisper-small through the port's train steps, static engine and
launchers, against the JAX package (the modules themselves are held in
tests/test_torch_encdec.py, whose smoke model, batches and pins these
tests share).

Bounds, each measured value beside it:
  * one simulated q4q8 step (4 stages capped at the smoke model's 2
    decoder layers: the memory hop and one cut), the reference eager on
    ``KERNEL_BACKEND = "pallas"`` with its Pallas C(x) swapped for
    ``repro.kernels.ref``'s per-tile oracle in the test (the same forward
    values, and a defined gradient at the bare memory hop; the JAX
    package's files are untouched) and every C(x) pinned
    (``test_torch_encdec.PinnedCx``): loss within ``STEP_LOSS_ATOL`` =
    0.05 (measured 2.0e-4), the gradient tree, ``enc_layers`` leaves
    included, within ``GRAD_RTOL`` = 0.3 of its norm (0.0060), the
    encoder's own leaves within 0.3 of theirs (0.011);
  * ``grad_accum=2`` under q4q8, pinned the same way (the reference's
    accumulation scan compiles its quantizer, so the pinned outputs are
    the reference's): loss within 0.05 (4.1e-4), the gradient tree within
    0.3 (0.0065), the encoder's within 0.3 (0.017);
  * a DP q8 step (2 lanes around an uncompressed cut) against the
    reference run in one subprocess with 4 forced host devices, under
    ``jax.jit``: loss within ``DP_LOSS_ATOL`` = 0.02 (measured 3.0e-4),
    the gradient tree within ``DP_GRAD_RTOL`` = 0.1 (0.051: the q8 codes
    of the reduce flip under the packages' f32 differences);
  * the static engine's greedy streams (2 equal-length prompts of 4
    tokens, whisper's start sequence, 16 new tokens) equal the
    reference's under none / q4q8 / top10, the cuts and the memory hop
    pinned row by row (``PinnedRows``), except a parting at a near-tie
    (tests/test_torch_serve_continuous.py's rule).
Every refusal raises the reference's exception type with its message;
the npz format carries both trees both ways, bit for bit; a launcher run
resumed from its step-2 train-state file ends bitwise where the
uninterrupted run ends; both launchers run on the CPU.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import repro.models.encdec as JE
import repro.serve.engine as JSE
import repro.serve.speculative as JSP
import repro.train.steps as JS
from repro.checkpoint import io as JIO
from repro.core.boundary import init_boundary_state as jinit
from repro.core.policy import CompressionPolicy as JCP
from repro.core import parallel as JPAR
from repro.launch.train import POLICIES as JPOL
from repro.optim import optimizers as JO

import repro_torch.models.encdec as TE
import repro_torch.models.transformer as TT
import repro_torch.serve.speculative as TSP
import repro_torch.train.steps as TS
from repro_torch.checkpoint import io as TIO
from repro_torch.checkpoint.convert import params_from_numpy
from repro_torch.core import parallel as TPAR
from repro_torch.core.boundary import init_boundary_state as tinit
from repro_torch.core.parallel import AxisSpec, ParallelSpec
from repro_torch.core.policy import POLICIES as TPOL
from repro_torch.optim import optimizers as TO
from repro_torch.serve.engine import ContinuousEngine, Request, ServeEngine

from test_torch_checkpoint import _assert_same
from test_torch_encdec import PinnedCx, batches, whisper  # noqa: F401
from test_torch_recurrent_models import _f32, _leaves, _rel, _tree_rel
from test_torch_serve_continuous import PinnedRows, _assert_streams

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
B, S = 4, 16
STEP_LOSS_ATOL = 0.05
GRAD_RTOL = 0.3
DP_LOSS_ATOL = 0.02
DP_GRAD_RTOL = 0.1
OPT = dict(kind="adamw", lr=1e-3, weight_decay=0.01, schedule="cosine",
           t_max=5, grad_clip=1.0)
PROMPT, NEW = 4, 16


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def _steps(whisper, pname, accum, monkeypatch):
    """One simulated-cut step of each package on the same batch, the
    optimizer swapped for one that hands back the gradient, every C(x)
    pinned.  Returns (loss gap, gradient gap, encoder gradient gap)."""
    jcfg, tcfg, jp, tp = whisper
    grads_out = lambda opt, p, g, s, **kw: (g, s)  # noqa: E731
    monkeypatch.setattr(JS, "apply_updates", grads_out)
    monkeypatch.setattr(TS, "apply_updates", grads_out)
    pins = PinnedCx(monkeypatch, jitted=accum > 1)
    jpol, tpol = JPOL[pname](), TPOL[pname]()
    cuts = len(TT.segment_bounds(tcfg.num_layers, tpol.num_stages)) - 1
    assert cuts == 1
    jb, tb = batches(jcfg, B, S, seed=2)
    jopt, topt = JO.OptimizerConfig(**OPT), TO.OptimizerConfig(**OPT)
    jg, _, _, jm = JS.make_lm_train_step(
        jcfg, jpol, jopt, donate=False, jit=False, grad_accum=accum)(
        jp, JO.init_opt_state(jopt, jp),
        [jinit(jpol.at(0), (S, jcfg.d_model), batch=B, dtype=jnp.bfloat16)],
        jb, jnp.arange(B))
    tg, _, _, tm = TS.make_lm_train_step(tcfg, tpol, topt,
                                         grad_accum=accum)(
        tp, TO.init_opt_state(topt, tp),
        [tinit(tpol.at(0), (S, tcfg.d_model), batch=B,
               dtype=torch.bfloat16)], tb, torch.arange(B))
    # a piece: the memory hop and the cut forward, the cut backward
    assert pins.replayed == len(pins.pairs) == 3 * accum
    assert np.isfinite(float(tm["loss"]))
    assert float(tm["aux"]) == float(jm["aux"]) == 0.0
    enc = _tree_rel(tg["enc_layers"], jg["enc_layers"])
    assert float(sum(g.float().abs().sum() for _, g in
                     _leaves(tg["enc_layers"]))) > 0
    return float(tm["loss"]) - float(jm["loss"]), _tree_rel(tg, jg), enc


@pytest.mark.parametrize("accum", [1, 2])
def test_q4q8_train_step_matches_reference(accum, whisper, monkeypatch):
    loss_gap, grad_gap, enc_gap = _steps(whisper, "q4q8", accum,
                                         monkeypatch)
    assert abs(loss_gap) <= STEP_LOSS_ATOL
    assert grad_gap <= GRAD_RTOL and enc_gap <= GRAD_RTOL


def ref_inputs(cfg):
    rng = np.random.RandomState(4)
    toks = rng.randint(0, cfg.vocab_size, (B, S))
    emb = rng.standard_normal((B, cfg.enc_seq, cfg.d_model)).astype(
        np.float32)
    return toks, emb, np.arange(B, dtype=np.int32)


REFERENCE = r'''
import sys
import numpy as np
import jax, jax.numpy as jnp
import repro.core.compressors as JCC
import repro.kernels.ops as JKO
import repro.models.encdec as JE
import repro.train.steps as JS
from repro.configs.registry import get
from repro.core.boundary import init_boundary_state
from repro.core.policy import CompressionPolicy
from repro.launch.train import POLICIES
from repro.optim import optimizers as JO
from repro.train.loop import init_lm_dp_state
sys.path.insert(0, sys.argv[2])
import test_torch_encdec as E
import test_torch_whisper as T

JCC.KERNEL_BACKEND = "pallas"
JKO.quant_dequant_op, JKO.topk_block_op = E._oracle_quant, E._oracle_topk
JS.apply_updates = lambda opt, p, g, s: (g, s)
opt = JO.OptimizerConfig(kind="sgd", lr=0.1)
cfg = get(T.ARCH, smoke=True)
params = JE.init_params(jax.random.PRNGKey(0), cfg)
toks, emb, ids = T.ref_inputs(cfg)
batch = {"tokens": jnp.asarray(toks, jnp.int32),
         "enc_embeds": jnp.asarray(emb).astype(jnp.bfloat16)}
pol = CompressionPolicy(num_stages=2, boundary=POLICIES["none"]().boundary)
bst = [init_boundary_state(pol.at(0), (T.S, cfg.d_model), batch=T.B,
                           dtype=jnp.bfloat16)]
step = JS.make_lm_train_step(cfg, pol, opt, dp=T.DP, dp_codec="q8",
                             donate=False)
g, _, _, _, m = step(params, JO.init_opt_state(opt, params), bst, batch,
                     jnp.asarray(ids), init_lm_dp_state(cfg, params, pol,
                                                        T.DP, "none"))
out = {"loss": np.float32(m["loss"])}
for path, leaf in jax.tree_util.tree_flatten_with_path(g)[0]:
    key = "/".join(str(p.key) for p in path)
    out[f"grad/{key}"] = np.asarray(jnp.asarray(leaf, jnp.float32))
np.savez(sys.argv[1], **out)
print("REFERENCE_OK")
'''
ARCH, DP = "whisper-small", 2


def test_dp_q8_step_matches_reference(whisper, tmp_path, monkeypatch):
    """2 DP lanes of 2 around an uncompressed cut, the gradients
    all-reduced over the q8 wire: loss and gradient against the
    reference's step, run in a subprocess with host devices."""
    from repro_torch.train.loop import init_lm_dp_state
    path = tmp_path / "ref.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run(
        [sys.executable, "-c", REFERENCE, str(path), str(ROOT / "tests")],
        env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0 and "REFERENCE_OK" in proc.stdout, \
        proc.stderr[-3000:]
    ref = dict(np.load(path))
    _, tcfg, _, tp = whisper
    monkeypatch.setattr(TS, "apply_updates",
                        lambda opt, p, g, s, **kw: (g, s))
    opt = TO.OptimizerConfig(kind="sgd", lr=0.1)
    toks, emb, ids = ref_inputs(tcfg)
    batch = {"tokens": torch.from_numpy(toks),
             "enc_embeds": torch.from_numpy(emb).to(torch.bfloat16)}
    pol = dataclasses.replace(TPOL["none"](), num_stages=2)
    spec = ParallelSpec({"data": AxisSpec(size=DP, codec="q8")})
    bst = [tinit(pol.at(0), (S, tcfg.d_model), batch=B,
                 dtype=torch.bfloat16)]
    g, _, _, _, m = TS.make_lm_train_step(tcfg, pol, opt, parallel=spec)(
        tp, TO.init_opt_state(opt, tp), bst, batch, torch.from_numpy(ids),
        init_lm_dp_state(tcfg, tp, pol, DP))
    assert m["wire"]["dp_hops"] == DP * (DP - 1)
    assert abs(float(m["loss"]) - float(ref["loss"])) <= DP_LOSS_ATOL
    got = dict(_leaves(g))
    assert _rel([_f32(got[n]) for n in sorted(got)],
                [ref[f"grad{n}"] for n in sorted(got)]) <= DP_GRAD_RTOL


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _reference_static(jp, jcfg, policy, prompts, new):
    """The reference static engine's greedy loop (``ServeEngine``'s
    jitted prefill and decode_step on its ``_make_batch``) with each
    step's top-2 logit gap."""
    toks = np.stack(prompts).astype(np.int32)
    s = toks.shape[1]
    batch = JSE._make_batch(jcfg, toks)
    pad = jnp.zeros((len(prompts),), jnp.int32)
    prefill = jax.jit(lambda b: JE.prefill(
        jp, b, jcfg, policy, cache_len=s + new, pad_len=pad, wire=True))
    decode = jax.jit(lambda t, st, pos: JE.decode_step(
        jp, t, st, pos, jcfg, policy, pad_len=pad, wire=True))
    logits, state = prefill(batch)
    logits = logits[:, -1]
    outs, gaps = [], {}
    for step in range(new):
        lf = np.asarray(logits, np.float32)
        for r in range(len(prompts)):
            top2 = np.sort(lf[r])[-2:]
            gaps[(r, step)] = float(top2[1] - top2[0])
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        outs.append(np.asarray(tok))
        if step < new - 1:
            logits, state = decode(tok, state, jnp.int32(s + step))
    gen = np.stack(outs, axis=1)
    return {r: gen[r] for r in range(len(prompts))}, gaps


@pytest.mark.parametrize("policy", ["none", "q4q8", "top10"])
def test_static_streams_match_reference(policy, whisper, monkeypatch):
    """Two equal-length 4-token prompts, 16 new tokens each, through the
    static engine of both packages (zero frame embeddings, as both
    engines stub them)."""
    jcfg, tcfg, jp, tp = whisper
    rng = np.random.RandomState(7)
    prompts = [rng.randint(1, jcfg.vocab_size, PROMPT) for _ in range(2)]
    cuts = PinnedRows(monkeypatch, jitted=True, modules=(JE, TE),
                      names=("boundary_wire_eval",))
    want, gaps = _reference_static(jp, jcfg, JPOL[policy](), prompts, NEW)
    eng = ServeEngine(tp, tcfg, TPOL[policy](), max_batch=2,
                      max_seq=PROMPT + NEW)
    done = eng.generate([Request(p, NEW) for p in prompts])
    _assert_streams({r: d.out for r, d in enumerate(done)}, want, gaps)
    if policy != "none":
        assert cuts.hits > cuts.misses, (cuts.hits, cuts.misses)


# refusal -> (port call, reference call) on (jcfg, tcfg, jp, tp); each
# raises ValueError
REFUSALS = {
    "continuous": (
        lambda m: ContinuousEngine(m[3], m[1], device="cpu"),
        lambda m: JSE.ContinuousEngine(m[2], m[0])),
    "speculative draft": (
        lambda m: TSP.DraftWorker(m[3], m[1], device="cpu"),
        lambda m: JSP.DraftWorker(m[2], m[0])),
    "mixed-length static": (
        lambda m: ServeEngine(m[3], m[1], max_seq=64).generate(
            [Request(np.arange(1, 6), 2), Request(np.arange(1, 9), 2)]),
        lambda m: JSE.ServeEngine(m[2], m[0], max_seq=64).generate(
            [JSE.Request(np.arange(1, 6, dtype=np.int32), 2),
             JSE.Request(np.arange(1, 9, dtype=np.int32), 2)])),
}


@pytest.mark.parametrize("what", list(REFUSALS))
def test_serving_refusals_match_reference(what, whisper):
    port, reference = REFUSALS[what]
    with pytest.raises(ValueError) as want:
        reference(whisper)
    with pytest.raises(ValueError) as got:
        port(whisper)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("what", ["pipeline", "tensor axis",
                                  "pipeline x tensor"])
def test_train_refusals_match_reference(what, whisper):
    """The pipeline transport and the tensor axis refuse the
    encoder-decoder with the reference's ``NotImplementedError``."""
    jcfg, tcfg, _, _ = whisper
    opt, jopt = TO.OptimizerConfig(**OPT), JO.OptimizerConfig(**OPT)
    kw = ({"transport": "pipeline"} if what == "pipeline" else
          {"parallel": {"tensor axis": {"tensor": 2},
                        "pipeline x tensor": {"stage": 2, "tensor": 2}}[
              what]})
    msgs = []
    for mod, step, cfg, pol, o in (
            (JPAR, JS.make_lm_train_step, jcfg, JCP(num_stages=2), jopt),
            (TPAR, TS.make_lm_train_step, tcfg, TPOL["q4q8"](), opt)):
        if "parallel" in kw:
            pol = JCP(num_stages=1) if mod is JPAR else TPOL["none"]()
            kwm = {"parallel": mod.ParallelSpec(kw["parallel"])}
        else:
            kwm = kw
        with pytest.raises(NotImplementedError) as e:
            step(cfg, pol, o, **kwm)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    assert "decoder-only archs" in msgs[1]


def test_npz_carries_both_trees_both_ways(whisper, tmp_path):
    """f32 leaves stay f32, bf16 ones cross as uint16 views, bit for
    bit, in either direction: the encoder's, the decoder's and
    ``dec_pos``."""
    _, _, jp, tp = whisper
    path = str(tmp_path / "ref.npz")
    JIO.save(path, jp, step=3)
    like = jax.tree.map(lambda a: torch.zeros(
        a.shape, dtype=params_from_numpy(np.asarray(a)[:0], "cpu").dtype),
        jp)
    got, step = TIO.restore_params(path, like)
    assert step == 3
    _assert_same(got, jp)
    path = str(tmp_path / "port.npz")
    TIO.save(path, tp, step=4)
    back, step = JIO.restore_params(path, jp)
    assert step == 4
    _assert_same(tp, back)


# ---------------------------------------------------------------------------
# launchers
# ---------------------------------------------------------------------------

def _json_lines(out):
    return [json.loads(line) for line in out.splitlines()
            if line.startswith("{")]


TRAIN_ARGV = ["--arch", "whisper-small", "--smoke", "--device", "cpu",
              "--batch", "4", "--seq", "16", "--policy", "q4q8",
              "--log-every", "1"]


@pytest.mark.parametrize("argv", [["--steps", "2"],
                                  ["--steps", "2", "--grad-accum", "2"],
                                  ["--steps", "2", "--mesh", "data=2",
                                   "--wire", "data=q8"]])
def test_launch_train_smoke(argv, capsys):
    """``launch/train --arch whisper-small``: q4q8 steps on the
    simulated cuts (the stub's zero frame embeddings), with gradient
    accumulation and data-parallel; finite losses."""
    from repro_torch.launch import train as ttrain
    assert ttrain.main(TRAIN_ARGV + argv) == 0
    recs = _json_lines(capsys.readouterr().out)
    assert len(recs) == 2 and all(np.isfinite(r["loss"]) for r in recs)
    assert ("dp_bytes" in recs[0]) == ("--mesh" in argv)


def test_launch_train_refuses_the_pipeline(capsys):
    from repro_torch.launch import train as ttrain
    with pytest.raises(SystemExit) as e:
        ttrain.main(TRAIN_ARGV + ["--steps", "1", "--transport", "pipeline",
                                  "--stages", "2"])
    assert e.value.code == 2
    assert "pipeline transport: decoder-only archs" in \
        capsys.readouterr().err


def test_launch_train_resume_is_bitwise(tmp_path, capsys):
    """A 4-step run saving at step 2 and at its end, and a run resumed
    from the step-2 file: the resumed run's step-4 train state is the
    uninterrupted run's, bit for bit."""
    from repro_torch.launch import train as ttrain
    full = str(tmp_path / "full_{step}.npz")
    res = str(tmp_path / "res_{step}.npz")
    argv = TRAIN_ARGV + ["--steps", "4", "--save-every", "2"]
    assert ttrain.main(argv + ["--ckpt", full]) == 0
    assert ttrain.main(argv + ["--ckpt", res, "--resume",
                               full.replace("{step}", "2")]) == 0
    out = capsys.readouterr().out
    assert "# resumed step-2 train state" in out
    a = np.load(full.replace("{step}", "4"))
    b = np.load(res.replace("{step}", "4"))
    assert sorted(a.files) == sorted(b.files)
    assert any(k.startswith("params/enc_layers") for k in a.files)
    for k in a.files:
        assert np.array_equal(a[k], b[k]), k


def test_launch_serve_falls_back_to_static(capsys):
    """No ``--engine``: the reference's line, then the static engine."""
    from repro_torch.launch import serve as tserve
    assert tserve.main(["--arch", "whisper-small", "--smoke", "--device",
                        "cpu", "--policy", "q4q8", "--batch", "2",
                        "--prompt-len", "4", "--new-tokens", "4"]) == 0
    out = capsys.readouterr().out
    assert ("# whisper-small-smoke: ['enc-dec'] cannot mask left-padding "
            "-> static engine") in out
    (rec,) = _json_lines(out)
    assert rec["engine"] == "static" and rec["arch"] == "whisper-small-smoke"
