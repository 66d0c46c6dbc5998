"""The port's serving path against the JAX package, on the same params.

Params go JAX -> numpy -> ``params_from_numpy``; the model is gpt2-small
smoke with ``num_layers=4``, so the 4-stage presets have 3 compressed cuts
as at full width.

Tolerances (bf16 activations, stated once):
  * logits: ``LOGIT_ATOL`` = 0.03 absolute, about 4 bf16 ulps at the
    |logit| <= 2 of this model (measured gap <= 0.011);
  * hidden states at the cuts and KV caches: ``REL_TOL`` = 2**-5 of the
    tensor's largest magnitude, 8 bf16 ulps (measured <= 2**-6.7).
The two frameworks round bf16 matmuls and transcendentals differently, so
nothing model-level is bitwise.

Pinned cuts.  A q4 code or a TopK selection turns a one-ulp difference at
a cut's INPUT into a whole code step or a swapped entry at its output, so
an unpinned compressed run drifts by far more than the model's rounding.
The compressed tests therefore record the reference's cut inputs and
outputs, check the port's own cut input against the recorded one within
``REL_TOL``, feed the port's boundary the RECORDED input, and require its
output to be bitwise the reference's.  Every stage then starts from the
same tensor in both packages, and the end-to-end gaps stay at the model's
rounding.

Greedy tokens: equal to the reference's, except that a stream may part at
a step where the reference's top-2 logits are within ``2 * LOGIT_ATOL``
(a near-tie either side may break); later tokens of that stream are not
compared.
"""
import contextlib
import dataclasses
import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import repro.models.transformer as JT
from repro.checkpoint import io as JIO
from repro.configs.registry import get as jget
from repro.launch.train import POLICIES as JPOL
from repro.serve.engine import Request as JRequest, ServeEngine as JEngine

import repro_torch.models.transformer as TT
from repro_torch.checkpoint import io as TIO
from repro_torch.checkpoint.convert import params_from_numpy, tensor_from_numpy
from repro_torch.configs.registry import get as tget
from repro_torch.core.policy import POLICIES as TPOL
from repro_torch.launch import serve as tserve
from repro_torch.serve.engine import Request as TRequest, ServeEngine as TEngine

# One intra-op thread: the suite runs in several worker processes at
# once, and a torch thread pool per worker that outnumbers the cores
# slows its CPU ops by an order of magnitude.
torch.set_num_threads(1)

LOGIT_ATOL = 0.03
REL_TOL = 2.0 ** -5
POLICY_NAMES = ["none", "q4q8", "top10"]


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(jget("gpt2-small", smoke=True), num_layers=4)
    tcfg = dataclasses.replace(tget("gpt2-small", smoke=True), num_layers=4)
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, tcfg, jp, tp


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _assert_rel(got, want, what):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    gap = float(np.abs(got - want).max())
    assert gap <= REL_TOL * max(float(np.abs(want).max()), 1e-6), \
        f"{what}: max gap {gap} vs largest {np.abs(want).max()}"


class PinnedCuts:
    """Record the reference's cut (input, output) pairs; replay them into
    the port's boundary (see module doc).  The reference runs EAGERLY: under
    jit, XLA rewrites the quantization scale ``span / 15`` as
    ``span * (1/15)``, which moves q4/q8 codes at rounding boundaries; the
    eager jnp path divides exactly, as the port and the Pallas kernels do.
    ``check_inputs=False`` once greedy streams may have parted."""

    def __init__(self, monkeypatch, check_inputs=True):
        self.pairs, self.replayed = [], 0
        orig_j, orig_t = JT.boundary_wire_eval, TT.boundary_wire_eval

        def record(policy, x, compress):
            y = orig_j(policy, x, compress)
            self.pairs.append((np.asarray(x), np.asarray(y)))
            return y

        def replay(policy, x, compress):
            jx, jy = self.pairs[self.replayed]
            self.replayed += 1
            if check_inputs:
                _assert_rel(x, jx, f"cut input {self.replayed}")
            y = orig_t(policy, tensor_from_numpy(jx, x.device), compress)
            want = tensor_from_numpy(jy, x.device)
            assert y.dtype == want.dtype and torch.equal(y, want), \
                f"cut output {self.replayed} not bitwise the reference's"
            return y

        monkeypatch.setattr(JT, "boundary_wire_eval", record)
        monkeypatch.setattr(TT, "boundary_wire_eval", replay)


@pytest.mark.parametrize("policy", POLICY_NAMES)
def test_prefill_and_decode_match(models, policy, monkeypatch):
    jcfg, tcfg, jp, tp = models
    cuts = PinnedCuts(monkeypatch)
    rng = np.random.RandomState(1)
    b, s, cache_len = 4, 16, 32
    toks = rng.randint(0, jcfg.vocab_size, (b, s))
    pad = np.array([0, 3, 7, 11])
    jpol, tpol = JPOL[policy](), TPOL[policy]()
    jl, jc = JT.prefill(jp, {"tokens": jnp.asarray(toks, jnp.int32)}, jcfg,
                        jpol, cache_len=cache_len,
                        pad_len=jnp.asarray(pad, jnp.int32), wire=True)
    tl, tc = TT.prefill(tp, {"tokens": torch.from_numpy(toks)}, tcfg, tpol,
                        cache_len=cache_len, pad_len=torch.from_numpy(pad),
                        wire=True)
    assert tl.dtype == torch.bfloat16 and tl.shape == (b, 1, jcfg.vocab_size)
    np.testing.assert_allclose(_f32(tl), _f32(jl), rtol=0, atol=LOGIT_ATOL)
    for key in ("k", "v"):
        assert tc["b0"][key].shape == jc["b0"][key].shape
        _assert_rel(tc["b0"][key], jc["b0"][key], f"prefill cache {key}")
    token = np.asarray(jnp.argmax(jl[:, -1], axis=-1))
    for i in range(3):
        jl, jc = JT.decode_step(jp, jnp.asarray(token, jnp.int32), jc,
                                jnp.int32(s + i), jcfg, jpol,
                                pad_len=jnp.asarray(pad, jnp.int32),
                                wire=True)
        tl, tc = TT.decode_step(tp, torch.tensor(token), tc, s + i, tcfg,
                                tpol, pad_len=torch.from_numpy(pad),
                                wire=True)
        np.testing.assert_allclose(_f32(tl), _f32(jl), rtol=0,
                                   atol=LOGIT_ATOL)
        token = np.asarray(jnp.argmax(jl, axis=-1))
    for key in ("k", "v"):
        _assert_rel(tc["b0"][key], jc["b0"][key], f"decode cache {key}")
    assert cuts.replayed == len(cuts.pairs) == (0 if policy == "none"
                                                else 3 * 4)


@pytest.mark.parametrize("policy", POLICY_NAMES)
def test_generate_greedy_tokens(models, policy, monkeypatch):
    jcfg, tcfg, jp, tp = models
    PinnedCuts(monkeypatch, check_inputs=False)
    jlogits = []
    orig = JT._lm_logits

    def record_logits(params, x, cfg):
        out = orig(params, x, cfg)
        jax.debug.callback(lambda a: jlogits.append(_f32(a)[:, -1]), out,
                           ordered=True)
        return out

    monkeypatch.setattr(JT, "_lm_logits", record_logits)
    rng = np.random.RandomState(2)
    prompts = [rng.randint(0, jcfg.vocab_size, n) for n in (5, 12, 9, 16)]
    new = 10
    # eager where cuts are pinned (see PinnedCuts); jitted, and faster, where
    # the policy has none
    eager = jax.disable_jit() if policy != "none" else contextlib.nullcontext()
    with eager:
        ref = JEngine(jp, jcfg, JPOL[policy](), max_batch=4,
                      max_seq=64).generate(
            [JRequest(p.astype(np.int32), new) for p in prompts])
    jax.effects_barrier()
    got = TEngine(tp, tcfg, TPOL[policy](), max_batch=4, max_seq=64) \
        .generate([TRequest(p, new) for p in prompts])
    assert len(jlogits) == new
    compared = 0
    for b, (r, g) in enumerate(zip(ref, got)):
        assert g.out.shape == r.out.shape == (new,)
        for i in range(new):
            if g.out[i] != r.out[i]:
                top2 = np.sort(jlogits[i][b])[-2:]
                assert top2[1] - top2[0] <= 2 * LOGIT_ATOL, \
                    f"request {b} parts at step {i} without a near-tie"
                break
            compared += 1
    assert compared >= new * len(prompts) // 2


@pytest.mark.parametrize("lengths,seed,row", [((19, 5), 3, 1), ((9, 9), 5, 0)])
def test_batching_does_not_change_a_request(models, lengths, seed, row):
    """tests/test_serve_padding.py on the port: a left-padded short prompt,
    and a request in an equal-length batch, generate what they generate
    alone (uncompressed: pad positions are masked out of attention)."""
    _, tcfg, _, tp = models
    rng = np.random.RandomState(seed)
    prompts = [rng.randint(1, tcfg.vocab_size, n) for n in lengths]
    eng = TEngine(tp, tcfg, max_batch=4, max_seq=64)
    batched = eng.generate([TRequest(p, 8) for p in prompts])[row].out
    alone = eng.generate([TRequest(prompts[row], 8)])[0].out
    np.testing.assert_array_equal(alone, batched)


def test_engine_rejects_what_does_not_fit(models):
    _, tcfg, _, tp = models
    eng = TEngine(tp, tcfg, max_batch=2, max_seq=16)
    with pytest.raises(ValueError, match="requests"):
        eng.generate([TRequest(np.zeros(4, np.int64), 2)] * 3)
    with pytest.raises(ValueError, match="max_seq"):
        eng.generate([TRequest(np.zeros(10, np.int64), 8)])


def test_restore_params_from_reference_npz(models, tmp_path):
    jcfg, tcfg, jp, tp = models
    for name, tree in (("params", jp), ("state", {"params": jp})):
        path = str(tmp_path / f"{name}.npz")
        JIO.save(path, tree, step=7)
        got, step = TIO.restore_params(path, tp)
        assert step == 7
        flat_t = jax.tree_util.tree_leaves_with_path(tp)
        for (path_, want), leaf in zip(flat_t, jax.tree.leaves(got)):
            assert leaf.dtype == want.dtype and torch.equal(leaf, want), path_
    bad = str(tmp_path / "bad.npz")
    JIO.save(bad, {"embed": jp["embed"]})
    with pytest.raises(TIO.CheckpointMismatch, match="missing"):
        TIO.restore_params(bad, tp)


@pytest.mark.parametrize("policy", POLICY_NAMES)
def test_launch_serve_main_cpu(policy, capsys):
    assert tserve.main(["--arch", "gpt2-small", "--smoke", "--engine",
                        "static", "--policy", policy, "--batch", "2",
                        "--prompt-len", "8", "--new-tokens", "4",
                        "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert '"engine": "static"' in out and '"device": "cpu"' in out


@pytest.mark.parametrize("argv", [["--engine", "continuous"],
                                  ["--temperature", "0.7"],
                                  ["--prefix-cache"],
                                  ["--prefill-chunk", "8", "--shared-prefix",
                                   "12", "--eos", "3"],
                                  ["--draft", "gpt2-small", "--spec-k", "3"]])
def test_launch_serve_continuous_cpu(argv, capsys):
    """The continuous engine is the launcher's default; sampling, the
    paged cache and speculation run through it."""
    assert tserve.main(["--smoke", "--device", "cpu", "--policy", "top10",
                        "--requests", "5", "--slots", "2", "--prompt-len",
                        "12", "--new-tokens", "5", *argv]) == 0
    out = capsys.readouterr().out
    rec = json.loads(out.splitlines()[0])
    assert rec["engine"] == "continuous" and rec["completed"] == 5
    assert rec["device"] == "cpu" and rec["tok_per_s"] > 0
    if "--prefix-cache" in argv or "--draft" in argv:
        assert rec["active_pages"] == 0


@pytest.mark.parametrize("argv", [["--temperature", "0.7"],
                                  ["--prefix-cache"],
                                  ["--draft", "gpt2-small"]])
def test_launch_serve_static_refuses_continuous_flags(argv, capsys):
    with pytest.raises(SystemExit) as e:
        tserve.main(["--smoke", "--device", "cpu", "--engine", "static",
                     *argv])
    assert e.value.code == 2
    assert "--engine continuous" in capsys.readouterr().err


@pytest.mark.parametrize("argv", [["--arch", "whisper-small", "--engine",
                                   "continuous"]])
def test_launch_serve_refuses_what_is_not_ported(argv, capsys):
    """What the port refuses, it refuses as the reference does: the
    encoder-decoder under the continuous engine (absolute positions
    cannot mask left-padding), exit 2 with the reference's message."""
    with pytest.raises(SystemExit) as e:
        tserve.main(["--smoke", "--device", "cpu", *argv])
    assert e.value.code == 2
    assert ("--engine continuous: ['enc-dec'] cannot mask left-padding — "
            "use --engine static (equal-length batches)") in \
        capsys.readouterr().err


SERVE_TRACE_ARGV = ["--smoke", "--device", "cpu", "--policy", "top10",
                    "--requests", "4", "--slots", "2", "--prompt-len", "8",
                    "--new-tokens", "4", "--prefix-cache", "--prefill-chunk",
                    "8", "--shared-prefix", "16"]


def _trace_lines(path):
    return [json.loads(l) for l in path.read_text().splitlines()]


def test_launch_serve_trace_writes_a_valid_jsonl(tmp_path, capsys):
    """``--trace PATH``: the continuous engine's events (warm-up included)
    in a file that passes the schema check: a ``request_done`` per served
    request, prefill and decode spans, scheduler and page counters."""
    from repro_torch.obs import trace
    from repro_torch.obs.export import validate_jsonl
    path = tmp_path / "s.jsonl"
    assert tserve.main(SERVE_TRACE_ARGV + ["--trace", str(path)]) == 0
    out = capsys.readouterr().out
    ev = _trace_lines(path)
    assert validate_jsonl(str(path)) == len(ev)
    assert f"# trace: {len(ev)} events -> {path} (dropped 0)" in out
    names = [e["name"] for e in ev]
    assert {"serve.prefill", "serve.decode", "serve.sched",
            "serve.pages"} <= set(names)
    done = [e for e in ev if e["name"] == "serve.request_done"]
    # the last 4 are the served requests (the first, the warm-up's)
    assert len(done) > 4
    assert all(e["args"]["tokens"] >= 1 and e["args"]["ttft_s"] > 0
               for e in done[-4:])
    assert trace.get_tracer() is None


def test_launch_serve_perfetto_writes_a_chrome_trace(tmp_path, capsys):
    """``--perfetto PATH`` alone, on the static engine too (which emits
    nothing): a loadable file with its ``traceEvents``."""
    for engine, want_events in (("continuous", True), ("static", False)):
        path = tmp_path / f"{engine}.json"
        argv = (SERVE_TRACE_ARGV if engine == "continuous" else
                ["--smoke", "--device", "cpu", "--engine", "static",
                 "--batch", "2", "--prompt-len", "8", "--new-tokens", "3"])
        assert tserve.main(argv + ["--perfetto", str(path)]) == 0
        assert f"events -> {path}" in capsys.readouterr().out
        doc = json.loads(path.read_text())
        assert bool(doc["traceEvents"]) == want_events
        assert all(e["ph"] in ("X", "C", "i") for e in doc["traceEvents"])


def test_launch_serve_metrics_sets_the_counter_grid(tmp_path, capsys):
    """``--metrics N``: the scheduler / page counters every N ticks, so
    fewer of them at 3 than at the default 1; the rest of the stream is
    unchanged."""
    counts = {}
    for every in (1, 3):
        path = tmp_path / f"m{every}.jsonl"
        assert tserve.main(SERVE_TRACE_ARGV + ["--trace", str(path),
                                               "--metrics",
                                               str(every)]) == 0
        capsys.readouterr()
        ev = _trace_lines(path)
        counts[every] = {n: sum(e["name"] == n for e in ev)
                         for n in ("serve.sched", "serve.pages",
                                   "serve.request_done", "serve.decode")}
    assert counts[3]["serve.sched"] == counts[3]["serve.pages"] > 0
    assert counts[3]["serve.sched"] < counts[1]["serve.sched"]
    for n in ("serve.request_done", "serve.decode"):
        assert counts[3][n] == counts[1][n]
