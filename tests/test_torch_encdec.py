"""The port's encoder-decoder modules (``models/encdec.py``, with
``common.sinusoidal_pos``, ``attention.cross_attn`` and the memory hop's
``kernels/ops.py`` ``_ad`` functions) against the JAX package.

whisper-small's smoke config: 2 encoder and 2 decoder layers, d 256, 4
heads of 64, d_ff 512, vocab 512, 32 encoder frames, LayerNorm, GELU,
tied head, learned absolute decoder positions (``max_seq`` 512).
Reference params carried over through numpy; the stub frontend's
``enc_embeds`` are seeded N(0, 1) bf16.

The compressed reference runs with ``KERNEL_BACKEND = "pallas"`` and its
Pallas C(x) swapped, in the test, for ``repro.kernels.ref``'s per-tile
oracle at the same tile (``PinnedCx``): the same forward values (the
oracle is the kernels' bit-exact mirror) and, unlike the Pallas call,
a defined gradient at the bare memory hop, which the port's backward
copies (``ops.quant_dequant_vjp`` / ``topk_block_vjp``).

Bounds (bf16 activations in both packages), each measured value beside:
  * ``sinusoidal_pos`` in f32 within ``POS_ATOL`` = 2**-12 absolute
    (1.2e-4 at 1,500 x 768, 9.5e-7 at 32 x 256): XLA's and torch's f32
    ``exp`` part by an ulp on 39 of the 384 frequencies, which the
    positions up to 1,499 scale; after the bf16 cast, equal at 32 x 256
    and within one bf16 ulp of each entry of magnitude >= 2**-5 at
    1,500 x 768 (the smaller ones within 2**-12 absolute);
  * ``cross_attn``, ``encode``, the logits (uncompressed, compressed, on
    the wire), the hidden states of the training forward, the prefill's
    logits, memory and K/V caches, and a decode step past ``max_seq``
    within ``RTOL`` = 2**-5 of their largest magnitude (measured at most
    0.82%, the cut inputs of the pinned runs at most 0.75%); the eval
    step's loss within 2e-3 (1.2e-4);
  * the memory hop's C(x) bitwise the oracle's; its gradient: TopK's
    bitwise (g on the kept entries), the quantizers' non-zero on the
    same entries and within one bf16 ulp (``2**-7`` relative) of the
    oracle's, since the tile sums run in another order (measured: bitwise
    on every input here);
  * prefill of S - 2 tokens and 2 decode steps equal prefills of S - 1
    and S within 2**-5 (measured: equal; a dropped cache write moves them
    far beyond it);
  * the ``dec_pos`` slice clamps as ``jax.lax.dynamic_slice_in_dim``:
    bitwise the reference's rows at and past ``max_seq``.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import repro.core.compressors as JCC
import repro.kernels.ops as JKO
import repro.models.attention as JA
import repro.models.encdec as JE
from repro.configs.registry import get as jget
from repro.core.boundary import init_boundary_state as jinit
from repro.core.policy import NO_POLICY as JNONE
from repro.kernels import ref as JREF
from repro.launch.train import POLICIES as JPOL
from repro.models.common import sinusoidal_pos as jsinusoidal

import repro_torch.core.compressors as TCC
import repro_torch.models.attention as TA
import repro_torch.models.encdec as TE
import repro_torch.models.transformer as TT
from repro_torch.checkpoint.convert import params_from_numpy, tensor_from_numpy
from repro_torch.configs.registry import get as tget
from repro_torch.core.boundary import init_boundary_state as tinit
from repro_torch.core.policy import NO_POLICY, POLICIES as TPOL
from repro_torch.kernels import ops as TKO
from repro_torch.kernels.tiling import lane_block, pow2_row_block
from repro_torch.models.common import sinusoidal_pos

from test_torch_recurrent_models import _f32, _gap, _leaves

torch.set_num_threads(1)

ARCH = "whisper-small"
B, S = 2, 16
RTOL = 2.0 ** -5
POS_ATOL = 2.0 ** -12
BF16_ULP = 2.0 ** -7


@pytest.fixture(scope="module")
def whisper():
    jcfg, tcfg = jget(ARCH, smoke=True), tget(ARCH, smoke=True)
    jp = JE.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp),
                                             "cpu")


def _oracle_block(flat):
    m, n = flat.shape
    bn = lane_block(n)
    return (m, n) if bn is None else (pow2_row_block(m), bn)


def _oracle_quant(x, bits):
    flat = x.reshape(x.shape[0], -1)
    return JREF.quant_dequant_ref(flat, bits, _oracle_block(flat)).reshape(
        x.shape)


def _oracle_topk(x, k_frac):
    flat = x.reshape(x.shape[0], -1)
    return JREF.topk_block_ref(flat, k_frac, _oracle_block(flat)).reshape(
        x.shape)


class PinnedCx:
    """Every C(x) of the reference (the oracle, through ``Compressor``)
    recorded in call order, and replayed into the port's: the port's input
    must be within ``RTOL`` of the reference's, which then REPLACES it,
    and the port's output on it must be bitwise the reference's.  With
    ``wire`` the serving cuts' ``boundary_wire_eval`` of the two
    encoder-decoder modules are pinned the same way.  A q4 code or a TopK
    pick flips under a 2**-7 change of its input, and the model carries
    the flip on; pinned, the two packages meet at every cut.

    ``jitted=True``: the reference ran (partly) compiled -- under
    ``jax.jit`` or a ``lax.scan`` (its gradient accumulation) -- where its
    quantizer's scale is ``span * f32(1/levels)``, which may move a code;
    the port's output on a pinned input is then REPLACED by the
    reference's as well (the bits are held eagerly elsewhere here)."""

    def __init__(self, monkeypatch, wire=False, jitted=False):
        self.pairs, self.replayed, self.jitted = [], 0, jitted
        monkeypatch.setattr(JCC, "KERNEL_BACKEND", "pallas")
        for name, oracle in (("quant_dequant_op", _oracle_quant),
                             ("topk_block_op", _oracle_topk)):
            self._pin(monkeypatch, name, oracle, getattr(TKO, name),
                      (JKO,), (TKO,))
        if wire:
            self._pin(monkeypatch, "boundary_wire_eval", JE.boundary_wire_eval,
                      TE.boundary_wire_eval, (JE,), (TE,))

    def _pin(self, monkeypatch, name, ref_fn, port_fn, ref_mods, port_mods):
        def keep(x, y):
            self.pairs.append((np.asarray(x), np.asarray(y)))

        def record(*args):
            y = ref_fn(*args)
            x = args[1] if name == "boundary_wire_eval" else args[0]
            jax.debug.callback(keep, x, y)      # runs under autodiff too
            return y

        def replay(*args):
            jx, jy = self.pairs[self.replayed]
            self.replayed += 1
            i = 1 if name == "boundary_wire_eval" else 0
            assert _gap(args[i], jx) <= RTOL, f"{name} input {self.replayed}"
            args = list(args)
            args[i] = tensor_from_numpy(jx, args[i].device)
            y = port_fn(*args)
            want = tensor_from_numpy(jy, y.device)
            if self.jitted:
                return want
            assert torch.equal(y, want), \
                f"{name} output {self.replayed} is not the reference's"
            return y

        for m in ref_mods:
            monkeypatch.setattr(m, name, record)
        for m in port_mods:
            monkeypatch.setattr(m, name, replay)


def enc_embeds(cfg, b=B, seed=11):
    """Seeded N(0, 1) frame embeddings, bf16, for both packages."""
    x = np.random.RandomState(seed).standard_normal(
        (b, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    return (jnp.asarray(x).astype(jnp.bfloat16),
            torch.from_numpy(x).to(torch.bfloat16))


def batches(cfg, b=B, s=S, seed=1):
    """(reference batch, port batch): seeded tokens and frame embeddings."""
    toks = np.random.RandomState(seed).randint(0, cfg.vocab_size, (b, s))
    je, te = enc_embeds(cfg, b, seed + 10)
    return ({"tokens": jnp.asarray(toks, jnp.int32), "enc_embeds": je},
            {"tokens": torch.from_numpy(toks), "enc_embeds": te})


def _bits(a):
    return np.asarray(_f32(a)).view(np.int32)


# ---------------------------------------------------------------------------
# the pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seq,d", [(32, 256), (1500, 768)])
def test_sinusoidal_pos_matches_reference(seq, d):
    want = np.asarray(jsinusoidal(seq, d))
    got = sinusoidal_pos(seq, d)
    assert got.dtype == torch.float32 and tuple(got.shape) == (seq, d)
    assert np.abs(got.numpy() - want).max() <= POS_ATOL
    wb = np.asarray(jnp.asarray(want).astype(jnp.bfloat16).astype(
        jnp.float32))
    gb = got.to(torch.bfloat16).float().numpy()
    if seq == 32:
        assert np.array_equal(gb, wb)
    big = np.abs(wb) >= 2.0 ** -5
    assert np.all(np.abs(gb - wb)[big] <= BF16_ULP * np.abs(wb)[big])
    assert np.abs(gb - wb)[~big].max() <= POS_ATOL


def test_init_params_layout(whisper):
    """The port draws the reference's tree leaf for leaf (names, shapes,
    dtypes); the norms are ones and zeros."""
    jcfg, tcfg, jp, _ = whisper
    TT.check_supported(tcfg)
    own = dict(_leaves(TE.init_params(torch.Generator().manual_seed(0),
                                      tcfg)))
    ref = dict(_leaves(jp))
    assert sorted(own) == sorted(ref)
    for n in ref:
        assert tuple(own[n].shape) == ref[n].shape, n
        assert str(own[n].dtype).split(".")[-1] == str(ref[n].dtype), n
        if "/ln" in n or n.startswith(("/enc_norm", "/final_norm")):
            assert np.array_equal(_f32(own[n]), np.asarray(ref[n])), n
    assert own["/dec_pos"].shape == (tcfg.max_seq, tcfg.d_model)
    assert 0.005 < float(own["/dec_pos"].float().std()) < 0.02


def test_cross_attn_matches_reference(whisper):
    jcfg, _, jp, tp = whisper
    jlp = jax.tree.map(lambda a: a[0], jp["dec_layers"]["xattn"])
    tlp = TT._group(tp["dec_layers"], 0)["xattn"]
    rng = np.random.RandomState(3)
    x = rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    mem = rng.standard_normal((B, 40, jcfg.d_model)).astype(np.float32)
    kw = dict(num_heads=jcfg.num_heads, head_dim=jcfg.resolved_head_dim)
    want = JA.cross_attn(jlp, jnp.asarray(x).astype(jnp.bfloat16),
                         jnp.asarray(mem).astype(jnp.bfloat16), **kw)
    with torch.no_grad():
        got = TA.cross_attn(tlp, torch.from_numpy(x).to(torch.bfloat16),
                            torch.from_numpy(mem).to(torch.bfloat16), **kw)
    assert got.dtype == torch.bfloat16 and _gap(got, want) <= RTOL


def test_encode_matches_reference(whisper):
    jcfg, tcfg, jp, tp = whisper
    je, te = enc_embeds(jcfg)
    want = jax.jit(lambda p, e: JE.encode(p, e, jcfg))(jp, je)
    with torch.no_grad():
        got = TE.encode(tp, te, tcfg)
    assert got.dtype == torch.bfloat16 and _gap(got, want) <= RTOL


@pytest.mark.parametrize("wire", [False, True])
@pytest.mark.parametrize("policy", ["none", "q4q8", "top10"])
def test_forward_eval_matches_reference(policy, wire, whisper,
                                       monkeypatch):
    """Logits with every cut compressed (the memory hop included), by
    the plain fw compressor or, ``wire=True``, through the wire codecs;
    the cuts pinned (``PinnedCx``)."""
    jcfg, tcfg, jp, tp = whisper
    jb, tb = batches(jcfg)
    pins = PinnedCx(monkeypatch, wire=wire)
    want = JE.forward_eval(jp, jb, jcfg, JPOL[policy](), wire=wire)
    with torch.no_grad():
        got = TE.forward_eval(tp, tb, tcfg, TPOL[policy](), wire=wire)
    assert tuple(got.shape) == (B, S, jcfg.vocab_size)
    assert _gap(got, want) <= RTOL
    cuts = 0 if policy == "none" else 2       # the memory hop and one cut
    assert pins.replayed == len(pins.pairs) == cuts


@pytest.mark.parametrize("policy", ["none", "q4q8", "top10"])
def test_forward_hidden_matches_reference(policy, whisper, monkeypatch):
    """The training forward's hidden states (remat on), aux 0, and one
    cut state a cut; the memory hop and the cut pinned."""
    jcfg, tcfg, jp, tp = whisper
    jb, tb = batches(jcfg)
    pins = PinnedCx(monkeypatch)
    jpol, tpol = JPOL[policy](), TPOL[policy]()
    cuts = len(TT.segment_bounds(tcfg.num_layers, tpol.num_stages)) - 1
    jst = [jinit(jpol.at(i), (S, jcfg.d_model), batch=B, dtype=jnp.bfloat16)
           for i in range(cuts)]
    tst = [tinit(tpol.at(i), (S, tcfg.d_model), batch=B,
                 dtype=torch.bfloat16) for i in range(cuts)]
    jx, jaux, jfw = JE.forward_hidden(jp, jb, jcfg, jpol, jst or None,
                                      jnp.arange(B))
    with torch.no_grad():
        tx, taux, tfw, slots = TE.forward_hidden(tp, tb, tcfg, tpol,
                                                 tst or None, torch.arange(B))
    assert float(taux) == float(jaux) == 0.0
    assert len(tfw) == len(slots) == len(jfw) == cuts
    assert _gap(tx, jx) <= RTOL
    assert pins.replayed == len(pins.pairs) == 2 * cuts


# ---------------------------------------------------------------------------
# the memory hop's C(x) and its gradient
# ---------------------------------------------------------------------------

def _hop_inputs(kind):
    """name -> (B, N) bf16 inputs: seeded N(0, 1) at the smoke memory's
    shape (tile (2, 2048)) and at a (2, 8192) 4-tile case; ties (values
    from a small integer set, so each tile's min and max repeat and TopK's
    threshold falls on a run of equal magnitudes); a TopK input with an
    all-zero tile row, one with fewer non-zeros than k (zeros kept) and one
    with more (zeros dropped); a width that is not a multiple of 128 (one
    whole-tensor tile)."""
    rng = np.random.RandomState(5)
    out = {"smoke memory": rng.standard_normal((2, 32 * 256)),
           "ties": rng.randint(-3, 4, (2, 8192)) * 0.5,
           "odd width": rng.standard_normal((3, 1000))}
    if kind == "topk":
        z = np.zeros((2, 8192))
        z[0, :2048] = rng.standard_normal(2048)         # tile 0 dense
        z[0, 2048:2048 + 50] = rng.standard_normal(50)  # tile 1 < k
        z[1, 4096:4096 + 1500] = 0.25 * np.sign(
            rng.standard_normal(1500))                  # ties, > k
        out["zeros"] = z
    return {k: v.astype(np.float32) for k, v in out.items()}


HOP = {"q4": ("quant", 4), "q8": ("quant", 8), "top10": ("topk", 0.1)}


@pytest.mark.parametrize("name", list(HOP))
def test_memory_hop_gradient_matches_oracle(name):
    """A bare ``Compressor`` call (the memory hop): C(x) bitwise the
    oracle's; the gradient for a seeded cotangent against ``jax.vjp`` of
    the oracle at the same tile."""
    kind, arg = HOP[name]
    for label, x in _hop_inputs(kind).items():
        ct = np.random.RandomState(6).standard_normal(x.shape).astype(
            np.float32)
        jx, jct = (jnp.asarray(a).astype(jnp.bfloat16) for a in (x, ct))
        fn = (lambda v: _oracle_quant(v, arg)) if kind == "quant" else \
            (lambda v: _oracle_topk(v, arg))
        jy, vjp = jax.vjp(fn, jx)
        (jg,) = vjp(jct)
        tx = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
        comp = TCC.Compressor(kind, **{"bits" if kind == "quant"
                                       else "k_frac": arg})
        ty = comp(tx)
        ty.backward(torch.from_numpy(ct).to(torch.bfloat16))
        assert np.array_equal(_bits(ty), _bits(jy)), label
        got, want = _f32(tx.grad), _f32(jg)
        if kind == "topk":
            assert np.array_equal(got, want), label
            continue
        assert np.array_equal(got != 0, want != 0), label
        nz = want != 0
        assert np.all(np.abs(got - want)[nz]
                      <= BF16_ULP * np.abs(want)[nz]), label
        if label == "smoke memory":      # each tile's min and max
            assert nz.sum() == 2 * 4, nz.sum()


def test_memory_hop_carries_a_gradient_into_the_encoder(whisper):
    """Under q4q8 and top10 the encoder's leaves receive a non-zero
    gradient through the memory hop, and the hop's C(x) is the policy's
    fw compressor."""
    _, tcfg, _, tp = whisper
    _, tb = batches(tcfg)
    for name in ("q4q8", "top10"):
        params = {k: v for k, v in _leaves(tp)}
        for v in params.values():
            v.requires_grad_()
        tree = _retree(tp, params)
        x, _, _, _ = TE.forward_hidden(tree, tb, tcfg, TPOL[name]())
        x.float().square().mean().backward()
        enc = [v.grad for k, v in params.items()
               if k.startswith("/enc_layers")]
        assert all(g is not None and bool(g.abs().sum() > 0) for g in enc)
        for v in params.values():
            v.grad = None
            v.requires_grad_(False)


def _retree(tree, flat, prefix=""):
    if isinstance(tree, dict):
        return {k: _retree(v, flat, f"{prefix}/{k}") for k, v in tree.items()}
    return flat[prefix]


# ---------------------------------------------------------------------------
# prefill, decode, positions
# ---------------------------------------------------------------------------

def test_prefill_matches_reference(whisper):
    """Last-token logits, the K/V caches (L, B, C, H, hd) and the
    memory of a prefill into a 24-row cache."""
    jcfg, tcfg, jp, tp = whisper
    jb, tb = batches(jcfg)
    jl, (jc, jm) = JE.prefill(jp, jb, jcfg, cache_len=24)
    with torch.no_grad():
        tl, (tc, tm) = TE.prefill(tp, tb, tcfg, cache_len=24)
    assert tuple(tl.shape) == (B, 1, jcfg.vocab_size)
    assert _gap(tl, jl) <= RTOL and _gap(tm, jm) <= RTOL
    assert sorted(tc) == sorted(jc) == ["k", "v"]
    for k in tc:
        assert tuple(tc[k].shape) == jc[k].shape == (
            jcfg.num_layers, B, 24, jcfg.num_heads, jcfg.resolved_head_dim)
        assert tc[k].dtype == torch.bfloat16 and _gap(tc[k], jc[k]) <= RTOL
    empty = TE.init_caches(tcfg, B, 24, device="cpu")
    assert all(empty[k].shape == tc[k].shape and not empty[k].any()
               for k in tc)


@pytest.mark.parametrize("package", ["port", "reference"])
def test_prefill_then_decode_equals_prefill(package, whisper):
    """Prefill of S - 2 tokens and 2 decode steps: the logits of
    prefilling S - 1 and S (each package against itself, 4 stages
    uncompressed: a wire cut packs a prefill's rows with one scale, a
    decode step's with another), the port's caches written in place."""
    jcfg, tcfg, jp, tp = whisper
    jb, tb = batches(jcfg)
    pol = (JPOL if package == "reference" else TPOL)["none"]()
    outs, wants = [], []
    if package == "reference":
        mod, b, asarray = JE, jb, lambda a: jnp.asarray(a, jnp.int32)
    else:
        mod, b, asarray = TE, tb, torch.as_tensor
        torch.set_grad_enabled(False)
    try:
        toks = np.asarray(b["tokens"])
        for s in (S - 1, S):
            wl, _ = mod.prefill(tp if package == "port" else jp,
                                {**b, "tokens": asarray(toks[:, :s])},
                                tcfg if package == "port" else jcfg, pol,
                                cache_len=S, wire=True)
            wants.append(_f32(wl[:, 0]))
        params, cfg = (tp, tcfg) if package == "port" else (jp, jcfg)
        logits, state = mod.prefill(params,
                                    {**b, "tokens": asarray(toks[:, :S - 2])},
                                    cfg, pol, cache_len=S, wire=True)
        held = state[0]["k"] if package == "port" else None
        for pos in (S - 2, S - 1):
            logits, state = mod.decode_step(params, asarray(toks[:, pos]),
                                            state, pos, cfg, pol, wire=True)
            outs.append(_f32(logits))
        if held is not None:
            assert state[0]["k"] is held
    finally:
        torch.set_grad_enabled(True)
    for got, want in zip(outs, wants):
        assert _gap(got, want) <= RTOL


def test_dec_pos_slice_clamps_as_the_reference(whisper):
    """``_embed_tokens`` at offsets that run past ``max_seq`` and a decode
    step at and past it read the reference's rows (the last ones)."""
    jcfg, tcfg, jp, tp = whisper
    toks = np.arange(6)[None] % jcfg.vocab_size
    for pos0 in (0, jcfg.max_seq - 6, jcfg.max_seq - 3, jcfg.max_seq + 7):
        want = JE._embed_tokens(jp, jnp.asarray(toks, jnp.int32), pos0)
        got = TE._embed_tokens(tp, torch.from_numpy(toks), pos0)
        assert np.array_equal(_bits(got), _bits(want)), pos0
    for pos in (jcfg.max_seq - 1, jcfg.max_seq, jcfg.max_seq + 40):
        want = jax.lax.dynamic_slice_in_dim(jp["dec_pos"], pos, 1, 0)
        got = TE._dec_pos(tp, pos, 1)
        assert np.array_equal(_bits(got), _bits(want)), pos
    # a whole decode step past the end: the reference's logits
    jl, (jc, jm) = JE.prefill(jp, {"tokens": jnp.asarray(toks, jnp.int32),
                                   "enc_embeds": enc_embeds(jcfg, 1)[0]},
                              jcfg, cache_len=jcfg.max_seq + 8)
    with torch.no_grad():
        tl, state = TE.prefill(tp, {"tokens": torch.from_numpy(toks),
                                    "enc_embeds": enc_embeds(tcfg, 1)[1]},
                               tcfg, cache_len=tcfg.max_seq + 8)
        got, _ = TE.decode_step(tp, torch.tensor([3]), state,
                                jcfg.max_seq + 2, tcfg)
    want, _ = JE.decode_step(jp, jnp.asarray([3], jnp.int32), (jc, jm),
                             jcfg.max_seq + 2, jcfg)
    assert _gap(got, want) <= RTOL


def test_eval_step_dispatches(whisper):
    """``make_lm_eval_step`` runs the encoder-decoder in both packages:
    losses within 2e-3 (tests/test_torch_recurrent_models.py's bound)."""
    import repro.train.steps as JS
    import repro_torch.train.steps as TS
    jcfg, tcfg, jp, tp = whisper
    jb, tb = batches(jcfg)
    want = JS.make_lm_eval_step(jcfg, JNONE, True)(jp, jb)
    got = TS.make_lm_eval_step(tcfg, NO_POLICY, True)(tp, tb)
    assert abs(float(got) - float(want)) <= 2e-3
