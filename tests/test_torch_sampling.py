"""The port's sampler: the reference's configuration and filters exactly,
and its own generator contract (``repro_torch/serve/sampling.py``).

The reference draws from a threefry key chain that torch cannot
reproduce, so streams are not compared across packages: the keep-masks
of ``_filter_logits`` (top-k with ties at the k-th value kept, nucleus)
are, and the port's draws are held to their distribution — the softmax
of the filtered logits — and to the per-request contract (greedy takes
no randomness; a row's token depends on its own generator and logits
only).
"""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.serve import sampling as JS

from repro_torch.serve import sampling as TS

torch.set_num_threads(1)

CONFIGS = [(0.0, 0, 1.0), (1.0, 0, 1.0), (0.8, 40, 1.0), (1.0, 0, 0.9),
           (0.7, 5, 0.8), (1.3, 1, 0.5), (1.0, 600, 1.0)]


@pytest.mark.parametrize("t,k,p", CONFIGS)
def test_config_name_and_flags_match_reference(t, k, p):
    j, c = JS.SamplingConfig(t, k, p), TS.SamplingConfig(t, k, p)
    assert (c.name, c.greedy) == (j.name, j.greedy)
    assert TS.GREEDY == TS.SamplingConfig() and TS.GREEDY.name == "greedy"
    with pytest.raises(dataclasses.FrozenInstanceError):
        c.temperature = 2.0


@pytest.mark.parametrize("bad", [dict(temperature=-0.1), dict(top_p=0.0),
                                 dict(top_p=1.5), dict(top_k=-1)])
def test_config_validation_matches_reference(bad):
    with pytest.raises(ValueError) as jerr:
        JS.SamplingConfig(**bad)
    with pytest.raises(ValueError) as terr:
        TS.SamplingConfig(**bad)
    assert str(terr.value) == str(jerr.value)


def _logits(seed, b=6, v=300):
    rng = np.random.RandomState(seed)
    x = (rng.randn(b, v) * 2).astype(np.float32)
    # ties at the k-th value: row 0's top 12 values are equal, and row 1's
    # top 43 or 44
    x[0, :12] = x[0].max() + 1
    x[1, ::7] = x[1].max()
    return x


@pytest.mark.parametrize("t,k,p", [c for c in CONFIGS if c[0]])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_filter_keep_masks_match_reference(t, k, p, seed):
    x = _logits(seed) / np.float32(t)
    cfg_j, cfg_t = JS.SamplingConfig(t, k, p), TS.SamplingConfig(t, k, p)
    want = np.isfinite(np.asarray(JS._filter_logits(jnp.asarray(x), cfg_j)))
    got = torch.isfinite(TS._filter_logits(torch.from_numpy(x),
                                           cfg_t)).numpy()
    np.testing.assert_array_equal(got, want)


def test_top_k_keeps_ties_at_the_kth_value():
    x = torch.from_numpy(_logits(0))
    got = torch.isfinite(TS._filter_logits(x, TS.SamplingConfig(1.0, 5)))
    n = got.sum(-1).tolist()
    assert n[0] == 12 and n[1] >= 43                # tied at the top
    assert bool((got.sum(-1)[2:] == 5).all())


def test_greedy_is_first_argmax_and_takes_no_randomness():
    x = torch.from_numpy(_logits(3))
    x[2, 5] = x[2, 9] = x[2].max() + 1            # a tie: the first index
    gens = [TS.request_key(s, "cpu") for s in range(6)]
    states = [g.get_state() for g in gens]
    tok = TS.sample_tokens(x.to(torch.bfloat16), gens, TS.GREEDY)
    assert tok.tolist() == torch.argmax(
        x.to(torch.bfloat16).float(), -1).tolist()
    assert int(tok[2]) == 5
    assert all(torch.equal(g.get_state(), s) for g, s in zip(gens, states))


def test_a_row_depends_on_its_own_generator_only():
    """The same request (seed, logits) draws the same token whatever
    shares its batch and whichever row it is in; a row without a
    generator takes its filtered argmax and consumes nothing."""
    cfg = TS.SamplingConfig(0.9, 50, 0.95)
    x = torch.from_numpy(_logits(4))
    alone = [TS.sample_tokens(x[i:i + 1], [TS.request_key(10 + i, "cpu")],
                              cfg)[0] for i in range(6)]
    perm = [3, 0, 5, 1, 4, 2]
    batch = TS.sample_tokens(x[perm], [TS.request_key(10 + i, "cpu")
                                       for i in perm], cfg)
    assert batch.tolist() == [int(alone[i]) for i in perm]
    idle = TS.sample_tokens(x, [None] * 6, cfg)
    want = torch.argmax(TS._filter_logits(x / 0.9, cfg), -1)
    assert torch.equal(idle, want)
    g = TS.request_key(7, "cpu")
    seq = [int(TS.sample_tokens(x[:1], [g], cfg)[0]) for _ in range(4)]
    g = TS.request_key(7, "cpu")
    assert seq == [int(TS.sample_tokens(x[:1], [g], cfg)[0])
                   for _ in range(4)]


@pytest.mark.parametrize("t,k,p", [(1.0, 0, 1.0), (0.7, 4, 1.0),
                                   (1.2, 0, 0.8)])
def test_draw_frequencies_follow_the_filtered_softmax(t, k, p):
    """Over 4,000 request seeds the token frequencies of one row match
    softmax(filtered logits / T): every token's count within 5 standard
    deviations of its expectation, nothing outside the filter drawn."""
    cfg = TS.SamplingConfig(t, k, p)
    logits = torch.tensor([[2.0, 1.5, 1.4, 1.0, 0.5, 0.0, -0.5, -1.0,
                            -2.0, -3.0]])
    probs = torch.softmax(TS._filter_logits(logits / t, cfg), -1)[0]
    n = 4000
    counts = torch.zeros(10)
    for seed in range(n):
        tok = TS.sample_tokens(logits, [TS.request_key(seed, "cpu")], cfg)
        counts[int(tok[0])] += 1
    want = probs * n
    sd = torch.sqrt(n * probs * (1 - probs))
    assert bool((counts[probs == 0] == 0).all())
    assert bool(((counts - want).abs() <= 5 * sd + 1e-6).all()), \
        (counts.tolist(), want.tolist())
