"""Error-feedback training runs and the experiment loop of the port
against the JAX package.

The loss curves of ``ef21top10`` and AQ-SGD (unique ids per batch, rows
revisited from step 3 on) are held to ``CURVE_ATOL`` exactly as in
tests/test_torch_train_curves.py, which states the bound and why.
``run_lm_experiment`` (2 epochs of 4 steps on a small ``LMData``, TopK
10% at every cut, the loop's default AdamW) is held to the same bound in
its train curve and in its eval losses with compression on and off
(measured: largest gap 0.031 in the curve, 0.00022 / 0.0078 on / off).
"""
import numpy as np
import pytest

from repro.data.synthetic import LMData as JLMData
from repro.train.loop import run_lm_experiment as jrun

from repro_torch.data.synthetic import LMData as TLMData
from repro_torch.train.loop import run_lm_experiment as trun

from test_torch_train_curves import (CURVE_ATOL, loss_curves, models,  # noqa: F401
                                     pallas_reference, policies)


@pytest.mark.parametrize("name", ["ef21top10", "aqsgd"])
def test_feedback_loss_curve_tracks_reference(models, name,
                                              pallas_reference, monkeypatch):
    got, want = loss_curves(models, name, monkeypatch)
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= CURVE_ATOL, (got, want)


def test_run_lm_experiment_tracks_reference(models, pallas_reference):
    jcfg, tcfg, jp, tp = models
    kw = dict(num_train=16, num_test=8, seq_len=32, vocab=256, seed=1)
    jpol, tpol = policies("top10")
    want = jrun(jcfg, jpol, pretrained_params=jp, epochs=2, batch=4,
                data=JLMData(**kw))
    got = trun(tcfg, tpol, pretrained_params=tp, epochs=2, batch=4,
               data=TLMData(**kw), device="cpu")
    assert len(got.train_curve) == len(want.train_curve) == 8
    assert np.abs(np.array(got.train_curve)
                  - np.array(want.train_curve)).max() <= CURVE_ATOL
    assert abs(got.loss_on - want.loss_on) <= CURVE_ATOL
    assert abs(got.loss_off - want.loss_off) <= CURVE_ATOL
    assert got.loss_on != got.loss_off
    assert got.name == want.name
