"""The port's npz checkpoints against the JAX package's, both ways.

A params-only file written by one package is read by the other bitwise:
the CNN's tree (lists of lists of dicts, keys such as
``stages/0/1/conv1``), the pipeline CNN's stacked tree, and the smoke
LMs', whose bf16 leaves travel as uint16 views under ``<key>@bf16``:
gpt2-small's and llama4-maverick's (dense / MoE groups: an f32 router,
expert stacks with a leading expert dim, a shared expert).
The step and the meta's ``extra`` cross with them.
"""
import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import repro.models.cnn as JC
import repro.models.transformer as JT
from repro.checkpoint import io as JIO
from repro.configs.registry import get as jget

from repro_torch.checkpoint import io as TIO
from repro_torch.checkpoint.convert import params_from_numpy

# One intra-op thread: the suite runs in several worker processes at
# once, and a torch thread pool per worker that outnumbers the cores
# slows its CPU ops by an order of magnitude.
torch.set_num_threads(1)


def _trees():
    return {
        "cnn": JC.init_params(jax.random.PRNGKey(0), width=8),
        "pipeline_cnn": JC.init_pipeline_params(jax.random.PRNGKey(1), 2,
                                                width=8),
        "lm": JT.init_params(jax.random.PRNGKey(2),
                             jget("gpt2-small", smoke=True)),
        "llama4": JT.init_params(
            jax.random.PRNGKey(3),
            jget("llama4-maverick-400b-a17b", smoke=True)),
    }


def _bits(a):
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return a.view(np.uint16)
    return a.view(np.uint8)


def _assert_same(tport, tref):
    ref = jax.tree_util.tree_flatten_with_path(tref)[0]
    port = jax.tree_util.tree_flatten_with_path(tport)[0]
    assert [p for p, _ in ref] == [p for p, _ in port]
    for (path, a), (_, b) in zip(ref, port):
        assert isinstance(b, torch.Tensor)
        want = params_from_numpy(np.asarray(a), "cpu")
        assert b.dtype == want.dtype and b.shape == want.shape, path
        assert torch.equal(b.view(torch.uint8), want.view(torch.uint8)), path


@pytest.mark.parametrize("name", ["cnn", "pipeline_cnn", "lm", "llama4"])
def test_reference_file_restores_in_the_port(name, tmp_path):
    tree = _trees()[name]
    path = str(tmp_path / "ref.npz")
    JIO.save(path, tree, step=7)
    like = jax.tree.map(lambda a: torch.zeros(
        a.shape, dtype=params_from_numpy(np.asarray(a)[:0], "cpu").dtype),
        tree)
    got, step = TIO.restore_params(path, like)
    assert step == 7
    _assert_same(got, tree)


@pytest.mark.parametrize("name", ["cnn", "pipeline_cnn", "lm", "llama4"])
def test_port_file_restores_in_the_reference(name, tmp_path):
    tree = _trees()[name]
    port = params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")
    path = str(tmp_path / "port")
    TIO.save(path, port, step=3, extra={"policy": "top10"})
    want = str(tmp_path / "ref")
    JIO.save(want, tree, step=3, extra={"policy": "top10"})
    with np.load(path + ".npz") as a, np.load(want + ".npz") as b:
        assert sorted(a.files) == sorted(b.files)
        assert json.loads(str(a["__meta__"])) == \
            json.loads(str(b["__meta__"]))
        for k in a.files:
            if k != "__meta__":
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k])
    got, step = JIO.restore(path + ".npz", tree)
    assert step == 3
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(tree),
                    strict=True):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(_bits(a), _bits(b))
    back, _ = TIO.restore_params(path + ".npz", port)
    _assert_same(back, tree)


def test_cnn_keys_are_the_reference_keys(tmp_path):
    tree = _trees()["cnn"]
    TIO.save(str(tmp_path / "p"), params_from_numpy(
        jax.tree.map(np.asarray, tree), "cpu"))
    with np.load(tmp_path / "p.npz") as f:
        keys = set(f.files)
    assert "stages/0/1/conv1" in keys and "stages/3/0/proj" in keys
    assert "stages/2/1/gn2/scale" in keys and "fc_b" in keys
    assert len(keys) == 1 + len(jax.tree.leaves(tree))


def test_restore_reports_a_missing_list_entry(tmp_path):
    tree = _trees()["cnn"]
    port = params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")
    short = dict(port, stages=port["stages"][:3])
    TIO.save(str(tmp_path / "short"), short)
    with pytest.raises(TIO.CheckpointMismatch, match="stages/3/0/conv1"):
        TIO.restore_params(str(tmp_path / "short.npz"), port)


def test_float32_file_restores_into_bfloat16_like_both_packages(tmp_path):
    """A file of float32 leaves restored with a bfloat16 ``params_like``:
    both packages check shapes only and return the file's float32 leaves,
    the same values bit for bit."""
    rng = np.random.default_rng(0)
    tree = {"embed": rng.standard_normal((6, 4)).astype(np.float32),
            "layers": {"w": rng.standard_normal((2, 4, 3)).astype(
                np.float32)}}
    path = str(tmp_path / "f32.npz")
    JIO.save(path, jax.tree.map(jnp.asarray, tree), step=5)
    ref, ref_step = JIO.restore_params(
        path, jax.tree.map(lambda a: jnp.zeros(a.shape, jnp.bfloat16), tree))
    got, step = TIO.restore_params(
        path, jax.tree.map(lambda a: torch.zeros(a.shape,
                                                 dtype=torch.bfloat16), tree))
    assert step == ref_step == 5
    for a, b in zip(jax.tree.leaves(ref), jax.tree.leaves(got), strict=True):
        assert a.dtype == jnp.float32 and b.dtype == torch.float32
        np.testing.assert_array_equal(np.asarray(a).view(np.uint32),
                                      b.numpy().view(np.uint32))
