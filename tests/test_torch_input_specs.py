"""The dry run's inputs against the JAX package: the shape-only parameter
tree (``init_params(common.SHAPE_ONLY, cfg)``), ``launch/input_specs.py``
and the registry's parameter counts.

  * for all 11 archs at full width, the meta tree has every path, shape
    and dtype of the reference's ``jax.eval_shape(init_params)``, and
    holds no storage;
  * the same for every applicable ``SHAPES`` entry's ``batch_specs`` /
    ``decode_specs`` / ``ids_spec``, and ``applicable`` agrees on every
    (arch, shape);
  * at smoke size the meta tree is the port's real init, leaf for leaf
    (path, shape, dtype), and the real init still draws: two draws from
    one seed are equal and hold values.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.input_specs as JI
from repro.configs.registry import ARCHS as JARCHS, get as jget
from repro.models import encdec as JE, transformer as JT
from repro.models.config import active_param_count as j_active
from repro.sharding.specs import _path_str

import repro_torch.launch.input_specs as TI
from repro_torch.configs.registry import ARCHS, get
from repro_torch.models.config import active_param_count as t_active
from repro_torch.sharding.specs import tree_paths

torch.set_num_threads(1)


def _jax_leaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {_path_str(p): (tuple(l.shape), jnp.dtype(l.dtype).name)
            for p, l in flat}


def _torch_leaves(tree):
    out = {}
    for path, leaf in tree_paths(tree):
        out[path] = (tuple(leaf.shape), str(leaf.dtype).split(".")[-1])
    return out


def _all_meta(tree):
    return all(leaf.is_meta for _, leaf in tree_paths(tree))


def test_arch_lists_agree():
    assert list(ARCHS) == list(JARCHS)
    assert len(ARCHS) == 11


@pytest.mark.parametrize("arch", list(JARCHS))
def test_param_tree_matches_reference_at_full_width(arch):
    jcfg = jget(arch)
    jmod = JE if jcfg.enc_dec else JT
    want = _jax_leaves(jax.eval_shape(
        lambda: jmod.init_params(jax.random.PRNGKey(0), jcfg)))
    tree = TI.param_specs(get(arch))
    assert _torch_leaves(tree) == want
    assert _all_meta(tree)
    assert t_active(get(arch)) == j_active(jcfg)


@pytest.mark.parametrize("arch", list(JARCHS))
def test_input_specs_match_reference(arch):
    jcfg, cfg = jget(arch), get(arch)
    assert list(TI.SHAPES) == list(JI.SHAPES)
    for name, jshape in JI.SHAPES.items():
        shape = TI.SHAPES[name]
        assert (shape.name, shape.kind, shape.seq, shape.batch) == (
            jshape.name, jshape.kind, jshape.seq, jshape.batch)
        assert TI.applicable(cfg, name) == JI.applicable(jcfg, name)
        if not JI.applicable(jcfg, name):
            continue
        assert _torch_leaves(TI.ids_spec(shape)) == _jax_leaves(
            JI.ids_spec(jshape))
        if shape.kind == "decode":
            got, want = TI.decode_specs(cfg, shape), JI.decode_specs(
                jcfg, jshape)
        else:
            got, want = TI.batch_specs(cfg, shape), JI.batch_specs(
                jcfg, jshape)
        assert _torch_leaves(got) == _jax_leaves(want), name
        assert _all_meta(got)


@pytest.mark.parametrize("arch", list(JARCHS))
def test_meta_tree_is_the_real_init_at_smoke_size(arch):
    cfg = get(arch, smoke=True)
    mod = TI.model_module(cfg)
    real = mod.init_params(torch.Generator().manual_seed(0), cfg)
    again = mod.init_params(torch.Generator().manual_seed(0), cfg)
    meta = mod.init_params(TI.SHAPE_ONLY, cfg)
    assert _torch_leaves(meta) == _torch_leaves(real)
    assert _all_meta(meta)
    pairs = list(zip((l for _, l in tree_paths(real)),
                     (l for _, l in tree_paths(again))))
    assert all(not a.is_meta and torch.equal(a, b) for a, b in pairs)
    assert float(real["embed"].float().abs().sum()) > 0


def test_shape_only_init_draws_nothing():
    """``draws`` hands the meta init no generator, and the real init its
    own: the seeded draws are those the generator gives."""
    from repro_torch.models.common import SHAPE_ONLY, dense_init, draws
    g = torch.Generator().manual_seed(3)
    assert draws(g) is g and draws(SHAPE_ONLY) is None
    a = dense_init(torch.Generator().manual_seed(3), 8, 4)
    t = torch.empty((8, 4), dtype=torch.float32)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=g)
    assert torch.equal(a, t.div_(np.sqrt(8)).to(torch.bfloat16))
    m = dense_init(SHAPE_ONLY, 8, 4, lead=(3,))
    assert m.is_meta and tuple(m.shape) == (3, 8, 4)
