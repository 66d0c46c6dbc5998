"""The lane grids (``launch/mesh.py``), the sharding rules
(``sharding/specs.py``) and the constraint context (``sharding/ctx.py``)
against the JAX package on its real meshes.

The reference side runs in ONE subprocess with 512 forced host devices
(the production meshes need them); it also runs the port's side and
prints, for each case, the mismatches it found.  Every case is a test
here:

  * grids: axis names, shape and lane ids (row-major) of every mesh
    maker against the reference mesh's device ids;
  * for every arch at full width on the (16, 16) and (2, 16, 16)
    production grids and a (2, 2, 2) 3D grid: ``param_spec`` of every
    leaf, ``opt_state_shardings``, ``batch_spec`` of every applicable
    shape's batch / ids / token, ``cache_spec`` of its decode caches
    (whisper's memory through ``batch_spec``), entry for entry; and the
    bytes one lane holds (``device_bytes``) equal the sum of the
    reference's ``NamedSharding.shard_shape`` bytes, exactly, for the
    params, the optimizer state and each shape's inputs;
  * ``default_rules`` and the spec ``constrain`` resolves, for the
    shapes of ``CONSTRAIN_CASES`` (the batch = 1 ``("batch", "seq",
    ...)`` fallback among them).

The size checks raise the reference's ``ValueError`` messages
(in process: they come before any device is touched).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro.configs.registry import ARCHS
from repro.launch import mesh as JM

from repro_torch.launch import mesh as TM
from repro_torch.sharding import ctx as TC

ROOT = Path(__file__).resolve().parents[1]
MESHES = ("16x16", "2x16x16", "3d2x2x2")
GRIDS = ("production", "production_multi", "local", "data4", "dp2x4",
         "tensor4", "3d2x2x2")
CONSTRAIN_CASES = [
    ((256, 4096, 4096), ("batch", "seq", None)),
    ((1, 524288, 8, 128), ("batch", "seq", "model", None)),
    ((128, 32768, 8, 128), ("batch", "seq", "model", None)),
    ((32, 4096), ("batch", "model")),
    ((128, 5120, 8192), ("expert", None, "model")),
    ((2, 6), (None, "model")),
    ((512,), (("batch", "model"),)),
    ((256, 16), ("model", "batch")),
    ((4, 4096), ("seq", "model")),
    ((0, 4096), ("batch", "model")),
]

CODE = r'''
import json, os, sys
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=512")
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding

from repro.configs.registry import ARCHS, get as jget
from repro.launch import mesh as JM, input_specs as JI
from repro.models import encdec as JE, transformer as JT
from repro.optim.optimizers import OptimizerConfig as JOC, init_opt_state as jopt
from repro.sharding import ctx as JC, specs as JS

import torch
from repro_torch.configs.registry import get as tget
from repro_torch.launch import mesh as TM, input_specs as TI
from repro_torch.optim.optimizers import OptimizerConfig as TOC, init_opt_state as topt
from repro_torch.sharding import ctx as TC, specs as TS

CASES = json.loads(sys.argv[1])
out = {}


def norm(spec, nd):
    ents = [None if e is None else ((e,) if isinstance(e, str) else tuple(e))
            for e in tuple(spec)]
    return tuple(ents + [None] * (nd - len(ents)))


def jleaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [(JS._path_str(p), l) for p, l in flat]


def jbytes(tree, shardings):
    total = 0
    for (p, l), (_, s) in zip(jleaves(tree), jleaves(shardings)):
        total += (int(np.prod(s.shard_shape(tuple(l.shape)), dtype=np.int64))
                  * jnp.dtype(l.dtype).itemsize)
    return total


def cmp_specs(tag, jtree, jshard, ttree, tspecs, bad, mesh, grid):
    jspec = {p: norm(s.spec, len(l.shape)) for (p, l), (_, s)
             in zip(jleaves(jtree), jleaves(jshard))}
    tl = dict(TS.tree_paths(ttree))
    if set(jspec) != set(tl):
        bad.append(f"{tag}: paths {sorted(set(jspec) ^ set(tl))}")
        return
    got = {}
    def walk(t, s, prefix=""):
        if isinstance(t, dict):
            for k in t:
                walk(t[k], s[k], f"{prefix}/{k}" if prefix else str(k))
        elif isinstance(t, (list, tuple)):
            for i, v in enumerate(t):
                walk(v, s[i], f"{prefix}/{i}" if prefix else str(i))
        else:
            got[prefix] = s
    walk(ttree, tspecs)
    for p in jspec:
        if jspec[p] != got[p]:
            bad.append(f"{tag} {p}: {got[p]} != {jspec[p]}")
    jb, tb = jbytes(jtree, jshard), TS.device_bytes(grid, ttree, tspecs)
    if jb != tb:
        bad.append(f"{tag} bytes: {tb} != {jb}")


def meshes(name):
    if name == "16x16":
        return JM.make_production_mesh(), TM.make_production_mesh()
    if name == "2x16x16":
        return (JM.make_production_mesh(multi_pod=True),
                TM.make_production_mesh(multi_pod=True))
    return JM.make_3d_mesh(2, 2, 2), TM.make_3d_mesh(2, 2, 2)


# --- grids -------------------------------------------------------------
makers = {
    "production": (lambda m: m.make_production_mesh()),
    "production_multi": (lambda m: m.make_production_mesh(multi_pod=True)),
    "local": (lambda m: m.make_local_mesh()),
    "data4": (lambda m: m.make_data_mesh(4)),
    "dp2x4": (lambda m: m.make_dp_pipeline_mesh(2, 4)),
    "tensor4": (lambda m: m.make_tensor_mesh(4)),
    "3d2x2x2": (lambda m: m.make_3d_mesh(2, 2, 2)),
}
for name, make in makers.items():
    jm, tg = make(JM), make(TM)
    bad = []
    if tuple(jm.axis_names) != tg.axis_names:
        bad.append(f"axes {tg.axis_names} != {jm.axis_names}")
    if tuple(jm.devices.shape) != tg.shape:
        bad.append(f"shape {tg.shape} != {jm.devices.shape}")
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    if not np.array_equal(ids, tg.lanes):
        bad.append(f"lanes {tg.lanes.tolist()} != {ids.tolist()}")
    out["grid/" + name] = bad

# --- specs and bytes ---------------------------------------------------
opt_j = JOC(kind="adamw", lr=1e-4, moment_dtype=jnp.bfloat16,
            weight_decay=0.0, schedule="constant")
opt_t = TOC(kind="adamw", lr=1e-4, moment_dtype=torch.bfloat16,
            weight_decay=0.0, schedule="constant")
for arch in ARCHS:
    jcfg, tcfg = jget(arch), tget(arch)
    jmod = JE if jcfg.enc_dec else JT
    jp = jax.eval_shape(lambda: jmod.init_params(jax.random.PRNGKey(0), jcfg))
    jo = jax.eval_shape(lambda: jopt(opt_j, jp))
    tp = TI.param_specs(tcfg)
    to = topt(opt_t, tp)
    for mname in CASES["meshes"]:
        jm, tg = meshes(mname)
        bad = []
        cmp_specs("params", jp, JS.param_shardings(jm, jp), tp,
                  TS.param_shardings(tg, tp), bad, jm, tg)
        cmp_specs("opt", jo, JS.opt_state_shardings(jm, jo), to,
                  TS.opt_state_shardings(tg, to), bad, jm, tg)
        for sname, js in JI.SHAPES.items():
            if not JI.applicable(jcfg, sname):
                continue
            ts = TI.SHAPES[sname]
            ji, ti = JI.ids_spec(js), TI.ids_spec(ts)
            cmp_specs(sname + " ids", ji, JS.batch_shardings(jm, ji), ti,
                      TS.batch_shardings(tg, ti), bad, jm, tg)
            if js.kind != "decode":
                jb, tb = JI.batch_specs(jcfg, js), TI.batch_specs(tcfg, ts)
                cmp_specs(sname + " batch", jb, JS.batch_shardings(jm, jb),
                          tb, TS.batch_shardings(tg, tb), bad, jm, tg)
                continue
            (jt, jc, _), (tt, tc, _) = (JI.decode_specs(jcfg, js),
                                        TI.decode_specs(tcfg, ts))
            cmp_specs(sname + " token", jt, JS.batch_shardings(jm, jt), tt,
                      TS.batch_shardings(tg, tt), bad, jm, tg)
            if jcfg.enc_dec:
                cmp_specs(sname + " caches", jc[0],
                          JS.cache_shardings(jm, jc[0], batch_dim=1), tc[0],
                          TS.cache_shardings(tg, tc[0], batch_dim=1), bad,
                          jm, tg)
                cmp_specs(sname + " memory", jc[1],
                          JS.batch_shardings(jm, jc[1]), tc[1],
                          TS.batch_shardings(tg, tc[1]), bad, jm, tg)
            else:
                cmp_specs(sname + " caches", jc,
                          JS.cache_shardings(jm, jc, batch_dim=1), tc,
                          TS.cache_shardings(tg, tc, batch_dim=1), bad,
                          jm, tg)
        out[f"specs/{arch}/{mname}"] = bad

# --- rules and constrain -----------------------------------------------
seen = []
jax.lax.with_sharding_constraint = lambda x, s: seen.append(s) or x
for mname in CASES["meshes"]:
    jm, tg = meshes(mname)
    bad = []
    jr, tr = JC.default_rules(jm), TC.default_rules(tg)
    if {k: tuple(v) for k, v in jr.items()} != tr:
        bad.append(f"rules {tr} != {jr}")
    for shape, axes in CASES["constrain"]:
        axes = tuple(tuple(a) if isinstance(a, list) else a for a in axes)
        with JC.use_mesh(jm):
            seen.clear()
            JC.constrain(jax.ShapeDtypeStruct(tuple(shape), jnp.float32),
                         *axes)
            want = norm(seen[0].spec, len(shape))
        with TC.use_mesh(tg):
            x = torch.empty(shape, device="meta")
            got = TC.constrain_spec(tuple(shape), *axes)
            if TC.constrain(x, *axes) is not x:
                bad.append(f"constrain {shape} did not return x")
        if got != want:
            bad.append(f"constrain {shape} {axes}: {got} != {want}")
    out["ctx/" + mname] = bad

print("RESULT " + json.dumps(out))
'''


@pytest.fixture(scope="module")
def results():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    arg = json.dumps({"meshes": MESHES, "constrain": CONSTRAIN_CASES})
    proc = subprocess.run([sys.executable, "-c", CODE, arg], env=env,
                          capture_output=True, text=True, timeout=600)
    lines = [l for l in proc.stdout.splitlines() if l.startswith("RESULT ")]
    assert proc.returncode == 0 and lines, proc.stderr[-4000:]
    return json.loads(lines[-1][len("RESULT "):])


@pytest.mark.parametrize("name", GRIDS)
def test_grid_matches_reference_mesh(results, name):
    assert results["grid/" + name] == []


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", list(ARCHS))
def test_specs_and_bytes_match_reference(results, arch, mesh):
    assert results[f"specs/{arch}/{mesh}"] == []


@pytest.mark.parametrize("mesh", MESHES)
def test_rules_and_constrain_match_reference(results, mesh):
    assert results["ctx/" + mesh] == []


def test_size_checks_raise_the_reference_errors():
    calls = [lambda m: m.make_data_mesh(0),
             lambda m: m.make_dp_pipeline_mesh(0, 2),
             lambda m: m.make_dp_pipeline_mesh(2, 0),
             lambda m: m.make_tensor_mesh(0),
             lambda m: m.make_3d_mesh(1, 0, 2),
             lambda m: m.make_3d_mesh(1, 1, 0)]
    for call in calls:
        with pytest.raises(ValueError) as want:
            call(JM)
        with pytest.raises(ValueError) as got:
            call(TM)
        assert str(got.value) == str(want.value)


def test_constrain_without_a_grid_is_the_identity():
    import torch
    x = torch.zeros(2, 3)
    assert TC.get_mesh() is None and TC.constrain(x, "batch") is x
    with TC.use_mesh(TM.make_local_mesh()):
        with pytest.raises(AssertionError):
            TC.constrain(x, "batch")
    assert TC.get_mesh() is None
