"""The port stands alone: no file of ``src/repro_torch/``, of the torch
examples (``examples/*_torch.py``) or ``chip_smoke.py`` imports JAX or
the reference package, and entry points that are given no device ask for
CUDA (and raise where there is none)."""
import ast
import os
import runpy
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch import device as D
from repro_torch.configs.registry import get
from repro_torch.core.parallel import spec_from_cli
from repro_torch.core.policy import POLICIES
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import transformer
from repro_torch.serve.engine import ContinuousEngine
from repro_torch.train.loop import (pretrain_lm, run_cnn_experiment,
                                    run_lm_experiment)

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = {"jax", "jaxlib", "repro"}


def _examples():
    return sorted((ROOT / "examples").glob("*_torch.py"))


def _port_files():
    return (sorted(PORT.rglob("*.py")) + _examples()
            + [ROOT / "chip_smoke.py"])


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    bad = FORBIDDEN & set(_imported_roots(path))
    assert not bad, f"{path} imports {sorted(bad)}"


def test_importing_every_module_loads_no_jax():
    mods = [".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
            for p in sorted(PORT.rglob("*.py"))]
    mods = [m[:-len(".__init__")] if m.endswith(".__init__") else m
            for m in mods]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{sorted(FORBIDDEN)!r})\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_is_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert D.resolve_device() == torch.device("cuda")
    assert D.resolve_device("cpu") == torch.device("cpu")


def test_entry_points_without_device_ask_for_cuda(no_cuda):
    cfg = get("gpt2-small", smoke=True)
    with pytest.raises(RuntimeError, match="cuda"):
        D.resolve_device()
    with pytest.raises(RuntimeError, match="cuda"):
        transformer.init_caches(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="cuda"):
        tserve.main(["--smoke", "--batch", "1", "--new-tokens", "2"])
    with pytest.raises(RuntimeError, match="cuda"):
        tserve.main(["--smoke", "--engine", "static", "--batch", "1",
                     "--new-tokens", "2"])
    with pytest.raises(RuntimeError, match="cuda"):
        tserve.main(["--smoke", "--engine", "continuous", "--prefix-cache",
                     "--requests", "1"])
    params = transformer.init_params(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        ContinuousEngine(params, cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        ContinuousEngine(params, cfg, prefill_chunk=8)
    with pytest.raises(RuntimeError, match="cuda"):
        ttrain.main(["--smoke", "--steps", "1", "--batch", "1"])
    with pytest.raises(RuntimeError, match="cuda"):
        run_lm_experiment(cfg, POLICIES["top10"](), epochs=1)
    with pytest.raises(RuntimeError, match="cuda"):
        ttrain.main(["--smoke", "--steps", "1", "--batch", "2",
                     "--transport", "pipeline", "--stages", "2"])
    with pytest.raises(RuntimeError, match="cuda"):
        run_lm_experiment(cfg, POLICIES["q4q8"](), epochs=1,
                          transport="pipeline", schedule="1f1b")
    with pytest.raises(RuntimeError, match="cuda"):
        ttrain.main(["--smoke", "--steps", "1", "--batch", "2",
                     "--mesh", "data=2", "--wire", "data=q8"])
    with pytest.raises(RuntimeError, match="cuda"):
        run_lm_experiment(cfg, POLICIES["none"](), epochs=1,
                          parallel=spec_from_cli("data=2", "data=q4"))
    with pytest.raises(RuntimeError, match="cuda"):
        run_cnn_experiment(POLICIES["top10"](), epochs=1)
    with pytest.raises(RuntimeError, match="cuda"):
        run_cnn_experiment(POLICIES["q4q8"](), epochs=1,
                           transport="pipeline", schedule="1f1b")
    with pytest.raises(RuntimeError, match="cuda"):
        pretrain_lm(cfg, steps=1)


def test_encdec_entry_points_without_device_ask_for_cuda(no_cuda):
    """whisper's entry points: its caches and both launchers (which draw
    its params through ``encdec.init_params`` on the resolved device and
    serve with the static engine the serve launcher falls back to) ask
    for CUDA; ``models/encdec.py`` is among the files the import check
    reads."""
    from repro_torch.models import encdec
    cfg = get("whisper-small", smoke=True)
    with pytest.raises(RuntimeError, match="cuda"):
        encdec.init_caches(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="cuda"):
        tserve.main(["--arch", "whisper-small", "--smoke", "--batch", "1",
                     "--new-tokens", "2"])
    with pytest.raises(RuntimeError, match="cuda"):
        ttrain.main(["--arch", "whisper-small", "--smoke", "--steps", "1",
                     "--batch", "1"])
    names = {p.relative_to(PORT).as_posix() for p in _port_files()
             if PORT in p.parents}
    assert "models/encdec.py" in names


def test_obs_modules_are_checked_for_imports():
    """The telemetry package is among the files the import check reads."""
    names = {p.relative_to(PORT).as_posix() for p in _port_files()
             if PORT in p.parents}
    assert {f"obs/{m}.py" for m in ("__init__", "trace", "export",
                                    "quality", "probes", "keyed")} <= names


def test_obs_entry_points_without_device_ask_for_cuda(no_cuda):
    from repro_torch.obs.probes import probe_mesh, probe_ring
    from repro_torch.obs.quality import QualityTap
    with pytest.raises(RuntimeError, match="cuda"):
        QualityTap((2, 8))
    with pytest.raises(RuntimeError, match="cuda"):
        probe_ring(2, "data", payload_bytes=16)
    with pytest.raises(RuntimeError, match="cuda"):
        probe_mesh({"data": 2}, payload_bytes=16)
    with pytest.raises(RuntimeError, match="cuda"):
        ttrain.main(["--smoke", "--steps", "1", "--batch", "1",
                     "--metrics", "1"])


def test_stage_ranks_are_checked_and_ask_for_cuda(no_cuda, monkeypatch):
    """``transport/p2p.py`` is among the files the import check reads; a
    stage rank given no device (``StageGroup``, the device its rank step
    runs on, and the launcher's ``--dist-backend``) asks for CUDA and
    raises before any process group is made, rather than running on the
    CPU."""
    import torch.distributed as dist
    from repro_torch.transport.p2p import StageGroup
    names = {p.relative_to(PORT).as_posix() for p in _port_files()
             if PORT in p.parents}
    assert "transport/p2p.py" in names
    with pytest.raises(RuntimeError, match="cuda"):
        D.stage_device(1)
    for backend in ("gloo", "nccl"):
        with pytest.raises(RuntimeError, match="cuda"):
            StageGroup(0, 2, backend)
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="cuda"):
        ttrain.main(["--smoke", "--steps", "1", "--batch", "2",
                     "--transport", "pipeline", "--stages", "2",
                     "--dist-backend", "gloo"])
    assert not dist.is_initialized()


def test_torch_examples_are_checked_for_imports():
    names = {p.name for p in _port_files()}
    assert {f"{n}_torch.py" for n in ("quickstart", "pipeline_stages",
                                      "serve_compressed",
                                      "finetune_index_reuse")} <= names


@pytest.mark.parametrize("path", _examples(), ids=lambda p: p.name)
def test_torch_examples_without_device_ask_for_cuda(no_cuda, monkeypatch,
                                                    path):
    monkeypatch.setattr(sys, "argv", [str(path)])
    with pytest.raises(RuntimeError, match="cuda"):
        runpy.run_path(str(path), run_name="__main__")


def test_cpu_tensors_take_the_plain_path():
    assert not D.use_kernel(torch.zeros(2))
