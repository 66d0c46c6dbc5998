"""The four torch examples (``examples/*_torch.py``) run with ``--device
cpu`` at their own sizes, as four concurrent subprocesses of one intra-op
thread each, and print the reference examples' lines:

  * ``pipeline_stages_torch.py`` prints, for each scheme, the bytes per
    boundary and the ratio to bf16 that the reference's
    ``pack_payload`` / ``wire_bytes`` give for the same (2, 256) f32
    microbatch, and the reference schedules' ``describe(8, 4)`` dicts,
    exactly (the reference example itself forces 4 host devices through
    ``jax.make_mesh``, whose Explicit axes its shard_map refuses in this
    jax, so its lines are rebuilt from the reference's functions);
  * each example's closing lines are the reference's.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import pytest

from repro.transport import get_schedule, pack_payload, wire_bytes

ROOT = Path(__file__).resolve().parents[1]
# each reference example's closing line
LAST = {
    "quickstart": "-> the compressed-inference loss should be the lower "
                  "one (finding F3)",
    "pipeline_stages": "-> interleaved shrinks the fill bubble by 1/v and "
                       "multiplies the compressed cuts — the regime where "
                       "the codecs pay off",
    "serve_compressed": "paged and speculative outputs are bit-identical: "
                        "True",
    "finetune_index_reuse": "-> separate masks (reuse=False) should be "
                            "worse (finding F6); the full-scale version is "
                            "benchmarks table5",
}
EXAMPLES = tuple(LAST)


@pytest.fixture(scope="module")
def outputs():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
               MKL_NUM_THREADS="1")
    procs = {n: subprocess.Popen(
        [sys.executable, str(ROOT / "examples" / f"{n}_torch.py"),
         "--device", "cpu"], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for n in EXAMPLES}
    out = {}
    for n, p in procs.items():
        stdout, stderr = p.communicate(timeout=600)
        out[n] = (p.returncode, stdout, stderr)
    return out


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_runs_on_the_cpu(outputs, name):
    rc, stdout, stderr = outputs[name]
    assert rc == 0, stderr[-3000:]
    assert stdout.strip().splitlines()[-1] == LAST[name]


def test_pipeline_stages_prints_the_reference_lines(outputs):
    rc, stdout, _ = outputs["pipeline_stages"]
    assert rc == 0
    lines = stdout.splitlines()
    x = jnp.zeros((2, 256), jnp.float32)
    for scheme in ("none", "q8", "q4", "topk"):
        mb = wire_bytes(pack_payload(x, scheme, 0.1))
        want = (f"  {scheme:5s}: bytes/boundary {mb:7d} "
                f"({x.size * 2 / mb:4.1f}x vs bf16)  rel-err vs sequential ")
        assert sum(l.startswith(want) for l in lines) == 1, want
    for tag, sched in (("1f1b       ", get_schedule("1f1b")),
                       ("interleaved", get_schedule("interleaved", 2))):
        want = f"  {tag}: {sched.describe(8, 4)}  rel-err "
        assert sum(l.startswith(want) for l in lines) == 1, want
    assert "schedules (mb=8 microbatches on 4 stages):" in lines
