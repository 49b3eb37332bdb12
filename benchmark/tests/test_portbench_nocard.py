"""Without a card the benchmark fails and prints no result: it never falls
back to the CPU; nor does it run where only its own files are. A rehearsed
run (on the CPU, through the drivers) loads no module whose top-level name
is JAX's, its libraries' or the JAX package's."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark.tests import tiny

CELLS = [w["name"] for w in tiny.harness.load_json(
    os.path.join(tiny.ROOT, "BENCHMARK.json"))["workloads"]]


def _run(cwd, cell, extra_env=None):
    env = dict(os.environ, **(extra_env or {}))
    env.pop("PYTHONPATH", None)
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         str(2 ** 31 + 5), "--seconds", "1", "--trace", "0"],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("cell", CELLS)
def test_no_card_no_result(cell):
    if tiny.cuda_ok():
        pytest.skip("this machine has a card")
    out = _run(tiny.ROOT, cell, {"CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode == 3, out.stderr
    assert out.stdout == ""
    assert "CUDA" in out.stderr


def test_only_the_benchmark_files_no_result(tmp_path):
    shutil.copy(os.path.join(tiny.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(tiny.ROOT, "benchmark"),
                    tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(str(tmp_path), CELLS[0])
    assert out.returncode != 0 and out.stdout == ""


def test_unknown_cell_no_result():
    out = _run(tiny.ROOT, "no.such.cell")
    assert out.returncode == 2 and out.stdout == ""


REHEARSE = """
import json, sys
from benchmark import harness, run
from benchmark.tests import tiny
bench = harness.load_json(tiny.ROOT + "/BENCHMARK.json")
for name in sys.argv[1:]:
    assert run.execute(tiny.context(name, trace=True), bench) == 0
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def test_a_rehearsed_run_loads_no_jax():
    out = subprocess.run(
        [sys.executable, "-c", REHEARSE, "train.r2plus1d_18.bs64",
         "serve.r2plus1d_18.poisson"], capture_output=True, text=True,
        env=tiny.env(), cwd=tiny.ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "zeroshotvideoclassification_tpu_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax",
                         "zeroshotvideoclassification_tpu"}
