"""`correct` comes out false where it must: for the control (the reference
in the program's place at the precision below the configuration's) and
for each fault the cells can have, planted in the program underneath a
run that skips only the harness's look for a card. Tiny cells on the CPU,
in float32 where a sound run must pass (the limits are set for the cells'
own sizes); the control at a cell's own size needs the card."""

import json
import subprocess
import sys

import pytest

from benchmark import control
from benchmark.tests import tiny
from benchmark.yardstick import checks

RUN = """
import json, sys
from benchmark import control, run
from benchmark.tests import tiny
name, fault, dtype = sys.argv[1], sys.argv[2], sys.argv[3]
if fault != "none":
    control.plant(fault)
ctx = tiny.context(name, compute_dtype=None if dtype == "none" else dtype)
bench = tiny.harness.load_json(tiny.ROOT + "/BENCHMARK.json")
sys.exit(run.execute(ctx, bench))
"""


def _correct(name, fault, dtype="float32"):
    out = subprocess.run([sys.executable, "-c", RUN, name, fault, dtype],
                         capture_output=True, text=True, env=tiny.env(),
                         cwd=tiny.ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])["correct"]


@pytest.mark.parametrize("name,fault,want", [
    ("train.r2plus1d_18.bs64", "none", True),
    ("train.r2plus1d_18.bs64", "frozen", False),
    ("train.r2plus1d_18.bs64", "half", False),
    ("serve.r2plus1d_18.poisson", "none", True),
    ("serve.r2plus1d_18.poisson", "altered", False),
])
def test_a_planted_fault_is_not_correct(name, fault, want):
    assert _correct(name, fault) is want


@pytest.mark.parametrize("mode", ["fault:noexchange", "fault:half"])
def test_data_parallel_faults(mode):
    ctx = tiny.context("train.r2plus1d_18.dp4", compute_dtype="float32",
                       chips=2)
    (row,) = control.dp_rows(ctx, [5], mode)
    ok, _ = checks.judge(row["numbers"], ctx.cell["limits"])
    assert not ok


def test_data_parallel_sound_run_follows_the_reference():
    # at this size Adam's sign-like first steps let later losses part by
    # 1e-3 in float32 too; the first step and the gradients agree
    ctx = tiny.context("train.r2plus1d_18.dp4", compute_dtype="float32",
                       chips=2)
    (row,) = control.dp_rows(ctx, [5], "program")
    prog, ref = row["detail"]["loss"]
    assert abs(prog[0] - ref[0]) <= 1e-5 * ref[0]
    assert row["numbers"]["grad_gap"] < 1e-3


@pytest.mark.parametrize("name", ["train.r2plus1d_18.bs64",
                                  "serve.r2plus1d_18.poisson"])
def test_the_control_is_not_correct(name):
    ctx = tiny.context(name, seed=9)
    numbers = control.one(ctx, "control")["numbers"]
    ok, _ = checks.judge(dict(numbers, unanswered=0), ctx.cell["limits"])
    assert not ok


@pytest.fixture
def card():
    if not tiny.cuda_ok():
        pytest.skip("needs a CUDA device: the control at the cell's size")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["train.r2plus1d_18.bs64",
                                  "train.c3d.bs64"])
def test_the_control_fails_at_the_cells_size(card, name):
    from benchmark import harness

    _, _, cell, config = harness.find_cell(tiny.ROOT, name)
    ctx = harness.Context(root=tiny.ROOT, name=name, seed=11, seconds=1,
                          trace=False, cell=cell, config=config, chips=1,
                          t_start=0.0)
    numbers = control.one(ctx, "control")["numbers"]
    ok, _ = checks.judge(numbers, cell["limits"])
    assert not ok
