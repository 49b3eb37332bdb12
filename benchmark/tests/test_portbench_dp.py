"""The data-parallel cell: each process its own block of the host's cores
and as many intra-op threads as the block holds; its rate and per-layer
metrics under their own names, as BENCHMARK.json lists them for it."""

import json
import os
import subprocess
import sys

import pytest

from benchmark import harness, run
from benchmark.drivers.train_dp import _core_block
from benchmark.tests import tiny

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


@pytest.mark.parametrize("n_cores, world, per", [(32, 4, 8), (10, 4, 2),
                                                 (8, 2, 4), (7, 1, 7)])
def test_blocks_are_disjoint_and_even(n_cores, world, per):
    cores = list(range(100, 100 + n_cores))
    blocks = [_core_block(cores, r, world) for r in range(world)]
    assert all(len(b) == per for b in blocks)
    assert all(b == sorted(b) and b[-1] - b[0] == per - 1 for b in blocks)
    flat = [c for b in blocks for c in b]
    assert len(set(flat)) == len(flat) == per * world


def test_fewer_cores_than_processes_share_them_all():
    assert [_core_block([3, 5], r, 4) for r in range(4)] == [[3, 5]] * 4


def test_bind_moves_every_thread_and_the_pool():
    cores = sorted(os.sched_getaffinity(0))
    if len(cores) < 2:
        pytest.skip("one core: nothing to split")
    code = (
        "import json, os, threading, time, torch\n"
        "from benchmark.drivers.train_dp import _bind\n"
        "ev = threading.Event()\n"
        "t = threading.Thread(target=ev.wait); t.start()\n"
        "_bind(1, 2)\n"
        "late = threading.Thread(target=ev.wait); late.start()\n"
        "tids = os.listdir('/proc/self/task')\n"
        "out = {'threads': torch.get_num_threads(), 'sets': sorted({\n"
        "    tuple(sorted(os.sched_getaffinity(int(x)))) for x in tids})}\n"
        "ev.set(); t.join(); late.join()\n"
        "print(json.dumps(out))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    want = _core_block(cores, 1, 2)
    assert out["threads"] == len(want)
    assert out["sets"] == [want]


def _line(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_the_cell_reports_its_own_metrics(capsys):
    name = "train.r2plus1d_18.dp4"
    bench = harness.load_json(os.path.join(tiny.ROOT, "BENCHMARK.json"))
    ctx = tiny.context(name, compute_dtype="float32", chips=2)
    assert run.execute(ctx, bench) == 0
    line = _line(capsys)
    # at this size Adam's sign-like first steps part the later losses
    # (test_portbench_control), so `correct` is not asked here
    assert list(line)[-1] == "checks"
    assert set(line["metrics"]) == {
        m["name"] for m in harness.metrics_for(bench, "end_to_end", name)}
    assert "train_clips_per_s.dp" in line["metrics"]
    assert line["metrics"]["train_clips_per_s.dp"]["value"] > 0

    ctx.trace = True
    assert run.execute(ctx, bench) == 0
    line = _line(capsys)
    per_layer = {m["name"] for m in harness.metrics_for(bench, "per_layer",
                                                         name)}
    assert set(line["metrics"]) <= per_layer
    assert {"step_mfu.dp", "feed_ms.dp"} <= set(line["metrics"])
    assert line["metrics"]["step_mfu.dp"]["value"] > 0


def test_each_per_layer_metric_moves_a_metric_of_its_cells():
    bench = harness.load_json(os.path.join(tiny.ROOT, "BENCHMARK.json"))
    for m in bench["per_layer"]:
        for cell in m["workloads"]:
            names = {e["name"] for e in harness.metrics_for(
                bench, "end_to_end", cell)}
            assert m["moves"] in names, (m["name"], cell)
