"""A cell, a configuration and a per-layer metric are added by new files
and new BENCHMARK.json entries alone: the harness finds them by name."""

import json
import os
import shutil

from benchmark import harness, run
from benchmark.tests import tiny

NEW_METRIC = '''
def read(record):
    """Steps of the window (a test metric)."""
    return float(record.steps) if record.steps else None
'''


def _tiny_root(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(tiny.ROOT, "benchmark"),
                    root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = harness.load_json(os.path.join(tiny.ROOT, "BENCHMARK.json"))
    config = dict(harness.load_json(os.path.join(
        tiny.ROOT, "benchmark", "configs", "r2plus1d_18-mlp.json")),
        name="tiny3d", clip_len=4, size=32, compute_dtype="float32")
    (root / "benchmark" / "configs" / "tiny3d.json").write_text(
        json.dumps(config))
    cell = tiny.context("train.r2plus1d_18.bs64").cell
    cell.update(name="train.tiny3d.bs2", config="tiny3d", traffic="bs2",
                chips=1)
    (root / "benchmark" / "workloads" / "train.tiny3d.bs2.json").write_text(
        json.dumps(cell))
    (root / "benchmark" / "metrics" / "steps.tiny.py").write_text(NEW_METRIC)
    bench["configs"].append({"name": "tiny3d", "source": "test",
                             "file": "benchmark/configs/tiny3d.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({k: cell[k] for k in (
        "name", "config", "traffic", "chips", "why")})
    bench["per_layer"].append({
        "name": "steps.tiny", "unit": "steps", "better": "higher",
        "source": "program_counter", "layer": "train step",
        "moves": "train_clips_per_s", "workloads": ["train.tiny3d.bs2"]})
    for m in bench["end_to_end"]:
        if "workloads" in m and "train.r2plus1d_18.bs64" in m["workloads"]:
            m["workloads"].append("train.tiny3d.bs2")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return str(root)


def _line(capsys):
    out = capsys.readouterr().out.strip().splitlines()
    return json.loads(out[-1])


def test_added_files_make_a_cell_a_config_and_a_metric(tmp_path, capsys):
    root = _tiny_root(tmp_path)
    bench, entry, cell, config = harness.find_cell(root, "train.tiny3d.bs2")
    assert config["name"] == "tiny3d" and cell["driver"] == "train"
    names = [m["name"] for m in harness.metrics_for(bench, "per_layer",
                                                    "train.tiny3d.bs2")]
    assert "steps.tiny" in names and "nccl_ms.dp" not in names

    ctx = tiny.context("train.tiny3d.bs2", root=root, trace=True)
    ctx.config, ctx.cell = config, cell
    cell["traffic_params"].update(tiny.context(
        "train.r2plus1d_18.bs64").cell["traffic_params"])
    assert run.execute(ctx, bench) == 0
    line = _line(capsys)
    assert line["correct"] is True
    assert line["metrics"]["steps.tiny"]["value"] == line["attempted"]

    ctx.trace = False
    assert run.execute(ctx, bench) == 0
    line = _line(capsys)
    assert set(line["metrics"]) == {"train_clips_per_s", "peak_mem_gib",
                                    "setup_s"}
    assert list(line)[-1] == "checks"


def test_cells_and_files_agree():
    bench = harness.load_json(os.path.join(tiny.ROOT, "BENCHMARK.json"))
    for w in bench["workloads"]:
        harness.find_cell(tiny.ROOT, w["name"])  # raises where they differ
    for m in bench["per_layer"]:
        assert callable(harness.load_reader(tiny.ROOT, m["name"]))
