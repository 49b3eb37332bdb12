"""A cell, a configuration and a per-layer metric are added by new files
and new BENCHMARK.json entries alone: the harness finds them by name."""

import json
import os
import re
import shutil
import time

import pytest

from benchmark import harness, run
from benchmark.tests import tiny

NEW_METRIC = '''
def read(record):
    """Steps of the window (a test metric)."""
    return float(record.steps) if record.steps else None
'''


def _tiny_root(tmp_path, network="r2plus1d_18", name="tiny3d",
               ignore=(), new_metric=True, per_layer=()):
    """A copied checkout with a tiny float32 configuration `name` of
    `network`, its cell train.<name>.bs2 and, with `new_metric`, the metric
    steps.tiny; the cell also in the workloads of the metrics named in
    `per_layer`. `ignore`: files of the benchmark left out of the copy."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(tiny.ROOT, "benchmark"),
                    root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", *ignore))
    bench = harness.load_json(os.path.join(tiny.ROOT, "BENCHMARK.json"))
    config = dict(harness.load_json(os.path.join(
        tiny.ROOT, "benchmark", "configs", "r2plus1d_18-mlp.json")),
        name=name, network=network, clip_len=4, size=32,
        compute_dtype="float32")
    (root / "benchmark" / "configs" / f"{name}.json").write_text(
        json.dumps(config))
    cell = tiny.context("train.r2plus1d_18.bs64").cell
    cell.update(name=f"train.{name}.bs2", config=name, traffic="bs2",
                chips=1)
    (root / "benchmark" / "workloads" / f"{cell['name']}.json").write_text(
        json.dumps(cell))
    bench["configs"].append({"name": name, "source": "test",
                             "file": f"benchmark/configs/{name}.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({k: cell[k] for k in (
        "name", "config", "traffic", "chips", "why")})
    if new_metric:
        (root / "benchmark" / "metrics" / "steps.tiny.py").write_text(
            NEW_METRIC)
        bench["per_layer"].append({
            "name": "steps.tiny", "unit": "steps", "better": "higher",
            "source": "program_counter", "layer": "train step",
            "moves": "train_clips_per_s", "workloads": [cell["name"]]})
    for m in bench["end_to_end"]:
        if "workloads" in m and "train.r2plus1d_18.bs64" in m["workloads"]:
            m["workloads"].append(cell["name"])
    for m in bench["per_layer"]:
        if m["name"] in per_layer:
            m["workloads"].append(cell["name"])
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


def test_a_new_network_is_one_new_file(tmp_path, capsys):
    # MC3-18 with the MLP head: a cell of a network the copy has no file of
    root = _tiny_root(tmp_path, network="mc3_18", name="tinymc3",
                      ignore=("mc3_18.py",), new_metric=False,
                      per_layer=("step_mfu.train",))
    bench, entry, cell, config = harness.find_cell(root, "train.tinymc3.bs2")
    assert config["network"] == "mc3_18" and config["head"] == "mlp"
    ctx = harness.Context(root=root, name=cell["name"], seed=7, seconds=1,
                          trace=False, cell=cell, config=config, chips=1,
                          t_start=time.time(), device="cpu")
    with pytest.raises(FileNotFoundError, match=re.escape(os.path.join(
            "benchmark", "networks", "mc3_18.py"))):
        run.execute(ctx, bench)

    shutil.copy(os.path.join(tiny.ROOT, "benchmark", "networks",
                             "mc3_18.py"),
                os.path.join(root, "benchmark", "networks"))
    assert run.execute(ctx, bench) == 0
    line = _line(capsys)
    assert line["correct"] is True and line["attempted"] > 0
    assert set(line["metrics"]) == {"train_clips_per_s", "peak_mem_gib",
                                    "setup_s"}

    ctx.trace = True
    assert run.execute(ctx, bench) == 0
    line = _line(capsys)
    assert line["correct"] is True
    assert line["metrics"]["step_mfu.train"]["value"] > 0
