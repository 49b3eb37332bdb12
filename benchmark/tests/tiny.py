"""Tiny versions of the benchmark's cells, for CPU tests: the cells' own
files with small clips, batches and videos, run on the CPU through the
same drivers (the port's plain CPU paths stand in for its kernels)."""

from __future__ import annotations

import copy
import os
import time

from benchmark import harness

ROOT = harness.ROOT


def find(root: str, name: str):
    """(chips, cell, config) of a cell of BENCHMARK.json, or of a cell file
    that it does not list (the serve cell, which waits for a later
    benchmark PR)."""
    try:
        _, entry, cell, config = harness.find_cell(root, name)
        return entry["chips"], cell, config
    except ValueError:
        cell = harness.load_json(os.path.join(root, "benchmark", "workloads",
                                              name + ".json"))
        config = harness.load_json(os.path.join(
            root, "benchmark", "configs", cell["config"] + ".json"))
        return cell["chips"], cell, config


def context(name: str, seed: int = 7, seconds: int = 1, trace=False,
            compute_dtype=None, chips=None, root=ROOT) -> harness.Context:
    n_chips, cell, config = find(root, name)
    config, cell = dict(config), copy.deepcopy(cell)
    config.update(harness.load_network(root, config["network"]).TINY)
    if compute_dtype:
        config["compute_dtype"] = compute_dtype
    tp = cell["traffic_params"]
    if "batch" in tp:
        tp.update(batch=2, pool=4, canvas_hw=[64, 86],
                  source_hw=[[60, 80], [64, 86]], short_side=32)
    else:
        tp.update(videos=6, frames=[20, 40], frame_hw=[48, 64], rate=4.0,
                  max_batch=8, sample=3, warm_requests=2,
                  calibration_clips=2, n_clips=2, client_threads=16)
    return harness.Context(root=root, name=name, seed=seed, seconds=seconds,
                           trace=trace, cell=cell, config=config,
                           chips=chips or min(n_chips, 2),
                           t_start=time.time(), device="cpu")


def cuda_ok() -> bool:
    import torch

    return torch.cuda.is_available()


def env() -> dict:
    """The environment of a subprocess that imports the benchmark."""
    return dict(os.environ, PYTHONPATH=ROOT)
