"""What every cell shares: finding a cell, its configuration, its driver,
its network and the per-layer metrics' readers by name, the set-up clock,
the card's identity, the check that no JAX module was loaded, and the
result line.

Everything of one configuration, cell, network or per-layer metric lives in
files of its own: benchmark/configs/<config>.json,
benchmark/workloads/<cell>.json (its driver by name, its traffic and its
limits), benchmark/networks/<network>.py (the network's description, its
plain reference forward and its tiny CPU sizes) and
benchmark/metrics/<metric>.py (a `read(record)` that returns a number or
None). A later cell, configuration, network or metric is new files and new
entries in BENCHMARK.json.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time
from typing import Any, Dict, Optional

PKG = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PKG)
PROGRAM = "zeroshotvideoclassification_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "zeroshotvideoclassification_tpu")


def process_start_time() -> float:
    """The wall-clock time this process started (from /proc), else now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


@dataclasses.dataclass
class Context:
    """One run of one cell."""

    root: str
    name: str
    seed: int
    seconds: int
    trace: bool
    cell: Dict[str, Any]      # benchmark/workloads/<cell>.json
    config: Dict[str, Any]    # benchmark/configs/<config>.json
    chips: int
    t_start: float            # the process's start, wall clock
    device: str = "cuda"


def load_json(path: str) -> Any:
    with open(path) as f:
        return json.load(f)


def find_cell(root: str, name: str):
    """-> (BENCHMARK.json, its workload entry, the cell file, the config
    file); ValueError where they do not agree."""
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise ValueError(f"no workload {name!r} in BENCHMARK.json")
    cell = load_json(os.path.join(root, "benchmark", "workloads",
                                  name + ".json"))
    for key in ("config", "traffic", "chips"):
        if cell[key] != entry[key]:
            raise ValueError(f"{name}: {key} {cell[key]!r} in its file, "
                             f"{entry[key]!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = load_json(os.path.join(root, conf["file"]))
    return bench, entry, cell, config


def metrics_for(bench: dict, kind: str, cell: str):
    """The `kind` ("end_to_end" or "per_layer") metrics reported in
    `cell`."""
    return [m for m in bench[kind]
            if "workloads" not in m or cell in m["workloads"]]


def _load_file(root: str, kind: str, name: str):
    """The module of benchmark/<kind>/<name>.py under `root`."""
    path = os.path.join(root, "benchmark", kind, name + ".py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {kind[:-1]} {name!r}: {path} is missing")
    spec = importlib.util.spec_from_file_location(
        f"benchmark.{kind}." + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_reader(root: str, name: str):
    """benchmark/metrics/<name>.py's read(record)."""
    return _load_file(root, "metrics", name).read


def load_network(root: str, name: str):
    """benchmark/networks/<name>.py: its describe(clip_len, size), its
    embed(net, params, clips, n_clips, quant, state) and its TINY sizes."""
    return _load_file(root, "networks", name)


def load_driver(name: str):
    return importlib.import_module(f"benchmark.drivers.{name}")


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's, its libraries' or the
    JAX package's (compared whole: the port's name begins with the JAX
    package's)."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return "; ".join(sorted(set(out.stdout.strip().splitlines())))
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def say(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def result_line(correct: bool, attempted: int, failed: int,
                metrics: Dict[str, dict], device: dict,
                checks: Dict[str, dict],
                breakdown: Optional[dict] = None) -> str:
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return json.dumps(out)
