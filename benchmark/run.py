#!/usr/bin/env python3
"""The port's benchmark: one run of one cell.

  python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
      --trace <0|1>

The cell is an entry of BENCHMARK.json's `workloads`; its file
benchmark/workloads/<cell>.json names its driver (benchmark/drivers/), its
traffic and its limits; its configuration file names the network
(benchmark/networks/<network>.py) and holds its sizes. The run makes its
weights and inputs from --seed, warms up every shape it uses (set-up),
measures for --seconds, and then holds what the timed path produced
against the plain reference (benchmark/reference/).

The last line of standard output is one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics; with
--trace 1 its per-layer metrics, read by benchmark/metrics/<name>.py from
the trace of the window and the benchmark's spans), `device`, with --trace
1 `breakdown`, and last `checks`: each number compared beside its limit,
which are also the last lines of standard error.

Without a CUDA device, or with fewer than the cell asks for, the run exits
with code 3 and prints no result; so it does where the measured package
cannot be imported, or where a JAX module was loaded.
"""

from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", required=True, type=int)
    p.add_argument("--seconds", required=True, type=int)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def execute(ctx, bench) -> int:
    """Run the cell's driver and print the result. -> exit code."""
    import collections
    import json

    import torch

    from benchmark import harness
    from benchmark.yardstick import checks

    out = harness.load_driver(ctx.cell["driver"]).run(ctx)
    for line in out.get("notes", []):
        harness.say(line)
    metrics = {}
    if ctx.trace:
        for m in harness.metrics_for(bench, "per_layer", ctx.name):
            value = harness.load_reader(ctx.root, m["name"])(out["record"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in harness.metrics_for(bench, "end_to_end", ctx.name):
            metrics[m["name"]] = {"value": out["e2e"][m["name"]],
                                  "unit": m["unit"]}
    cuda = ctx.device.startswith("cuda")
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
              "count": ctx.chips,
              "memory_peak_bytes": out["memory_peak_bytes"]}
    trace = out.get("trace")
    breakdown = None
    if ctx.trace and trace is not None:
        top = collections.Counter()
        for a, b, name in trace.device:
            top[name[:80]] += (b - a) / 1e9
        for name, sec in top.most_common(12):
            harness.say(f"device op {sec:.4f} s: {name}")
        device["busy_s"] = trace.busy_s()
        device["window_s"] = trace.window_s
        breakdown = trace.breakdown()
    correct, compared = checks.judge(out["numbers"], ctx.cell["limits"])
    found = harness.forbidden_modules() + list(out.get("forbidden", []))
    if found:
        harness.say(f"loaded modules that the benchmark forbids: {found}")
        return 5
    for name, value in out["numbers"].items():
        if name not in compared:
            harness.say(f"reading {name}: {value!r} (not compared)")
    for name, c in compared.items():
        harness.say(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    harness.say("correct: " + json.dumps(correct))
    print(harness.result_line(correct, out["attempted"], out["failed"],
                              metrics, device, compared, breakdown),
          flush=True)
    return 0


def main(argv=None) -> int:
    from benchmark import harness

    t_start = harness.process_start_time()
    args = parse(argv)
    try:
        bench, entry, cell, config = harness.find_cell(ROOT, args.workload)
    except (OSError, ValueError, KeyError, StopIteration) as e:
        harness.say(f"cell {args.workload!r}: {e}")
        return 2
    # the program's caches inside the checkout, at fixed paths
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ.setdefault(var, os.path.join(ROOT, "build", "portbench",
                                                sub))
    import torch

    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < entry["chips"]):
        harness.say(f"{args.workload} needs {entry['chips']} CUDA "
                    f"device(s); this machine shows "
                    f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    import importlib.util

    if importlib.util.find_spec(harness.PROGRAM) is None:
        harness.say(f"the measured package {harness.PROGRAM} is not here")
        return 4
    harness.say(f"card: {harness.card()}; torch {torch.__version__}, "
                f"CUDA {torch.version.cuda}")
    ctx = harness.Context(root=ROOT, name=args.workload, seed=args.seed,
                          seconds=args.seconds, trace=bool(args.trace),
                          cell=cell, config=config, chips=entry["chips"],
                          t_start=t_start)
    return execute(ctx, bench)


if __name__ == "__main__":
    sys.exit(main())
