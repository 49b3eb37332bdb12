#!/usr/bin/env python3
"""A benchmark cell's device idle time, split by the program's own spans.

    python3 tools/idle_by_span.py --workload <cell> --seed <n> \
        [--seconds 30] [--json PATH]

Runs one traced run of a train cell of the benchmark (benchmark/run.py
--trace 1, whose result line it prints as that run does), then takes the
gaps of the traced window in which no operation ran on the device and puts
each down to the innermost of the port's spans (utils/profiler.py) open on
the host at its middle, on any thread, and to the innermost `train.*` or
`feed*` span (the step's phase), else "other". In the data-parallel cell
the same is done inside process 0, from its own trace and registry.

Prints one JSON line: seconds of idle by innermost span and by phase, the
window, the steps, and each span's host ms a step in the window; writes it
to --json. Needs the card, as the benchmark does.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import os
import pickle
import shutil
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def _innermost(spans, times):
    """For each of the increasing `times`, the name of the shortest span of
    `spans` ((start_ns, end_ns, name), any order) around it, else
    "other"."""
    spans = sorted(spans)
    out, active, i = [], [], 0
    for t in times:
        while i < len(spans) and spans[i][0] <= t:
            active.append(spans[i])
            i += 1
        active = [s for s in active if s[1] >= t]
        best = min(active, key=lambda s: s[1] - s[0], default=None)
        out.append(best[2] if best else "other")
    return out


def split(trace, steps: int) -> dict:
    """The window's idle seconds by innermost program span and by phase."""
    from zeroshotvideoclassification_tpu_torch.utils import profiler

    reg = profiler.registry()
    spans, host = [], collections.Counter()
    for name in reg.totals():
        for i in reg.instances(name):
            if trace.start_ns <= i.start_ns and i.end_ns <= trace.end_ns:
                spans.append((i.start_ns, i.end_ns, name))
                host[name] += (i.end_ns - i.start_ns) / 1e6
    phases = [s for s in spans if s[2].startswith(("train.", "feed"))]
    gaps = trace.gaps()
    mids = [(a + b) // 2 for a, b in gaps]
    out = {"window_s": trace.window_s, "steps": steps,
           "idle_s": sum(b - a for a, b in gaps) / 1e9}
    for key, among in (("idle_by_span", spans), ("idle_by_phase", phases)):
        c = collections.Counter()
        for (a, b), label in zip(gaps, _innermost(among, mids)):
            c[label] += (b - a) / 1e9
        out[key] = dict(c.most_common())
    out["host_ms_a_step"] = {k: v / max(steps, 1)
                             for k, v in host.most_common()}
    return out


def rank_main(ctx, out_path: str) -> None:
    """benchmark/drivers/train_dp.rank_main, with process 0's split."""
    import torch.distributed as dist

    from benchmark.drivers import train

    rank, world = dist.get_rank(), dist.get_world_size()
    if ctx.device == "cuda":
        ctx = dataclasses.replace(ctx, device=f"cuda:{rank}")
    stop = dist.new_group(backend="gloo")
    out = train.process(ctx, rank, world, stop_group=stop)
    if rank == 0:
        result = split(out["trace"], out["attempted"])
        result["train_clips_per_s"] = out["e2e"]["train_clips_per_s"]
        with open(out_path, "wb") as f:
            pickle.dump(result, f)


def run_dp(ctx) -> dict:
    from benchmark.drivers.train_dp import _free_port
    from zeroshotvideoclassification_tpu_torch.parallel.multihost import (
        run_local_ranks,
    )

    tmp = tempfile.mkdtemp(prefix="idle_by_span_")
    try:
        path = os.path.join(tmp, "rank0.pkl")
        run_local_ranks(rank_main, (ctx, path), ctx.chips,
                        f"tcp://localhost:{_free_port()}",
                        device_type="cuda" if ctx.device == "cuda" else "cpu")
        with open(path, "rb") as f:
            return pickle.load(f)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def measure(ctx, bench):
    """The cell's traced run (its result line printed) and the split; None
    where the run failed."""
    from benchmark import harness, run

    if ctx.cell["driver"] == "train_dp":
        return run_dp(ctx)
    seen = {}
    load = harness.load_driver

    class Keep:
        @staticmethod
        def run(c):
            seen["out"] = load(ctx.cell["driver"]).run(c)
            return seen["out"]

    harness.load_driver = lambda name: Keep
    try:
        if run.execute(ctx, bench) != 0:
            return None
    finally:
        harness.load_driver = load
    return split(seen["out"]["trace"], seen["out"]["attempted"])


def main(argv=None) -> int:
    from benchmark import harness

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=int, default=30)
    p.add_argument("--json", default="")
    args = p.parse_args(argv)
    t_start = harness.process_start_time()
    bench, entry, cell, config = harness.find_cell(ROOT, args.workload)
    ctx = harness.Context(root=ROOT, name=args.workload, seed=args.seed,
                          seconds=args.seconds, trace=True, cell=cell,
                          config=config, chips=entry["chips"],
                          t_start=t_start)
    harness.say(f"card: {harness.card()}")
    result = measure(ctx, bench)
    if result is None:
        return 1
    result["workload"], result["seed"] = args.workload, args.seed
    line = json.dumps(result)
    print(line, flush=True)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
