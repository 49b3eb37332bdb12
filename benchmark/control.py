#!/usr/bin/env python3
"""Readings that set a cell's limits, on the chip at the cell's own size.

  python3 benchmark/control.py --workload <cell> --seeds 1 2 3 \
      --mode program|control|fault:<name> [--seconds 1]

  program     the cell's driver (program and reference) on each seed, with
              a short window, in one process: the lower readings;
  control     the plain reference in the program's place, computed in the
              nearest precision below the configuration's (fp8 for bf16),
              against the float32 reference: the control's readings
              (control:int8, the serve cell's int8 instead);
  sweep       the serve cell's set-up once, then one window at each of
              --rates (videos a second): the knee;
  fault:NAME  the driver with the program broken underneath (PLANTS): a
              step that leaves the state unchanged (frozen), half the batch
              left out with the mean over the rest (half), the gradients'
              exchange between cards left out (noexchange), every answer
              altered where the engine ranks it (altered).

Prints one JSON line a seed, {"seed", "mode", "numbers"}, and the same
list at the end. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def plant(name: str) -> None:
    """Break the program underneath, in this process."""
    import numpy as np

    from zeroshotvideoclassification_tpu_torch.serve import engine
    from zeroshotvideoclassification_tpu_torch.train import optimizer, step

    if name == "frozen":
        optimizer.GuardedAdam.step = lambda self, closure=None: None
    elif name == "half":
        full = step.masked_mse

        def half(emb, z, weight):
            h = emb.shape[0] // 2
            return full(emb[:h], z[:h], weight[:h])

        step.masked_mse = half
    elif name == "noexchange":
        step.sum_gradients = lambda params: None
    elif name == "altered":
        ranked = engine.rank_results

        def altered(paths, dist, ok, names, k):
            return ranked(paths, np.roll(dist, 1, axis=1), ok, names, k)

        engine.rank_results = altered
    else:
        raise ValueError(f"no fault {name!r}")


def control_train(ctx, rank=0, world=1):
    """fp8 reference against the float32 reference on the checked steps."""
    import torch

    from benchmark.reference.models import Net
    from benchmark.reference.precision import fp8
    from benchmark.reference.train import follow
    from benchmark.yardstick import checks, traffic, weights

    cfg, tr = ctx.config, ctx.cell["traffic_params"]
    device = torch.device(ctx.device)
    net = Net(cfg["network"], cfg["clip_len"], cfg["size"], ctx.root)
    params = weights.make(net, ctx.seed, device)
    pool = traffic.train_pool(cfg, tr, ctx.seed, device, rank)[
        :tr["checked_steps"]]
    rate = cfg.get("dropout", 0.0)
    dseed = weights.subseed(ctx.seed, f"dropout.{rank}")
    runs = []
    for quant in (lambda t: t, fp8):
        runs.append(follow(
            net, params, pool, cfg["n_clips"], cfg["clip_len"], tr["lr"],
            device, quant=quant, synced=world > 1,
            dropout=(rate, torch.Generator(device).manual_seed(dseed))
            if rate else None))
    return checks.train_numbers(runs[1], runs[0]), {
        "program": runs[1], "reference": runs[0]}


def detail(readings) -> dict:
    """The look behind a train cell's numbers: each step's loss on both
    sides, the widest leaves and the median leaf's gap."""
    from benchmark.yardstick import checks

    prog, ref = readings["program"], readings["reference"]
    out = {"loss": [prog["loss"], ref["loss"]]}
    for key in ("grad", "delta"):
        gaps = checks.leaf_gaps(prog, ref, key)
        out[key] = {"widest": [[round(g, 5), k, p, r]
                               for g, k, p, r in gaps[:5]],
                    "median_leaf_gap": gaps[len(gaps) // 2][0],
                    "over_0.1": sum(g > 0.1 for g, *_ in gaps)}
    return out


def control_serve(ctx, below: str = "fp8"):
    """Reference scores at the precision `below` (fp8 or int8) against
    float32 ones on a seeded sample of the cell's videos (the longest among
    them)."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from benchmark.reference import serve as reference
    from benchmark.reference.models import Net
    from benchmark.reference import precision
    from benchmark.yardstick import checks, traffic, videos, weights

    cfg, tr = ctx.config, ctx.cell["traffic_params"]
    device = torch.device(ctx.device)
    net = Net(cfg["network"], cfg["clip_len"], cfg["size"], ctx.root)
    params = weights.make(net, ctx.seed, device)
    weights.calibrate(net, params, ctx.seed, tr["calibration_clips"], device)
    embed = traffic.class_embeddings(tr["classes"], ctx.seed)
    root = tempfile.mkdtemp(prefix="portbench_control_")
    try:
        paths, frames, _ = videos.make(root, tr["videos"], tr["frames"],
                                       tr["frame_hw"], tr["jpeg_quality"],
                                       ctx.seed, os.cpu_count() or 1)
        rng = np.random.default_rng(weights.subseed(ctx.seed, "sample"))
        pick = set(rng.choice(len(paths), min(tr["sample"], len(paths)),
                              replace=False).tolist())
        pick.add(int(np.argmax(frames)))
        chosen = [paths[i] for i in sorted(pick)]
        ref = reference.similarities(net, params, chosen, embed,
                                     tr["n_clips"], device)
        low = reference.similarities(net, params, chosen, embed,
                                     tr["n_clips"], device,
                                     quant=getattr(precision, below))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    k = 5
    served = [[(int(c), float(s[c])) for c in np.argsort(-s)[:k]]
              for s in low]
    return checks.serve_numbers(served, ref)


def _dp_rank(ctx, seeds, mode, out_path):
    """One process of the data-parallel cell: every seed of `mode` in this
    one group; process 0 writes the rows."""
    import torch.distributed as dist

    from benchmark.drivers import train_dp

    rank = dist.get_rank()
    if mode.startswith("fault:"):
        plant(mode.split(":", 1)[1])
    rows = []
    for seed in seeds:
        one_ctx = dataclasses.replace(ctx, seed=seed)
        t0 = time.time()
        if mode == "control":
            if one_ctx.device != "cpu":
                one_ctx = dataclasses.replace(one_ctx, device=f"cuda:{rank}")
            numbers, readings = control_train(one_ctx, rank,
                                              dist.get_world_size())
            row = {"numbers": numbers, "detail": detail(readings)}
        else:
            path = out_path + f".{seed}"
            train_dp.rank_main(one_ctx, path)
            row = None
            if rank == 0:
                import pickle

                with open(path, "rb") as f:
                    out = pickle.load(f)
                row = {"numbers": out["numbers"],
                       "detail": detail(out["readings"])}
        if rank == 0:
            rows.append({"seed": seed, "mode": mode, **row,
                         "seconds": time.time() - t0})
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump(rows, f)


def one(ctx, mode: str) -> dict:
    from benchmark import harness

    driver = ctx.cell["driver"]
    if mode in ("control", "control:int8"):
        if driver == "serve":
            return {"numbers": control_serve(ctx, mode[8:] or "fp8")}
        numbers, readings = control_train(ctx)
        return {"numbers": numbers, "detail": detail(readings)}
    out = harness.load_driver(driver).run(ctx)
    row = {"numbers": out["numbers"]}
    if "readings" in out:
        row["detail"] = detail(out["readings"])
    return row


def dp_rows(ctx, seeds, mode):
    """Every seed of `mode` for the data-parallel cell, in one group of
    processes. -> the rows."""
    import shutil
    import tempfile

    from benchmark.drivers.train_dp import _free_port
    from zeroshotvideoclassification_tpu_torch.parallel.multihost import (
        run_local_ranks,
    )

    tmp = tempfile.mkdtemp(prefix="portbench_control_")
    try:
        out = os.path.join(tmp, "rows.json")
        run_local_ranks(_dp_rank, (ctx, list(seeds), mode, out), ctx.chips,
                        f"tcp://localhost:{_free_port()}",
                        device_type="cpu" if ctx.device == "cpu" else "cuda")
        with open(out) as f:
            return json.load(f)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv=None) -> int:
    from benchmark import harness

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, type=int, nargs="+")
    p.add_argument("--mode", required=True)
    p.add_argument("--seconds", type=int, default=1)
    p.add_argument("--rates", type=float, nargs="*", default=())
    p.add_argument("--compute_dtype", default=None,
                   help="run the program in another compute dtype (a "
                        "witness for a reading, never a limit)")
    args = p.parse_args(argv)
    bench, entry, cell, config = harness.find_cell(ROOT, args.workload)
    if args.compute_dtype:
        config = dict(config, compute_dtype=args.compute_dtype)
    harness.say(f"card: {harness.card()}")
    if cell["driver"] == "train_dp":
        ctx = harness.Context(root=ROOT, name=args.workload, seed=0,
                              seconds=args.seconds, trace=False, cell=cell,
                              config=config, chips=entry["chips"],
                              t_start=time.time())
        rows = dp_rows(ctx, args.seeds, args.mode)
        for row in rows:
            print(json.dumps(row), flush=True)
        print(json.dumps(rows), flush=True)
        return 0
    if args.mode.startswith("fault:"):
        plant(args.mode.split(":", 1)[1])  # once for every seed
    rows = []
    if args.mode == "sweep":
        from benchmark.drivers import serve

        ctx = harness.Context(root=ROOT, name=args.workload,
                              seed=args.seeds[0], seconds=args.seconds,
                              trace=False, cell=cell, config=config,
                              chips=entry["chips"], t_start=time.time())
        out = serve.run(ctx, rates=args.rates)
        for line in out["notes"]:
            harness.say(line)
        for rate, o in zip(args.rates, out["sweep"]):
            o.pop("ok")
            print(json.dumps({"rate": rate, **o}), flush=True)
        return 0
    for seed in args.seeds:
        ctx = harness.Context(root=ROOT, name=args.workload, seed=seed,
                              seconds=args.seconds, trace=False, cell=cell,
                              config=config, chips=entry["chips"],
                              t_start=time.time())
        t0 = time.time()
        row = {"seed": seed, "mode": args.mode, **one(ctx, args.mode),
               "seconds": time.time() - t0}
        print(json.dumps(row), flush=True)
        rows.append(row)
    print(json.dumps(rows), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
