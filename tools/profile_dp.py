#!/usr/bin/env python3
"""What a process group costs the PyTorch port's train step, on one GPU.

    python3 tools/profile_dp.py [--json PATH] [--pairs 3]

The configuration of chip_smoke.py's phase 16: r2plus1d_18 + mlp head at
full width, 16 clips of 16x112x112 from the synthetic dataset, bf16 over
float32 masters, the objects the training CLI builds. Each run is a fresh
process (NCCL's flight recorder is set up once a process, from the
environment of its first group), taking, in order:

  1. the train step without a group (CUDA events, median of 6 after 3);
  2. the same step in an NCCL group of one rank: 77 all-reduces a step
     (37 BN statistics forward, the loss's weight sum, 37 BN gradients,
     the gradient buffer, the metrics), none of which moves a byte
     between cards, so what they cost is the host's time;
  3. the host's time of one bare all-reduce of 1153 floats (the largest
     BN statistics tensor, 2 x 576 channels + the count), 200 queued.

The runs alternate TORCH_FR_BUFFER_SIZE (its older name
TORCH_NCCL_TRACE_BUFFER_SIZE cleared) between 2000 (the flight recorder
on) and 0 (off, what parallel.multihost.maybe_initialize sets when the
launcher sets neither): on, off, off, on, ... for --pairs pairs. Needs an
NVIDIA GPU; prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def one_run() -> dict:
    """The three measurements in this process."""
    sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
    import numpy as np
    import torch
    import torch.distributed as dist

    from zeroshotvideoclassification_tpu_torch.cli import main as train_cli
    from zeroshotvideoclassification_tpu_torch.config import transform_dtype
    from zeroshotvideoclassification_tpu_torch.data.datasets import (
        build_datasets,
    )
    from zeroshotvideoclassification_tpu_torch.data.pipeline import (
        HostPipeline,
        device_batch,
    )
    from zeroshotvideoclassification_tpu_torch.parallel import (
        maybe_initialize,
    )

    dev = torch.device("cuda:0")
    tmp = tempfile.mkdtemp(prefix="profile_dp_")
    args = train_cli.build_arg_parser().parse_args([
        "--dataset", "synthetic", "--bs", "16", "--train_samples", "16",
        "--compute_dtype", "bfloat16", "--nopretrained", "--no-progressbar",
        "--save_path", os.path.join(tmp, "runs"), "--device", "cuda:0"])
    cfg = train_cli.config_from_namespace(args)
    datasets = build_datasets(cfg, None)
    table = datasets["training"][0]
    exp = train_cli.Experiment(cfg, datasets, device=dev)
    host = next(iter(HostPipeline(table, cfg, 16, seed=cfg.seed)))
    b = device_batch(host, 1, cfg.clip_len, transform_dtype(cfg), dev)
    ce = torch.from_numpy(np.asarray(table.class_embed, np.float32)).to(dev)

    def step_ms(n=6, warm=3):
        times = []
        for i in range(warm + n):
            torch.cuda.synchronize()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            exp.train_step(b["x"], b["z"], b["label"], b["weight"], ce)
            e1.record()
            torch.cuda.synchronize()
            if i >= warm:
                times.append(e0.elapsed_time(e1))
        return statistics.median(times)

    out = {"no_group_ms": step_ms()}
    maybe_initialize(init_method=f"file://{tmp}/store", rank=0,
                     world_size=1, device=dev)
    out["group_ms"] = step_ms()
    t = torch.zeros(1153, device=dev)
    for _ in range(20):
        dist.all_reduce(t)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        dist.all_reduce(t)
    out["all_reduce_host_us"] = (time.perf_counter() - t0) / 200 * 1e6
    torch.cuda.synchronize()
    dist.destroy_process_group()
    exp.log.close()
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--json", default=None)
    p.add_argument("--pairs", type=int, default=3)
    p.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.child:
        print("RESULT " + json.dumps(one_run()), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("profile_dp: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    sys.path.insert(0, ROOT)
    from zeroshotvideoclassification_tpu_torch import _build

    _build.build()  # once, before the runs load it
    order = []
    for i in range(args.pairs):
        order += ["2000", "0"] if i % 2 == 0 else ["0", "2000"]
    runs = []
    for size in order:
        env = dict(os.environ, TORCH_FR_BUFFER_SIZE=size)
        env.pop("TORCH_NCCL_TRACE_BUFFER_SIZE", None)
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--child"], env=env, capture_output=True,
                           text=True, timeout=600)
        lines = [ln for ln in r.stdout.splitlines()
                 if ln.startswith("RESULT ")]
        if r.returncode != 0 or not lines:
            print(r.stdout[-3000:], r.stderr[-3000:], file=sys.stderr)
            raise RuntimeError(f"run with the recorder at {size} failed")
        res = {"trace_buffer_size": size, **json.loads(lines[0][7:])}
        runs.append(res)
        print(f"[dp] flight recorder {'on ' if size != '0' else 'off'}: "
              f"step {res['no_group_ms']:.2f} ms without a group, "
              f"{res['group_ms']:.2f} ms in an NCCL group of one; one bare "
              f"all-reduce {res['all_reduce_host_us']:.1f} us of host time  "
              f"({smi})", flush=True)
    for size in ("2000", "0"):
        rs = [r for r in runs if r["trace_buffer_size"] == size]
        print(f"[dp] recorder {size}: group step medians "
              f"{statistics.median(r['group_ms'] for r in rs):.2f} ms, "
              f"without {statistics.median(r['no_group_ms'] for r in rs):.2f}"
              f" ms", flush=True)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
            json.dump({"nvidia_smi": smi, "runs": runs}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
