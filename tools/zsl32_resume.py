#!/usr/bin/env python3
"""The 32-class synthetic zero-shot protocol on one GPU, through one
interruption and --resume auto: the port's evidence that it learns.

    python3 tools/zsl32_resume.py [--save_path DIR] [--json PATH]
                                  [--interrupt_after 7] [--epochs 16]

The protocol of the JAX package's own run on the TPU: 32 training
classes, 16 unseen test classes, 960 training samples, --clip_len 16,
--bs 32, random init (--nopretrained), the default learning rate,
bf16 compute; here with --checkpoint_every 1. The first job
trains epochs 0..interrupt_after and exits; the second, a new process,
resumes with --resume auto and trains to --epochs. Each job is
`python -m zeroshotvideoclassification_tpu_torch.cli.main`, whose output
goes to <save_path>/job{1,2}.log. The script prints the card's name and
power limit, each job's wall time and the RESUMED line, then one line per
epoch: the train regressor accuracy (the trainer's epoch line), the test
top-1 and top-5 (the run's synthetic_test_accuracy.csv) and the 10-split
protocol's mean (its _splits.csv). Needs an NVIDIA GPU.
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROTOCOL = ["--dataset", "synthetic", "--class_total", "32",
            "--train_samples", "960", "--clip_len", "16", "--bs", "32",
            "--nopretrained", "--checkpoint_every", "1", "--no-progressbar"]


def job(save_path, n_epochs, extra, log):
    cmd = [sys.executable, "-m", "zeroshotvideoclassification_tpu_torch."
           "cli.main", *PROTOCOL, "--n_epochs", str(n_epochs),
           "--save_path", save_path, *extra]
    t0 = time.perf_counter()
    with open(log, "w") as f:
        proc = subprocess.run(cmd, cwd=ROOT, stdout=f,
                              stderr=subprocess.STDOUT, text=True)
    wall = time.perf_counter() - t0
    with open(log) as f:
        text = f.read()
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} exited {proc.returncode}:\n"
                           f"{text[-3000:]}")
    return text, wall


def read_csv(path):
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return {int(r[0]): [float(v) for v in r[1:]] for r in csv.reader(f)
                if r}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--save_path", default=os.path.join(ROOT, "build",
                                                       "zsl32"))
    p.add_argument("--json", default=None)
    p.add_argument("--interrupt_after", type=int, default=7)
    p.add_argument("--epochs", type=int, default=16)
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("zsl32_resume: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0].strip()
    print(smi, flush=True)
    os.makedirs(args.save_path, exist_ok=True)
    text1, wall1 = job(args.save_path, args.interrupt_after + 1, [],
                       os.path.join(args.save_path, "job1.log"))
    print(f"[zsl32] job 1: epochs 0..{args.interrupt_after} in {wall1:.1f} "
          f"s", flush=True)
    text2, wall2 = job(args.save_path, args.epochs, ["--resume", "auto"],
                       os.path.join(args.save_path, "job2.log"))
    resumed = [ln for ln in text2.splitlines() if ln.startswith("RESUMED")]
    print(f"[zsl32] job 2: {resumed[0] if resumed else 'NOT RESUMED'}; "
          f"epochs {args.interrupt_after + 1}..{args.epochs - 1} in "
          f"{wall2:.1f} s", flush=True)
    if not resumed:
        raise RuntimeError("the second job did not resume")
    run_dir = os.path.dirname(resumed[0].split()[1])
    acc = read_csv(os.path.join(run_dir, "synthetic_test_accuracy.csv"))
    splits = read_csv(os.path.join(run_dir,
                                   "synthetic_test_accuracy_splits.csv"))
    train = [float(v) for v in re.findall(
        r"Train Accuracy: regressor ([0-9.]+)%", text1 + text2)]
    rate = [float(v) for v in re.findall(r"\| ([0-9.]+) clips/sec",
                                         text1 + text2)]
    rows = []
    for e in range(args.epochs):
        row = {"epoch": e, "train_regressor_acc": train[e],
               "train_clips_per_s": rate[e], "test_top1": acc[e][0],
               "test_top5": acc[e][1],
               "split_mean": splits.get(e, [None])[0]}
        rows.append(row)
        mark = " (resumed)" if e == args.interrupt_after + 1 else ""
        print(f"[zsl32] epoch {e:2d}{mark}: "
              f"train regressor {row['train_regressor_acc']:.1f}%, "
              f"{row['train_clips_per_s']:.1f} clips/s; test top-1 "
              f"{row['test_top1']:.1f}%, top-5 {row['test_top5']:.1f}%, "
              f"10-split mean {row['split_mean']}%  ({smi})", flush=True)
    record = {"nvidia_smi": smi, "protocol": PROTOCOL,
              "interrupt_after": args.interrupt_after, "epochs": rows,
              "job_seconds": [wall1, wall2], "resumed": resumed[0],
              "best_top1": max(r["test_top1"] for r in rows)}
    print(f"[zsl32] best test top-1 {record['best_top1']:.1f}% on 16 unseen "
          f"classes (chance 6.25%)", flush=True)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(record, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
