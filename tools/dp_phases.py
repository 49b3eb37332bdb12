#!/usr/bin/env python3
"""chip_smoke.py's data-parallel phases alone, and the trainer's plain
launch on a host with several GPUs.

    python3 tools/dp_phases.py [--json PATH]

Builds the kernels, then, where the host shows two or more GPUs, times a
plain `cli.main --device cuda` launch (one NCCL process per GPU, global
batch 8 x GPUs, one epoch of 64 synthetic clips with its evaluation and
--checkpoint_every 1) and lists the files it wrote; then runs
chip_smoke.py's K1 / K2 checks at a process's 8-clip shapes and phases
16-18 (an NCCL group of one; two processes: NCCL on two GPUs, else gloo
on one; the trainer on two processes). Each phase fails the run as it
does in chip_smoke.py. Needs an NVIDIA GPU; prints the card's name and
power limit first.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--json", default=None)
    args = p.parse_args(argv)
    sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
    import torch

    if not torch.cuda.is_available():
        print("dp_phases: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import chip_smoke as cs

    smi = cs.phase_env()
    cs.phase_build()
    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = True
    copy_gbs = cs.measure_copy_bandwidth(dev)
    with tempfile.TemporaryDirectory(prefix="dp_phases_") as tmp:
        n_gpus = torch.cuda.device_count()
        if n_gpus >= 2:
            argv = ["--dataset", "synthetic", "--bs", "8", "--train_samples",
                    "64", "--n_epochs", "1", "--nopretrained",
                    "--no-progressbar", "--checkpoint_every", "1",
                    "--save_path", os.path.join(tmp, "runs")]
            t0 = time.perf_counter()
            r = subprocess.run(
                [sys.executable, "-c",
                 "import json, sys; from zeroshotvideoclassification_tpu_"
                 "torch.cli import main as m; "
                 "print('SUMMARY', json.dumps(m.main(sys.argv[1:])))",
                 *argv], cwd=ROOT, capture_output=True, text=True,
                timeout=900)
            wall = time.perf_counter() - t0
            files = sorted(os.path.relpath(os.path.join(d, f), tmp)
                           for d, _, fs in os.walk(tmp) for f in fs)
            summary = [ln for ln in r.stdout.splitlines()
                       if ln.startswith("SUMMARY ")]
            cs.say(f"[plain launch] cli.main --device cuda on {n_gpus} GPUs: "
                   f"rc {r.returncode} in {wall:.1f} s; "
                   f"{summary[0] if summary else r.stderr[-3000:]}; files "
                   f"{files}  ({smi})")
            cs.check(r.returncode == 0 and summary, "the plain launch failed")
            cs.RECORD["plain_launch"] = {"gpus": n_gpus, "seconds": wall,
                                         "summary": summary[0][8:],
                                         "files": files}
        cs.phase_dp_kernels(tmp, dev, copy_gbs)
        launches1, f32 = cs.phase_dp_world1(tmp, smi)
        backend, launches2 = cs.phase_dp_2rank(tmp, dev, smi, f32)
        del f32
        launches3 = cs.phase_dp_cli(tmp, dev, smi)
    cs.say(f"[dp] {backend}; launches {launches1} {launches2} {launches3}")
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(cs.RECORD, f, indent=1, default=str)
    cs.say(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
