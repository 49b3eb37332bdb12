#!/usr/bin/env python3
"""chip_smoke.py's phase 19 alone: --steps_per_call as CUDA graphs of the
train step.

    python3 tools/graph_phase.py [--json PATH] [--nccl_only | --tp_grid]

Builds the kernels, then runs phase 19 as chip_smoke.py does: float32 runs
of the trainer at --steps_per_call 4 against 1 (two epochs of 8 steps, and
one epoch of 6 with a tail of 2), the bf16 step eager and as a replay / 4
with peak memory and the capture's time, K2's kernel nodes in one replay,
a group of NaN batches, --debug_nans grouped and ungrouped, resnet18's
dropout across replays, one --remat full group, and NCCL groups of one
process (and of two where the host shows two GPUs) with the all-reduces
captured; then the trainer's other options under graphs (--remat convs,
--fixconvs, C3D, --clip_pool embedding, the linear head), each two groups
of 2 float32 steps against 4 single steps (chip_smoke.graph_options, which
chip_smoke.py itself does not run). Each check fails the run as it does in
chip_smoke.py. --nccl_only runs the NCCL groups alone (on a host with
several GPUs: the captured all-reduces across two cards) and times each
process's bf16 step of 8 clips eagerly and as a replay / 4. --tp_grid runs
four processes as a 2 x 2 grid at --tp 2 under NCCL, one GPU each (a host
with four GPUs): two groups of 4 float32 steps of 8 clips a data shard
with the data and model groups' all-reduces captured, against single
steps in the grid, and each process's bf16 step eagerly and as a replay /
4. Needs an NVIDIA GPU; prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--json", default=None,
                   help="also write every measurement to this file")
    p.add_argument("--nccl_only", action="store_true",
                   help="run only the NCCL groups of phase 19")
    p.add_argument("--tp_grid", action="store_true",
                   help="run only the 2 x 2 grid at --tp 2 (four GPUs)")
    args = p.parse_args(argv)
    sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
    import torch

    if not torch.cuda.is_available():
        print("graph_phase: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import chip_smoke as cs

    smi = cs.phase_env()
    cs.phase_build()
    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = True
    with tempfile.TemporaryDirectory(prefix="graph_phase_") as tmp:
        if args.tp_grid:
            cs.RECORD["tp_grid"] = cs.graph_tp_grid(tmp)
        elif args.nccl_only:
            cs.RECORD["nccl"] = cs.graph_nccl(tmp, timed=True)
        else:
            cs.phase_graphs(tmp, dev, smi)
            cs.graph_options(tmp, dev)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(cs.RECORD, f, indent=1, default=str)
    cs.say(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
