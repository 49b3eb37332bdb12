#!/usr/bin/env python3
"""chip_smoke.py's phases 21-23 alone: the serving engine over replicas,
the multi-device dry run, and --save_samples with tools/port_checkpoint.

    python3 tools/replica_phases.py [--json PATH] [--skip_p11b] [--gpus_only]

Builds the kernels and runs phase 4's model (its BN statistics and the
class prototypes the served results are held to), then phase 5's
one-replica engine as the reference of phase 21: the engine over two
replicas on cuda:0 and, where the host shows two or more GPUs, over every
GPU (forward clips/s per bucket 8-128 beside one replica's); phase 22:
dryrun_multichip on every GPU under NCCL (two processes under gloo on
cuda:0 on a one-GPU host); phase 23 unless --skip_p11b. --gpus_only
serves over every GPU only (the four-card run). Each phase fails
the run as in chip_smoke.py. Needs an NVIDIA GPU; prints the card's name
and power limit first and last.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--json", default=None)
    p.add_argument("--skip_p11b", action="store_true",
                   help="run phases 21 and 22 only")
    p.add_argument("--gpus_only", action="store_true",
                   help="phase 21 over every GPU only (not also two "
                        "replicas on cuda:0)")
    args = p.parse_args(argv)
    sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
    import torch

    if not torch.cuda.is_available():
        print("replica_phases: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from torch_helpers import copy_bn

    smi = cs.phase_env()
    cs.phase_build()
    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = True
    copy_gbs = cs.measure_copy_bandwidth(dev)
    with tempfile.TemporaryDirectory(prefix="replica_phases_") as tmp:
        paths = cs.make_videos(tmp)
        m32, m16, proto, expected = cs.phase_model(paths, dev)
        serve_bn = copy.deepcopy(m32).cpu()
        del m32, m16
        torch.cuda.empty_cache()

        def prepare(m):
            return copy_bn(serve_bn, m)

        launches = {"serve_replicas": cs.phase_serve_replicas(
            tmp, paths, prepare, proto, expected, dev, smi, copy_gbs,
            sets=["cuda"] if args.gpus_only else None)[0]}
        cs.release()
        launches["dryrun"] = cs.phase_dryrun(dev, smi, copy_gbs)[0]
        cs.release()
        if not args.skip_p11b:
            launches["cli_save_samples"] = cs.phase_p11b(
                tmp, dev, smi, paths, prepare, proto)
    cs.say(f"[replica_phases] launches {launches}")
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(cs.RECORD, f, indent=1, default=str)
    cs.say(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
