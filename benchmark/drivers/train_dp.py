"""The data-parallel train cell: drivers/train.py's process on every card,
one process a card under NCCL, spawned as a plain `--device cuda` launch of
the trainer spawns them (parallel.multihost.run_local_ranks). Each process
takes the cell's batch (the global batch is that times the cards); BN's
statistics, the loss's weight sum and the gradients are over the global
batch. Process 0 measures, traces and hands its outcome back to this one,
which prints the line.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import shutil
import socket
import sys
import tempfile

from benchmark.drivers import train


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def rank_main(ctx, out_path: str) -> None:
    """The body of one spawned process (joined to the group already)."""
    import torch.distributed as dist

    from benchmark import harness

    rank, world = dist.get_rank(), dist.get_world_size()
    device = f"cuda:{rank}" if ctx.device == "cuda" else ctx.device
    ctx = dataclasses.replace(ctx, device=device)
    stop = dist.new_group(backend="gloo")
    out = train.process(ctx, rank, world, stop_group=stop)
    if rank == 0:
        out["forbidden"] = harness.forbidden_modules()
        with open(out_path, "wb") as f:
            pickle.dump(out, f)


def run(ctx) -> dict:
    from zeroshotvideoclassification_tpu_torch.parallel.multihost import (
        run_local_ranks,
    )

    tmp = tempfile.mkdtemp(prefix="portbench_dp_")
    try:
        out_path = os.path.join(tmp, "rank0.pkl")
        device_type = "cuda" if ctx.device.startswith("cuda") else "cpu"
        run_local_ranks(rank_main, (ctx, out_path), ctx.chips,
                        f"tcp://localhost:{_free_port()}",
                        device_type=device_type)
        with open(out_path, "rb") as f:
            out = pickle.load(f)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if out["forbidden"]:
        print(f"process 0 loaded {out['forbidden']}", file=sys.stderr)
    return out
