"""The data-parallel train cell: drivers/train.py's process on every card,
one process a card under NCCL, spawned as a plain `--device cuda` launch of
the trainer spawns them (parallel.multihost.run_local_ranks). Each process
takes the cell's batch (the global batch is that times the cards); BN's
statistics, the loss's weight sum and the gradients are over the global
batch. Process 0 measures, traces and hands its outcome back to this one,
which prints the line.

On the card's host each process takes its own block of the host's cores
(`_core_block`): as many intra-op threads as the block holds, as the
port's dryrun.py sets them, and every thread of the process bound to the
block. Left to PyTorch's default of a thread a core, the four processes
would run four pools of a thread a core on one host's cores.
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


def _core_block(cores, rank: int, world: int) -> list:
    """Rank `rank`'s block of `cores` (sorted) when `world` processes
    share them: len(cores) // world cores in a row, or all of them where
    there are fewer cores than processes."""
    per = len(cores) // world
    return list(cores[rank * per:(rank + 1) * per]) if per else list(cores)


def _bind(rank: int, world: int) -> None:
    """This process's intra-op threads and its every thread (the gloo and
    NCCL helpers that exist already, and those started later, which inherit
    it) on its block of the host's cores."""
    import torch

    block = _core_block(sorted(os.sched_getaffinity(0)), rank, world)
    torch.set_num_threads(len(block))
    for tid in os.listdir("/proc/self/task"):
        try:
            os.sched_setaffinity(int(tid), block)
        except OSError:  # a thread that has ended since the listing
            pass


def rank_main(ctx, out_path: str) -> None:
    """The body of one spawned process (joined to the group already)."""
    import torch.distributed as dist

    from benchmark import harness

    rank, world = dist.get_rank(), dist.get_world_size()
    if ctx.device == "cuda":
        _bind(rank, world)
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
    # the data-parallel cells' rate has a metric and a bound of its own:
    # it follows the shared host's pace, which the one-card cells' bound
    # would not hold (PERF.md)
    out["e2e"]["train_clips_per_s.dp"] = out["e2e"].pop("train_clips_per_s")
    return out
