"""Several processes, one device each: the process group, lockstep table
shards and the collectives of data-parallel training.

Counterpart of zeroshotvideoclassification_tpu/parallel/multihost.py on
torch.distributed. The JAX package runs one SPMD program over a mesh and
XLA inserts the collectives; here every process runs the same trainer on
its own shard of the global batch, and the few places that need the whole
batch reduce across processes themselves:

  * train-mode BN sums its statistics over the global batch
    (models/layers.bn_statistics, through all_reduce_sum, which is
    differentiable);
  * the loss divides by the global weight sum, and the gradients are summed
    across processes after the backward (train/step.py);
  * the evaluation gathers every process's embeddings in rank order
    (eval/zeroshot.extract_embeddings, through gather_rows);
  * --resume auto and the run directory are decided on process 0 and
    broadcast (agree_from_process_zero).

Without a process group every function here is the identity or a no-op,
so a one-process run takes exactly the path it took before. NCCL is the
backend on CUDA and gloo on the CPU; a backend that does not come up
raises (there is no fallback from one to the other).
"""

from __future__ import annotations

import dataclasses
import os
import zlib
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

# torchrun's variables; any of them marks a multi-process launch
_HINTS = ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR")


def group_active() -> bool:
    """True inside an initialised process group (of any size)."""
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    """This process's rank, 0 without a group."""
    return dist.get_rank() if group_active() else 0


def process_count() -> int:
    """The number of processes, 1 without a group."""
    return dist.get_world_size() if group_active() else 1


def local_rank() -> int:
    """The rank among this host's processes: LOCAL_RANK where the launcher
    set it, else the global rank."""
    return int(os.environ.get("LOCAL_RANK", process_index()))


def collective_device() -> torch.device:
    """Where the control-plane collectives (barriers, broadcasts) keep their
    tensors: the process's GPU under NCCL, the CPU under gloo."""
    if group_active() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def maybe_initialize(backend: Optional[str] = None,
                     init_method: Optional[str] = None,
                     rank: Optional[int] = None,
                     world_size: Optional[int] = None,
                     device=None) -> bool:
    """Join the process group when something asks for one; -> whether this
    call opened it.

    A fast no-op without a hint, as the JAX package's: the trainer calls it
    unconditionally at startup, and a plain one-process run must open no
    group. The hints are explicit arguments or torchrun's WORLD_SIZE /
    RANK / LOCAL_RANK / MASTER_ADDR (read as init_method "env://"). A group
    that already exists is left as it is.

    The backend is `backend`, else NCCL when `device` (default: cuda where
    a GPU is visible) is a CUDA device and gloo otherwise. Under NCCL the
    process binds to `device`'s index, or to cuda:LOCAL_RANK, and the
    communicator is brought up here with one all-reduce: a backend that
    cannot connect raises now, never later and never by falling back."""
    if group_active():
        return False
    env = os.environ
    explicit = (init_method, rank, world_size)
    if all(v is None for v in explicit) and not any(k in env
                                                    for k in _HINTS):
        return False
    missing = [k for k, v in (("WORLD_SIZE", world_size), ("RANK", rank))
               if v is None and k not in env]
    if missing:
        raise ValueError(f"a multi-process launch needs {missing} (as "
                         f"arguments or in the environment)")
    world_size = int(env["WORLD_SIZE"] if world_size is None else world_size)
    rank = int(env["RANK"] if rank is None else rank)
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    kw = {}
    if backend == "nccl":
        index = (device.index if device.index is not None
                 else int(env.get("LOCAL_RANK", rank)))
        torch.cuda.set_device(index)
        kw["device_id"] = torch.device("cuda", index)
        # NCCL's flight recorder records every collective: 98-146 us of
        # host time a call against 22-24 us without it, on a host-paced
        # step of 77 calls (PERF.md, tools/profile_dp.py); a launcher that
        # wants the record sets either variable itself
        if not any(k in env for k in ("TORCH_FR_BUFFER_SIZE",
                                      "TORCH_NCCL_TRACE_BUFFER_SIZE")):
            env["TORCH_FR_BUFFER_SIZE"] = "0"
    dist.init_process_group(backend, init_method=init_method or "env://",
                            rank=rank, world_size=world_size, **kw)
    probe = torch.ones(1, device=collective_device())
    dist.all_reduce(probe)
    if int(probe.item()) != world_size:
        raise RuntimeError(f"{backend} group of {world_size}: the first "
                           f"all-reduce gave {probe.item()}")
    return True


def process_shard(n: int) -> Tuple[int, int]:
    """(start, stop) of this process's contiguous slice of an n-sample list."""
    pi, pc = process_index(), process_count()
    per = (n + pc - 1) // pc
    return min(pi * per, n), min((pi + 1) * per, n)


def shard_table(table):
    """Process-local slice of a VideoTable, LOCKSTEP-padded.

    Every process gets exactly ceil(n / process_count) rows so that all
    processes dispatch the same number of batches per epoch — unequal batch
    counts would deadlock the collectives. Rows past the end of the global
    table are marked label -1: the host pipeline skips their decode and
    emits them with weight 0 (the broken-sample convention), so they
    contribute nothing to loss or metrics. Single-process: returns the table
    unchanged."""
    pc = process_count()
    if pc == 1:
        return table
    n = len(table)
    per = (n + pc - 1) // pc
    pi = process_index()
    idx = np.arange(pi * per, (pi + 1) * per)
    valid = idx < n
    safe = np.where(valid, idx, 0)
    return dataclasses.replace(
        table,
        fnames=table.fnames[safe],
        label_idx=np.where(valid, table.label_idx[safe], -1).astype(np.int32),
    )


def sync_processes(tag: str) -> None:
    """Barrier at a phase boundary whose first collective would otherwise be
    entered skewed (process 0 does IO the others skip). Every process must
    reach the barrier of the same `tag`: one all-reduce carries the tag's
    CRC as its max and its negated min, and differing tags raise here,
    where a skipped or reordered barrier would otherwise hang or pair the
    wrong collectives later. No-op with one process."""
    if process_count() == 1:
        return
    crc = zlib.crc32(tag.encode("utf-8"))
    t = torch.tensor([crc, -crc], dtype=torch.int64,
                     device=collective_device())
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    hi, neg_lo = (int(v) for v in t.tolist())
    if hi != -neg_lo:
        raise RuntimeError(f"sync_processes({tag!r}): the processes are at "
                           f"different barriers")


def agree_from_process_zero(s: Optional[str]) -> Optional[str]:
    """All processes adopt process 0's string (or None): the --resume auto
    checkpoint and the run directory, which must not be resolved per
    process (per-host disks or a race could pick different ones and put
    the processes on divergent state). Identity with one process."""
    if process_count() == 1:
        return s
    box = [s]
    dist.broadcast_object_list(box, src=0, device=collective_device())
    return box[0]


def all_reduce_(t: torch.Tensor) -> torch.Tensor:
    """In-place SUM of `t` over the processes, outside autograd; the
    identity without a group. -> t."""
    if group_active():
        dist.all_reduce(t)
    return t


class _AllReduceSum(torch.autograd.Function):
    """SUM all-reduce whose backward is the SUM all-reduce of the incoming
    gradient: each process's tensor feeds the global sum, so its gradient
    is the sum of every process's gradient of that sum."""

    @staticmethod
    def forward(ctx, x):
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g)
        return g


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """Differentiable SUM of `x` over the processes; `x` itself without a
    group."""
    return _AllReduceSum.apply(x) if group_active() else x


def gather_rows(t: torch.Tensor) -> torch.Tensor:
    """[b, k] on every process -> [P * b, k], the processes' rows in rank
    order (the order of the JAX package's global array; fetch_global's
    counterpart). Every process must give the same shape and dtype.

    It is an all-reduce of a zeroed buffer in which each process fills its
    own slot: the one collective that NCCL and gloo both run on CUDA
    tensors, and each entry is one value plus zeros, so every process gets
    the same bits. `t` itself without a group."""
    if not group_active():
        return t
    b = t.shape[0]
    buf = t.new_zeros((process_count() * b, *t.shape[1:]))
    buf[process_index() * b:(process_index() + 1) * b] = t
    dist.all_reduce(buf)
    return buf


def run_local_ranks(fn, args: tuple, world_size: int, init_method: str,
                    device_type: str = "cuda") -> None:
    """Run fn(*args) in `world_size` new processes (spawned, not forked),
    one rank each on cuda:<rank> (or each on the CPU), every one joined to
    one group through `init_method` (for example "file:///path/to/store")
    before fn runs. `fn` must be importable by name. Raises if any rank
    fails; what fn returns is dropped, so it writes its results itself."""
    import torch.multiprocessing as mp

    mp.start_processes(_rank_entry, args=(world_size, init_method,
                                          device_type, fn, args),
                       nprocs=world_size, start_method="spawn", join=True)


def _rank_entry(rank, world_size, init_method, device_type, fn, args):
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(world_size))
    device = f"cuda:{rank}" if device_type == "cuda" else device_type
    maybe_initialize(init_method=init_method, rank=rank,
                     world_size=world_size, device=device)
    try:
        fn(*args)
    finally:
        dist.destroy_process_group()
