"""Several processes, one device each: the process group, the grid of
data and model groups, lockstep table shards and the collectives of
data- and tensor-parallel training.

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
  * the evaluation gathers every process's embeddings in data-index order
    (eval/zeroshot.extract_embeddings, through gather_rows);
  * --resume auto and the run directory are decided on process 0 and
    broadcast (agree_from_process_zero).

The grid (--tp N, init_grid): P processes form a (P / N) x N mesh over
('data', 'model'). Each process belongs to one data group (the processes
at its model index, one a data shard) and one model group (the N
processes at its data index, which see the same rows and each hold one
shard of the mlp head). The reductions above run over the data group. The
head's two Megatron-style operators run over the model group:
copy_to_model (identity forward, all-reduce backward) before fc1 and
reduce_from_model (all-reduce forward, identity backward) after fc2;
the guarded Adam agrees its finite flag over it (agree_finite), and a
checkpoint gathers the head's shards over it (gather_model). Without a
grid (--tp 1) the data group is the whole group and nothing else changes.

Under NCCL these collectives can be captured into a CUDA graph of the
train step (train/step.make_scan_train_step): the clones of
_AllReduceSum then allocate in the graph's pool, and the groups must have
run one step eagerly first (a communicator comes up on its first call).
gloo cannot be captured (check_capturable).

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


@dataclasses.dataclass(frozen=True)
class Grid:
    """This process's place on the (n_data x tp) grid and its two groups
    (torch ProcessGroups; None: the whole group, or no group at all)."""

    n_data: int
    tp: int
    data_index: int
    model_index: int
    data_group: object = None
    model_group: object = None


_GRID: Optional[Grid] = None


def grid() -> Grid:
    """The grid init_grid built, else the data-parallel one: every process
    its own data shard, the whole group the data group, no model axis."""
    if _GRID is not None and group_active():
        return _GRID
    return Grid(process_count(), 1, process_index(), 0)


def init_grid(tp: int) -> Grid:
    """Build the (P / tp) x tp grid over the P processes of the group:
    every data group and every model group through
    torch.distributed.new_group, on every process and in one order (as
    new_group asks), before the first collective on either. tp 1 builds no
    group and keeps the data-parallel grid. A tp that does not divide P
    raises ValueError (make_mesh's message). -> this process's Grid."""
    global _GRID
    from zeroshotvideoclassification_tpu_torch.parallel.mesh import (
        grid_layout,
    )

    world, rank = process_count(), process_index()
    data_groups, model_groups = grid_layout(world, tp)
    _GRID = None
    if tp == 1:
        return grid()
    mine = {}
    for kind, layout in (("data", data_groups), ("model", model_groups)):
        for ranks in layout:
            g = dist.new_group(ranks)
            if rank in ranks:
                mine[kind] = g
    _GRID = Grid(world // tp, tp, rank // tp, rank % tp, mine["data"],
                 mine["model"])
    return _GRID


def destroy() -> None:
    """Leave the process group and forget the grid."""
    global _GRID
    _GRID = None
    dist.destroy_process_group()


def process_shard(n: int, index: Optional[int] = None,
                  count: Optional[int] = None) -> Tuple[int, int]:
    """(start, stop) of data shard `index` of `count` (default: this
    process's data index and the number of data shards) of an n-sample
    list."""
    g = grid()
    pi = g.data_index if index is None else index
    pc = g.n_data if count is None else count
    per = (n + pc - 1) // pc
    return min(pi * per, n), min((pi + 1) * per, n)


def shard_table(table, index: Optional[int] = None,
                count: Optional[int] = None):
    """Data shard `index` of `count` of a VideoTable (default: this
    process's data index and the number of data shards; the processes of
    one model group share their rows), LOCKSTEP-padded.

    Every shard has exactly ceil(n / count) rows so that all
    processes dispatch the same number of batches per epoch — unequal batch
    counts would deadlock the collectives. Rows past the end of the global
    table are marked label -1: the host pipeline skips their decode and
    emits them with weight 0 (the broken-sample convention), so they
    contribute nothing to loss or metrics. One shard: returns the table
    unchanged."""
    g = grid()
    pi = g.data_index if index is None else index
    pc = g.n_data if count is None else count
    if pc == 1:
        return table
    n = len(table)
    per = (n + pc - 1) // pc
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


def check_capturable(device) -> None:
    """Raise ValueError where a CUDA graph on `device` could not capture
    this process's collectives: under gloo, which stages CUDA tensors
    through the host (a copy and a wait that no graph records). NCCL's
    collectives, and a run without a group, capture."""
    if (torch.device(device).type == "cuda" and group_active()
            and dist.get_backend() != "nccl"):
        raise ValueError(
            f"CUDA graphs of the train step (--steps_per_call > 1) capture "
            f"the collectives, which needs the NCCL backend; this process "
            f"group runs {dist.get_backend()}")


def data_group():
    """The processes that hold the other data shards at this model index
    (the whole group without a grid)."""
    return grid().data_group


def model_group():
    """The processes that share this process's rows (None without a
    model axis)."""
    return grid().model_group


def all_reduce_(t: torch.Tensor, group=None) -> torch.Tensor:
    """In-place SUM of `t` over `group` (default: every process), outside
    autograd; the identity without a process group. -> t."""
    if group_active():
        dist.all_reduce(t, group=group)
    return t


class _AllReduceSum(torch.autograd.Function):
    """SUM all-reduce whose backward is the SUM all-reduce of the incoming
    gradient: each process's tensor feeds the group's sum, and each holds a
    share of the loss, so its gradient is the sum of every process's
    gradient of that sum."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """Differentiable SUM of `x` over `group` (default: every process);
    `x` itself without a process group."""
    return _AllReduceSum.apply(x, group) if group_active() else x


class _CopyToModel(torch.autograd.Function):
    """The identity forward; the backward sums the gradient over the model
    group: each member's fc1 shard gives its share of the input's
    gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    """The model group's SUM forward; the identity backward. Every member
    holds the same loss (the same rows), so the gradient of the sum is the
    incoming gradient as it is: an all-reduce here would count it tp
    times."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """Where the head's input enters its model-parallel part; `x` itself
    without a model axis."""
    g = model_group()
    return x if g is None else _CopyToModel.apply(x, g)


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    """The sum of the model group's partial products (fc2 on each shard);
    `x` itself without a model axis."""
    g = model_group()
    return x if g is None else _ReduceFromModel.apply(x, g)


def agree_finite(flag: torch.Tensor) -> torch.Tensor:
    """A 0-dim bool that is True only where it is True on every process of
    the model group (a MIN all-reduce): the guarded Adam's decision, which
    the members must take alike or their states part for good. `flag`
    itself without a model axis."""
    g = model_group()
    if g is None:
        return flag
    t = flag.to(torch.int32).reshape(1)
    dist.all_reduce(t, op=dist.ReduceOp.MIN, group=g)
    return t.reshape(()).to(torch.bool)


def _gather(t: torch.Tensor, dim: int, group, index: int,
            size: int) -> torch.Tensor:
    """Every member's `t` (one shape and dtype on all) concatenated along
    `dim` in group-rank order: an all-reduce of a zeroed buffer in which
    each member fills its own slot, the one collective that NCCL and gloo
    both run on CUDA tensors; each entry is one value plus zeros, so every
    member gets the same bits."""
    b = t.shape[dim]
    shape = list(t.shape)
    shape[dim] = size * b
    buf = t.new_zeros(shape)
    buf.narrow(dim, index * b, b).copy_(t)
    dist.all_reduce(buf, group=group)
    return buf


def gather_rows(t: torch.Tensor) -> torch.Tensor:
    """[b, k] on every process -> [n_data * b, k], the data shards' rows in
    data-index order (the order of the JAX package's global array;
    fetch_global's counterpart), over the data group: the members of a
    model group each gather the whole table once. `t` itself without a
    process group."""
    if not group_active():
        return t
    g = grid()
    return _gather(t, 0, g.data_group, g.data_index, g.n_data)


def gather_model(t: torch.Tensor, dim: int) -> torch.Tensor:
    """The model group's shards of one tensor, whole (concatenated along
    `dim` in model-index order); `t` itself without a model axis."""
    g = grid()
    if g.model_group is None:
        return t
    return _gather(t, dim, g.model_group, g.model_index, g.tp)


def run_local_ranks(fn, args: tuple, world_size: int, init_method: str,
                    device_type: str = "cuda",
                    backend: Optional[str] = None) -> None:
    """Run fn(*args) in `world_size` new processes (spawned, not forked),
    one rank each on cuda:<rank> (or each on the CPU), every one joined to
    one group through `init_method` (for example "file:///path/to/store")
    before fn runs; `backend` as maybe_initialize picks it, except that
    gloo on CUDA puts every rank on cuda:0 (as one card's tests of a group
    do; NCCL refuses two processes on one device). `fn` must be
    importable by name. Raises if any rank fails; what fn returns is
    dropped, so it writes its results itself."""
    import torch.multiprocessing as mp

    mp.start_processes(_rank_entry, args=(world_size, init_method,
                                          device_type, fn, args, backend),
                       nprocs=world_size, start_method="spawn", join=True)


def _rank_entry(rank, world_size, init_method, device_type, fn, args,
                backend=None):
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(world_size))
    device = device_type
    if device_type == "cuda":
        device = f"cuda:{0 if backend == 'gloo' else rank}"
        torch.cuda.set_device(device)
    maybe_initialize(backend=backend, init_method=init_method, rank=rank,
                     world_size=world_size, device=device)
    try:
        fn(*args)
    finally:
        destroy()
