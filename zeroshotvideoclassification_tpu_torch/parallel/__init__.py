"""Parallelism over processes with one device each: data parallelism and
the head's tensor parallelism (--tp).

Counterpart of zeroshotvideoclassification_tpu/parallel/. The JAX package
shards one SPMD program over a device mesh; the port runs one process per
device under torch.distributed (NCCL on CUDA, gloo on the CPU), each with
its lockstep shard of every batch:
  * mesh.make_mesh — the axis sizes over the processes; mesh.grid_layout —
    which ranks form each data group and each model group;
  * multihost — the process group, the grid (init_grid: a data group and a
    model group per process), lockstep table shards, barriers, process-0
    agreement, the data-index-ordered gather, the sum all-reduces the BN
    statistics, the loss and the gradients go through, and the head's
    model-group operators (copy_to_model, reduce_from_model,
    agree_finite, gather_model).
The JAX package's sharding helpers (batch_sharding, replicated,
param_shardings, state_shardings, shard_batch, global_batch) place arrays
on a mesh for XLA; here the mlp head holds its own shard
(models/heads.MLP.shard) and the rest is replicated.
"""

from zeroshotvideoclassification_tpu_torch.parallel.mesh import (
    grid_layout,
    make_mesh,
)
from zeroshotvideoclassification_tpu_torch.parallel.multihost import (
    agree_from_process_zero,
    gather_rows,
    grid,
    init_grid,
    maybe_initialize,
    process_count,
    process_index,
    process_shard,
    shard_table,
    sync_processes,
)
