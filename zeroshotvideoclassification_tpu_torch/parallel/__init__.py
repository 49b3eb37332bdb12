"""Parallelism: data parallelism over processes with one device each.

Counterpart of zeroshotvideoclassification_tpu/parallel/. The JAX package
shards one SPMD program over a device mesh; the port runs one process per
device under torch.distributed (NCCL on CUDA, gloo on the CPU), each with a
full replica of the model and its lockstep shard of every batch:
  * mesh.make_mesh — the axis sizes over the processes ('data' only; a
    'model' axis, --tp, is ROADMAP P7b);
  * multihost — the process group, lockstep table shards, barriers,
    process-0 agreement, the rank-ordered gather, and the sum all-reduces
    the BN statistics, the loss and the gradients go through.
The JAX package's sharding helpers (batch_sharding, replicated,
param_shardings, state_shardings, shard_batch, global_batch) place arrays
on a mesh for XLA and have no counterpart here.
"""

from zeroshotvideoclassification_tpu_torch.parallel.mesh import make_mesh
from zeroshotvideoclassification_tpu_torch.parallel.multihost import (
    agree_from_process_zero,
    gather_rows,
    maybe_initialize,
    process_count,
    process_index,
    process_shard,
    shard_table,
    sync_processes,
)
