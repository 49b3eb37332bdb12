"""The data-parallel mesh of the port: how many processes (one device each)
each mesh axis spans.

Counterpart of zeroshotvideoclassification_tpu/parallel/mesh.py:make_mesh,
with its validation and messages. The JAX package lays the devices out in a
jax.sharding.Mesh and XLA shards by it; here a 'data' axis of N is N
processes of the group, each holding a full replica of the model and its
own shard of the batch. A 'model' axis (--tp: the head's tensor
parallelism) is not ported yet.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np


def make_mesh(shape: Sequence[int] = (-1,),
              axes: Sequence[str] = ("data",),
              world_size: Optional[int] = None) -> Dict[str, int]:
    """{axis: size} over `world_size` devices (default: the processes of
    the group); -1 in `shape` absorbs the remaining devices.

    Every device must be used: a fixed axis that does not divide the device
    count, or totals that do not match, raise ValueError as in the JAX
    package. A 'model' axis larger than 1 raises NotImplementedError."""
    if world_size is None:
        from zeroshotvideoclassification_tpu_torch.parallel.multihost import (
            process_count,
        )

        world_size = process_count()
    n = int(world_size)
    shape = list(shape)
    if shape.count(-1) > 1:
        raise ValueError(f"mesh shape {tuple(shape)}: at most one axis "
                         f"may be -1")
    if -1 in shape:
        known = int(np.prod([s for s in shape if s != -1]))
        if known <= 0 or n % known:
            raise ValueError(
                f"mesh shape {tuple(shape)} over axes {tuple(axes)}: the "
                f"fixed axes multiply to {known}, which does not divide "
                f"the {n} available devices — the remainder would sit idle")
        shape[shape.index(-1)] = n // known
    total = int(np.prod(shape))
    if total != n:
        raise ValueError(
            f"mesh shape {tuple(shape)} needs {total} devices but {n} are "
            f"available; pass devices= explicitly to use a subset")
    mesh = dict(zip(axes, (int(s) for s in shape)))
    if mesh.get("model", 1) > 1:
        raise NotImplementedError(
            f"a 'model' mesh axis of {mesh['model']} (--tp, the head's "
            f"tensor parallelism) is not ported yet (ROADMAP P7b)")
    return mesh
