"""The mesh of the port: how many processes (one device each) each mesh
axis spans, and where each process sits on it.

Counterpart of zeroshotvideoclassification_tpu/parallel/mesh.py:make_mesh,
with its validation and messages. The JAX package lays the devices out in a
jax.sharding.Mesh and XLA shards by it; here a 'data' axis of N is N
processes, each with its own shard of the batch, and a 'model' axis of
--tp N is N processes that see the same rows and each hold one shard of
the mlp head (models/heads.MLP). The processes take the places of the JAX
package's devices in np.asarray(devices).reshape(shape) (mesh.py:46):
rank r sits at data r // tp and model r % tp (grid_layout).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def make_mesh(shape: Sequence[int] = (-1,),
              axes: Sequence[str] = ("data",),
              world_size: Optional[int] = None) -> Dict[str, int]:
    """{axis: size} over `world_size` devices (default: the processes of
    the group); -1 in `shape` absorbs the remaining devices.

    Every device must be used: a fixed axis that does not divide the device
    count, or totals that do not match, raise ValueError as in the JAX
    package."""
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
    return dict(zip(axes, (int(s) for s in shape)))


def grid_layout(world_size: int, tp: int) -> Tuple[List[List[int]],
                                                   List[List[int]]]:
    """(data groups, model groups) of a (world_size / tp) x tp grid, as
    lists of ranks: data group m is the ranks at model index m ({m, m + tp,
    ...}, in data-index order), model group d the ranks at data index d
    ({d tp, ..., d tp + tp - 1}). make_mesh validates the sizes first."""
    n_data = make_mesh((-1, tp), ("data", "model"), world_size)["data"]
    data = [[d * tp + m for d in range(n_data)] for m in range(tp)]
    model = [[d * tp + m for m in range(tp)] for d in range(n_data)]
    return data, model
