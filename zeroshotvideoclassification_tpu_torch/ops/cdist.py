"""Cosine distances between embeddings and class embeddings.

Counterpart of zeroshotvideoclassification_tpu/ops/cdist.py:
cosine_distances, which is no Pallas kernel: one [N, D] x [D, C] float32
product, here torch.matmul. It must run in full float32: class embeddings
can lie ~1e-3 apart in cosine distance, and TF32's ~1e-3 relative error
could flip a ranking, so a CUDA call with TF32 matmuls enabled raises.
"""

from __future__ import annotations

import torch


def _unit(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    n = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return x / torch.clamp_min(n, eps)


def cosine_distances(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[N, D] x [C, D] -> [N, C] pairwise cosine distances (scipy
    semantics), in float32."""
    if a.device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("cosine_distances needs full float32 matmuls: "
                           "set torch.backends.cuda.matmul.allow_tf32 = "
                           "False")
    return 1.0 - torch.matmul(_unit(a.float()), _unit(b.float()).T)
