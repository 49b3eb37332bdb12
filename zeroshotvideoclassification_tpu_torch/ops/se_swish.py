"""X3D's conv_b epilogue after its BN: squeeze-and-excitation, then Swish,
as one op with one entry point.

    gate = sigmoid(W2 relu(W1 mean_THW(y) + b1) + b2)      [N, C] float32
    s = y * gate                                           (y's dtype)
    out = s * sigmoid(s)                                   (y's dtype)

The gate is 1 where the block has no squeeze-and-excitation (fc1 and fc2
None). The pooled mean and the two FCs run in float32, as the port's other
reductions and heads do (the mean accumulates in float32, or y's dtype
where that is wider, without a float32 copy of y); the product and the
Swish run in y's dtype. Plain PyTorch under autograd on both devices:
F.silu keeps only s for its backward.

Each call runs in the span `se_swish`; while a profiler records, its
backward, from the first gradient to reach the output to the gradient of y
being complete, is the bracket `se_swish.backward` (utils/profiler.py).
models/x3d.py calls it at every block, so a later kernel replaces this
body and nothing of the model.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from zeroshotvideoclassification_tpu_torch.utils import profiler


def se_swish(y: torch.Tensor, fc1: Optional[nn.Conv3d] = None,
             fc2: Optional[nn.Conv3d] = None) -> torch.Tensor:
    """[N, C, T, H, W] -> the same shape, dtype and memory layout. fc1 /
    fc2: the 1x1x1 biased convs C -> r -> C of the squeeze-and-excitation
    (float32), or None for the gate of 1."""
    with profiler.span("se_swish"):
        s = y
        if fc1 is not None:
            m = y.mean(dim=(2, 3, 4),
                       dtype=torch.promote_types(y.dtype, torch.float32))
            h = torch.relu(F.linear(m, fc1.weight.flatten(1), fc1.bias))
            gate = torch.sigmoid(F.linear(h, fc2.weight.flatten(1),
                                          fc2.bias))
            s = y * gate.to(y.dtype)[:, :, None, None, None]
        out = F.silu(s)
        profiler.backward_bracket("se_swish.backward", (out,), y)
    return out
