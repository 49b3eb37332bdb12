"""The inference step.

Counterpart of zeroshotvideoclassification_tpu/train/step.py:
make_eval_step: BN running statistics, no dropout, no autograd. The train
step is not ported yet.
"""

from __future__ import annotations

import torch
from torch import nn


def eval_step(model: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """x [B, nc, T, H, W, 3] -> unit embeddings [B, 300] float32; `model`
    must be in eval mode."""
    with torch.inference_mode():
        return model(x)
