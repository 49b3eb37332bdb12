"""The training and inference steps.

Counterpart of zeroshotvideoclassification_tpu/train/step.py: one call per
step — train-mode forward (bf16 compute with float32 master weights, BN batch
statistics), masked MSE, backward (K2's backward kernel in every epilogue),
the guarded Adam update, and the train accuracy against the TRAIN class
embeddings on the device. Fresh gradients every step. Nothing in the step
synchronises with the host: loss and accuracy come back as device scalars.
The scan-fused multi-step variant (step.py:94) is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch
from torch import nn

from zeroshotvideoclassification_tpu_torch.ops.cdist import nearest_class


@dataclasses.dataclass
class TrainState:
    """The model (parameters and BN statistics), its optimizer (moments and
    count) and the number of steps taken, skipped ones included."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


def masked_mse(emb: torch.Tensor, z: torch.Tensor,
               weight: torch.Tensor) -> torch.Tensor:
    """MSELoss(mean) over valid samples only (reference/main.py:130,179 +
    mask); an all-zero weight gives loss 0 and zero gradients."""
    per = torch.mean(torch.square(emb - z.float()), dim=-1)
    denom = torch.clamp_min(torch.sum(weight), 1.0)
    return torch.sum(per * weight) / denom


def make_train_step(model: nn.Module, optimizer: torch.optim.Optimizer,
                    compute_dtype: torch.dtype = torch.bfloat16) -> Callable:
    """Returns step(x, z, labels, weight, class_embed, rng=None) -> metrics,
    which updates `model` and `optimizer` in place. Shapes: x [B, nc, T, H,
    W, 3] (normalized floats), z [B, 300], labels [B] int32, weight [B]
    (1 valid / 0 broken-or-pad), class_embed [C, 300]. metrics = {"loss",
    "train_accuracy"}, 0-dim tensors on the model's device. `rng` (a
    torch.Generator on the model's device) draws the dropout masks of the
    linear and C3D heads; without one they drop nothing.

    The convs run in `compute_dtype` on casts of their float32 weights, so
    gradients and the optimizer's moments are float32. Under --fixconvs
    the backbone's parameters get no gradient, and the optimizer leaves
    them (and their moments) as they are."""
    model.set_compute_dtype(compute_dtype, masters=True)
    state = TrainState(model, optimizer)

    def step(x, z, labels, weight, class_embed,
             rng: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        model.train()
        optimizer.zero_grad(set_to_none=True)
        with torch.enable_grad():  # whatever mode the caller is in
            emb = model(x, generator=rng)
            loss = masked_mse(emb, z, weight)
        loss.backward()
        optimizer.step()
        state.step += 1
        with torch.no_grad():
            pred = nearest_class(emb, class_embed)
            correct = (pred == labels).float() * weight
            acc = (torch.sum(correct)
                   / torch.clamp_min(torch.sum(weight), 1.0) * 100.0)
        return {"loss": loss.detach(), "train_accuracy": acc}

    step.state = state
    return step


def eval_step(model: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """x [B, nc, T, H, W, 3] -> unit embeddings [B, 300] float32; `model`
    must be in eval mode (BN running statistics, no dropout, no autograd)."""
    with torch.inference_mode():
        return model(x)
