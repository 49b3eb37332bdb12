"""The training and inference steps.

Counterpart of zeroshotvideoclassification_tpu/train/step.py: one call per
step — train-mode forward (bf16 compute with float32 master weights, BN batch
statistics), masked MSE, backward (K2's backward kernel in every epilogue),
the guarded Adam update, and the train accuracy against the TRAIN class
embeddings on the device. Fresh gradients every step. Nothing in the step
synchronises with the host: loss and accuracy come back as device scalars.
The scan-fused multi-step variant (step.py:94) is not ported yet.

Under a process group (parallel/multihost.py) each process steps on its
shard of the global batch and the step computes what the JAX package's
computes on the whole batch: BN statistics are global (models/layers.py),
the loss divides by the GLOBAL weight sum, so each process's loss is its
share of the global loss, and the gradients are SUMMED over the processes
(not averaged, as DDP averages them: with shares of one loss the sum is the
gradient of the global loss, also where the shards' weight sums differ).
Every process then holds the same gradients, and the guarded Adam takes the
same decision and the same update everywhere.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch
from torch import nn

from zeroshotvideoclassification_tpu_torch.ops.cdist import nearest_class
from zeroshotvideoclassification_tpu_torch.parallel.multihost import (
    all_reduce_,
    group_active,
)


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
    mask); an all-zero weight gives loss 0 and zero gradients. The
    denominator is the weight sum of the global batch (summed over the
    processes of a group), so under a group this is this process's share
    of the global loss."""
    per = torch.mean(torch.square(emb - z.float()), dim=-1)
    denom = torch.clamp_min(all_reduce_(torch.sum(weight.detach())), 1.0)
    return torch.sum(per * weight) / denom


def sum_gradients(params) -> None:
    """Sum the gradients of `params` (those that have one) over the
    processes, in place, as one all-reduce of a flat buffer; nothing
    without a group. Every process must have gradients for the same
    parameters."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads or not group_active():
        return
    flat = torch._utils._flatten_dense_tensors(grads)
    all_reduce_(flat)
    for g, total in zip(grads,
                        torch._utils._unflatten_dense_tensors(flat, grads)):
        g.copy_(total)


def make_train_step(model: nn.Module, optimizer: torch.optim.Optimizer,
                    compute_dtype: torch.dtype = torch.bfloat16) -> Callable:
    """Returns step(x, z, labels, weight, class_embed, rng=None) -> metrics,
    which updates `model` and `optimizer` in place. Shapes: x [B, nc, T, H,
    W, 3] (normalized floats), z [B, 300], labels [B] int32, weight [B]
    (1 valid / 0 broken-or-pad), class_embed [C, 300]. metrics = {"loss",
    "train_accuracy"}, 0-dim tensors on the model's device, of the global
    batch under a process group. `rng` (a
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
        sum_gradients(model.parameters())
        optimizer.step()
        state.step += 1
        with torch.no_grad():
            pred = nearest_class(emb, class_embed)
            correct = (pred == labels).float() * weight
            # the global loss and accuracy: one all-reduce of the shares
            totals = all_reduce_(torch.stack([
                loss.detach(), torch.sum(correct), torch.sum(weight)]))
            acc = totals[1] / torch.clamp_min(totals[2], 1.0) * 100.0
        return {"loss": totals[0], "train_accuracy": acc}

    step.state = state
    return step


def eval_step(model: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """x [B, nc, T, H, W, 3] -> unit embeddings [B, 300] float32; `model`
    must be in eval mode (BN running statistics, no dropout, no autograd)."""
    with torch.inference_mode():
        return model(x)
