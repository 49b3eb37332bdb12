"""Adam + MultiStepLR, matching the reference's optimizer setup, with the
non-finite step guard.

Counterpart of zeroshotvideoclassification_tpu/train/optimizer.py:
  Adam(lr) with torch defaults (b1=0.9, b2=0.999, eps=1e-8) on the float32
  parameters; MultiStepLR milestones [60, 120] gamma 0.1 when lr == 1e-3,
  else [int(0.8 * n_epochs)]. bf16 compute needs no loss scaling, so there
  is no GradScaler; its inf/NaN step-skip is the guard below.

The guard (optimizer.py:42-93): if any gradient holds a non-finite entry the
step leaves the parameters, both moments and the step count untouched and
counts the skip. It is decided on the device and never read on the host: the
flag is one reduction over all gradients, and the update is written so that
the flag, as a 0/1 factor, switches every change off. So a training step
makes no host synchronisation, and the host can queue the next step while
the device still runs this one. (torch.optim.Adam's own step keeps its step
counts on the host and cannot be switched off from the device; GuardedAdam
keeps Adam's hyper-parameters, param_groups and state keys and replaces only
step().)

Under --tp the processes of a model group each hold a shard of the head's
gradients, so each sees only its shards' entries: the flag is agreed over
the model group (parallel.multihost.agree_finite, a MIN all-reduce), so
that a non-finite entry in one shard skips the step on every member (did
they decide apart, their states would part for good). last_finite, which
--debug_nans reads, is the agreed flag.

The update can be captured into a CUDA graph (train/step.py's
make_scan_train_step): the learning rate enters it as one float32 device
tensor a parameter group, which `set_lr` (and every step outside a capture)
fills in place from the group's `lr`, so a replay reads the rate of its
epoch; and a capture raises where a parameter with a gradient has no
moments yet, which the capture would record as a zero-fill that every
replay repeated.
"""

from __future__ import annotations

from typing import Callable

import torch

from zeroshotvideoclassification_tpu_torch.parallel.multihost import (
    agree_finite,
)


def multistep_lr(base_lr: float, n_epochs: int) -> Callable[[int], float]:
    """epoch -> lr, reference milestone logic (reference/main.py:132-135)."""
    if base_lr == 1e-3:
        milestones = (60, 120)
    else:
        milestones = (int(0.8 * n_epochs),)

    def lr_at(epoch: int) -> float:
        lr = base_lr
        for m in milestones:
            if epoch >= m:
                lr *= 0.1
        return lr

    return lr_at


class GuardedAdam(torch.optim.Adam):
    """torch.optim.Adam(betas=(0.9, 0.999), eps=1e-8) whose step() skips
    itself, on the device, when a gradient is not finite.

    State per parameter as torch.optim.Adam: `exp_avg`, `exp_avg_sq` and
    `step`; every `step` entry is the one device counter `self.count`
    (int64; all parameters step together). Bookkeeping as optax.ApplyIfFiniteState:
    `notfinite_count` (consecutive skips), `total_notfinite`, `last_finite`,
    all device tensors."""

    def __init__(self, params, lr: float = 1e-3):
        super().__init__(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
        dev = self.param_groups[0]["params"][0].device
        self.count = torch.zeros((), dtype=torch.int64, device=dev)
        self.notfinite_count = torch.zeros((), dtype=torch.int32, device=dev)
        self.total_notfinite = torch.zeros((), dtype=torch.int32, device=dev)
        self.last_finite = torch.ones((), dtype=torch.bool, device=dev)
        # each group's lr as the update reads it, and the value it holds
        self.lr_tensors = [torch.full((), float(g["lr"]), dtype=torch.float32,
                                      device=dev) for g in self.param_groups]
        self._lr_held = [float(g["lr"]) for g in self.param_groups]

    def sync_lr(self) -> None:
        """Fill each group's lr tensor in place from its `lr` where that
        changed (an eager fill on the current stream; never inside a
        capture, which would record the value it held then)."""
        for i, group in enumerate(self.param_groups):
            lr = float(group["lr"])
            if lr != self._lr_held[i]:
                self.lr_tensors[i].fill_(lr)
                self._lr_held[i] = lr

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("GuardedAdam.step takes no closure")
        groups = []
        for group, lr in zip(self.param_groups, self.lr_tensors):
            ps = [p for p in group["params"] if p.grad is not None]
            if ps:
                groups.append((group, lr, ps, [p.grad for p in ps]))
        if not groups:
            return None
        capturing = (self.count.is_cuda
                     and torch.cuda.is_current_stream_capturing())
        if not capturing:
            self.sync_lr()
        # max |g| of every gradient: NaN and inf both survive it, and it
        # cannot overflow on a large finite gradient as a sum of squares can
        norms = torch._foreach_norm([g for *_, gs in groups for g in gs],
                                    float("inf"))
        finite = agree_finite(torch.isfinite(torch.stack(norms)).all())
        keep = finite.to(torch.float32)
        skip = (~finite).to(torch.int32)
        self.notfinite_count.add_(1).mul_(skip)
        self.total_notfinite.add_(skip)
        self.last_finite.copy_(finite)
        self.count.add_(finite.to(torch.int64))
        t = torch.clamp_min(self.count, 1)  # a skipped first step: no 0/0
        zero = torch.zeros((), dtype=torch.float32, device=keep.device)
        for group, lr, ps, gs in groups:
            b1, b2 = group["betas"]
            ms, vs = [], []
            for p in ps:
                st = self.state[p]
                if not st:
                    if capturing:
                        raise RuntimeError(
                            "GuardedAdam: a parameter without moments in a "
                            "CUDA graph capture; take one eager step first")
                    st["step"] = self.count
                    st["exp_avg"] = torch.zeros_like(p)
                    st["exp_avg_sq"] = torch.zeros_like(p)
                ms.append(st["exp_avg"])
                vs.append(st["exp_avg_sq"])
            # a skipped step sees zero gradients, and `keep` = 0 then also
            # switches off the decay of the moments and the update
            gs = [torch.where(finite, g, zero) for g in gs]
            d = torch._foreach_sub(gs, ms)          # m += (1 - b1)(g - m)
            torch._foreach_mul_(d, keep * (1.0 - b1))
            torch._foreach_add_(ms, d)
            d = torch._foreach_mul(gs, gs)          # v += (1 - b2)(g^2 - v)
            torch._foreach_sub_(d, vs)
            torch._foreach_mul_(d, keep * (1.0 - b2))
            torch._foreach_add_(vs, d)
            # p -= lr / (1 - b1^t) * m / (sqrt(v) / sqrt(1 - b2^t) + eps)
            d = torch._foreach_sqrt(vs)
            torch._foreach_mul_(d, torch.rsqrt(1.0 - b2 ** t))
            torch._foreach_add_(d, group["eps"])
            torch._foreach_reciprocal_(d)
            torch._foreach_mul_(d, ms)
            torch._foreach_mul_(d, keep * lr / (1.0 - b1 ** t))
            torch._foreach_sub_(ps, d)
        return None


def make_optimizer(params, lr: float = 1e-3) -> GuardedAdam:
    """Adam on `params` (the model's float32 parameters) with a learning
    rate the trainer sets per epoch from multistep_lr (set_lr), mirroring
    scheduler.step() (reference/main.py:374)."""
    return GuardedAdam([p for p in params if p.requires_grad], lr=lr)


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Set the learning rate of every parameter group (and, for the guarded
    Adam, fill the device tensors its update reads, in place)."""
    for group in optimizer.param_groups:
        group["lr"] = float(lr)
    if isinstance(optimizer, GuardedAdam):
        optimizer.sync_lr()
