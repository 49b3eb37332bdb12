"""Building blocks: conv3d, BatchNorm (batch or running statistics) with the
fused epilogue, float32 linear, pooling and dropout.

Counterpart of zeroshotvideoclassification_tpu/models/layers.py. The JAX
package keeps activations as [N, T, H, W, C] arrays; here they are
[N, C, T, H, W] tensors in channels-last-3d memory, which is the same bytes,
so cuDNN convolves them as XLA did and the BN epilogue (K2) sees a
contiguous [N, T, H, W, C] view.

  * Conv3d: weights are OIDHW (torch's layout; the bridge transposes the
    JAX package's DHWIO). With `compute_dtype` set, the float32 weight (the
    master) and the input are cast at every call, as layers.py:66-67, so
    gradients and optimizer state stay float32; a bias (C3D's) is added
    after the conv in that dtype, as layers.py:118-119.
  * BatchNorm3d: its forward is batchnorm_relu, the single entry point of
    every epilogue, like layers.py:248-287. In train mode the statistics
    are bn_statistics (layers.py:199-225: one pass, shifted by the running
    mean, in float32, through autograd, over the global batch of all
    data shards) and the running statistics move; in
    eval mode they are the running statistics. Either way the apply is K2
    (ops/bn_cuda.bn_apply_relu) with mean and var as differentiable inputs.
    Inside `recomputing()` (a rematerialised block's second forward,
    models/resnet3d.py) train mode normalises as before but leaves the
    running statistics alone: they move once a step, as the JAX package's
    functional state does under jax.checkpoint.
  * linear, global_avgpool and l2_normalize compute in float32
    (layers.py:292-336); maxpool3d is torch's MaxPool3d (padding counts as
    -inf, layers.py:301-319); dropout is layers.py:339-344.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from zeroshotvideoclassification_tpu_torch.ops.bn_cuda import bn_apply_relu
from zeroshotvideoclassification_tpu_torch.parallel.multihost import (
    all_reduce_sum,
    grid,
    group_active,
)
from zeroshotvideoclassification_tpu_torch.utils import profiler


class Conv3d(nn.Conv3d):
    """nn.Conv3d that, when `compute_dtype` is set, keeps its weight as it
    is stored (float32) and convolves a cast copy of it with the cast
    input."""

    compute_dtype: Optional[torch.dtype] = None

    def forward(self, x):
        dt = self.compute_dtype
        if dt is None or dt == self.weight.dtype:
            return super().forward(x)
        y = self._conv_forward(x.to(dt), self.weight.to(dt), None)
        return y if self.bias is None else y + self.bias.to(dt).view(
            -1, 1, 1, 1)


def conv3d(cin: int, cout: int, kernel, stride=1, padding=0,
           bias: bool = False) -> Conv3d:
    return Conv3d(cin, cout, kernel, stride=stride, padding=padding,
                  bias=bias)


_remat = threading.local()


@contextlib.contextmanager
def recomputing():
    """Marks a rematerialised forward on this thread: BatchNorm3d leaves
    its running statistics as the first forward left them."""
    before = getattr(_remat, "on", False)
    _remat.on = True
    try:
        yield
    finally:
        _remat.on = before


def bn_statistics(x: torch.Tensor, running_mean: torch.Tensor,
                  running_var: torch.Tensor, momentum: float = 0.1):
    """Batch statistics of a [..., C] tensor -> (mean, var, new_mean,
    new_var), all float32 [C]; the train half of layers.py:199-225.

    One-pass statistics of s = x - running_mean: mean = E[s] + m0 and
    var = max(E[s^2] - E[s]^2, 0) (biased; it normalises). Shifting by the
    running mean keeps E[s^2] - E[s]^2 from cancelling on activations with a
    large offset. mean and var are differentiable in x; new_mean / new_var
    are what the running statistics become ((1 - momentum) * old + momentum
    * new, with the UNBIASED variance count / (count - 1)), detached.

    Under a process group the expectations are over the GLOBAL batch, as
    the JAX package's over its sharded batch: one float32 tensor [sum s,
    sum s^2, count] a layer is summed over the data group, one process a
    data shard (parallel.multihost.all_reduce_sum, differentiable, so the
    backward sums each process's gradient of the sums; the members of a
    model group see the same rows and are not summed twice), and the
    statistics and the unbiased factor come from the global sums and
    count. Without a group
    they are the plain means of this batch: packing, slicing and dividing
    by a count tensor add autograd nodes and launches that a host-paced
    step feels.

    The forward runs in the span `bn.stats`; while a profiler records, its
    backward, from the first gradient to reach mean or var to the gradient
    of x being complete, is the bracket `bn.stats.backward`
    (utils/profiler.py)."""
    with profiler.span("bn.stats"):
        mean, var, new_mean, new_var = _statistics(x, running_mean,
                                                   running_var, momentum)
        profiler.backward_bracket("bn.stats.backward", (mean, var), x)
    return mean, var, new_mean, new_var


def _statistics(x, running_mean, running_var, momentum):
    dims = tuple(range(x.dim() - 1))
    count = float(math.prod(x.shape[:-1]))
    m0 = running_mean.detach()
    s = x - m0  # float32 by promotion: no float copy of x on its own
    if group_active():
        g = grid()
        total = count * g.n_data
        if float(np.float32(total)) != total:  # exact below 2^24, often above
            raise ValueError(f"BN over {count:.0f} x {g.n_data} "
                             f"positions: the global count is not exact in "
                             f"float32")
        c = x.shape[-1]
        sums = all_reduce_sum(torch.cat([
            s.sum(dims), torch.square(s).sum(dims), s.new_full((1,), count)]),
            g.data_group)
        s_sum, sq_sum, n = sums.split((c, c, 1))
        n = n.detach()
        s_mean, s_sq = s_sum / n, sq_sum / n
        factor = n / torch.clamp_min(n - 1.0, 1.0)
    else:
        s_mean = s.mean(dims)
        s_sq = torch.square(s).mean(dims)
        factor = count / max(count - 1.0, 1.0)
    mean = s_mean + m0
    var = torch.clamp_min(s_sq - s_mean * s_mean, 0.0)
    unbiased = var.detach() * factor
    new_mean = (1 - momentum) * m0 + momentum * mean.detach()
    new_var = (1 - momentum) * running_var.detach() + momentum * unbiased
    return mean, var, new_mean, new_var


def batchnorm_relu(x: torch.Tensor, weight, bias, running_mean, running_var,
                   residual: Optional[torch.Tensor] = None,
                   relu: bool = True, eps: float = 1e-5) -> torch.Tensor:
    """BN apply (+ residual add) (+ ReLU) on [N, C, ...] channels-last
    tensors: the block epilogue as ONE op (ops/bn_cuda.bn_apply_relu)."""
    to_last = (0, *range(2, x.dim()), 1)
    y = bn_apply_relu(
        x.permute(to_last), weight, bias, running_mean, running_var,
        None if residual is None else residual.permute(to_last), relu, eps)
    return y.permute(0, x.dim() - 1, *range(1, x.dim() - 1))


class BatchNorm3d(nn.BatchNorm3d):
    """nn.BatchNorm3d (same parameters, buffers and state_dict keys) whose
    forward is the fused epilogue; forward(x, residual, relu). Train mode
    normalises with bn_statistics of the batch and updates the running
    statistics in place, outside autograd (nn.BatchNorm3d's own two-pass
    statistics are never used)."""

    def forward(self, x, residual=None, relu=False):
        if not self.training:
            return batchnorm_relu(x, self.weight, self.bias,
                                  self.running_mean, self.running_var,
                                  residual, relu, self.eps)
        to_last = (0, *range(2, x.dim()), 1)
        mean, var, new_mean, new_var = bn_statistics(
            x.permute(to_last), self.running_mean, self.running_var,
            self.momentum)
        if not getattr(_remat, "on", False):
            with torch.no_grad():  # after bn_statistics read running_mean
                self.running_mean.copy_(new_mean)
                self.running_var.copy_(new_var)
                self.num_batches_tracked += 1
        return batchnorm_relu(x, self.weight, self.bias, mean, var, residual,
                              relu, self.eps)


class EpilogueSequential(nn.Sequential):
    """nn.Sequential whose BatchNorm3d -> ReLU pairs run as one fused
    epilogue call; the nn.ReLU entries keep torchvision's module indices
    (stem.0/1/3/4, conv1.0.{0,1,3}) and state_dict keys."""

    def forward(self, x):
        mods = list(self)
        i = 0
        while i < len(mods):
            relu = (isinstance(mods[i], BatchNorm3d) and i + 1 < len(mods)
                    and isinstance(mods[i + 1], nn.ReLU))
            x = mods[i](x, relu=True) if relu else mods[i](x)
            i += 2 if relu else 1
        return x


def linear(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    """x @ W^T + b in float32 (the product, then the bias, as JAX does)."""
    return torch.matmul(x.float(), layer.weight.t()) + layer.bias


def maxpool3d(x: torch.Tensor, window, stride, padding=0) -> torch.Tensor:
    """torch MaxPool3d on [N, C, T, H, W]: padded positions never win."""
    return F.max_pool3d(x, window, stride, padding)


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator], train: bool) -> torch.Tensor:
    """Inverted dropout as the JAX package's: keep each entry with
    probability 1 - rate (a mask drawn from `generator`, which lives on
    x's device) as x / (1 - rate), else 0, in x's dtype; the identity in
    eval mode, at rate 0 or without a generator."""
    if not train or rate == 0.0 or generator is None:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, 0.0).to(x.dtype)


def global_avgpool(x: torch.Tensor) -> torch.Tensor:
    """[N, C, T, H, W] -> [N, C] float32 (AdaptiveAvgPool3d(1) + flatten)."""
    return x.float().mean(dim=(2, 3, 4))


def l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """F.normalize(dim=-1) in float32: x / max(||x||, eps)."""
    x = x.float()
    return x / torch.clamp_min(torch.linalg.vector_norm(x, dim=-1,
                                                        keepdim=True), eps)


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded init with the JAX package's rules (layers.py:28-48): convs
    kaiming normal (fan_out, relu gain), BN scale 1 / bias 0 with running
    mean 0 / var 1, linears U(+-1/sqrt(fan_in)) for weight and bias; a
    biased conv (C3D's) takes torch's default, U(+-1/sqrt(fan_in)) for
    weight and bias (c3d.py:37-49). Parameters must be on the generator's
    device."""
    for m in module.modules():
        if isinstance(m, nn.Conv3d) and m.bias is not None:
            bound = 1.0 / math.sqrt(m.in_channels * math.prod(m.kernel_size))
            m.weight.uniform_(-bound, bound, generator=generator)
            m.bias.uniform_(-bound, bound, generator=generator)
        elif isinstance(m, nn.Conv3d):
            fan_out = m.out_channels * math.prod(m.kernel_size)
            m.weight.normal_(0.0, math.sqrt(2.0 / fan_out),
                             generator=generator)
        elif isinstance(m, nn.BatchNorm3d):
            m.weight.fill_(1.0)
            m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
            m.num_batches_tracked.zero_()
        elif isinstance(m, nn.Linear):
            bound = 1.0 / math.sqrt(m.in_features)
            m.weight.uniform_(-bound, bound, generator=generator)
            m.bias.uniform_(-bound, bound, generator=generator)
