"""Building blocks: conv3d, eval-mode BatchNorm with the fused epilogue,
float32 linear and pooling.

Counterpart of zeroshotvideoclassification_tpu/models/layers.py. The JAX
package keeps activations as [N, T, H, W, C] arrays; here they are
[N, C, T, H, W] tensors in channels-last-3d memory, which is the same bytes,
so cuDNN convolves them as XLA did and the BN epilogue (K2) sees a
contiguous [N, T, H, W, C] view.

  * conv3d: bias-free nn.Conv3d; weights are OIDHW (torch's layout; the
    bridge transposes the JAX package's DHWIO).
  * BatchNorm3d: eval mode only. Its forward is batchnorm_relu, the single
    entry point of every epilogue, like layers.py:248-287. Train-mode
    statistics (layers.py:199-225) are not ported yet: in train mode it
    raises.
  * linear, global_avgpool and l2_normalize compute in float32
    (layers.py:292-336).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from zeroshotvideoclassification_tpu_torch.ops.bn_cuda import bn_apply_relu


def conv3d(cin: int, cout: int, kernel, stride=1, padding=0) -> nn.Conv3d:
    return nn.Conv3d(cin, cout, kernel, stride=stride, padding=padding,
                     bias=False)


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
    eval-mode forward is the fused epilogue; forward(x, residual, relu)."""

    def forward(self, x, residual=None, relu=False):
        if self.training:
            raise NotImplementedError(
                "train-mode BatchNorm statistics are not ported yet; call "
                ".eval() for inference")
        return batchnorm_relu(x, self.weight, self.bias, self.running_mean,
                              self.running_var, residual, relu, self.eps)


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
    mean 0 / var 1, linears U(+-1/sqrt(fan_in)) for weight and bias.
    Parameters must be on the generator's device."""
    for m in module.modules():
        if isinstance(m, nn.Conv3d):
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
