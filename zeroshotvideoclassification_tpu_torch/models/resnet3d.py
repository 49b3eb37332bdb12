"""Video ResNets as nn.Modules: R(2+1)D-18, R3D-18 and MC3-18.

Counterpart of zeroshotvideoclassification_tpu/models/resnet3d.py, with the
same architecture facts: the BasicBlock midplanes formula (:35-36), the
45-channel R(2+1)D stem, stages 64/128/256/512 with strides 1/2/2/2, and a
1x1x1 conv + BN downsample with stride (s, s, s), or (1, s, s) for the
no-temporal convs (:76-79, :121-127). Modules carry torchvision's names —
stem.{0,1,3,4}, layerN.B.conv1.0.{0,1,3}, conv1.1, conv2.*, downsample.{0,1}
— the keys models/porting.py reads from reference checkpoints.

Input [N, 3, T, H, W] in channels-last-3d memory; forward returns the
global-average-pooled features [N, 512] in float32 (the classifier fc is
never created, as in the JAX package).

`remat` rematerialises the blocks (not the stem), as resnet3d.py:200-252:
"full" keeps only each block's input for the backward and runs the block
again there (torch.utils.checkpoint, non-reentrant); "convs" keeps the
conv outputs and recomputes only the BN / ReLU chains between them (a
selective policy: the counterpart of save_only_these_names("conv_out")).
Either way the second forward runs inside layers.recomputing(), so the BN
running statistics move once a step. K2 keeps its tensors through
ctx.save_for_backward and needs nothing more.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Sequence

import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from zeroshotvideoclassification_tpu_torch.models import layers as L

SIMPLE, NO_TEMPORAL, TWO_PLUS_ONE = "simple", "no_temporal", "2plus1d"

_STAGES = ((64, 1), (128, 2), (256, 2), (512, 2))


def midplanes(inplanes: int, planes: int) -> int:
    return (inplanes * planes * 3 * 3 * 3) // (inplanes * 3 * 3 + 3 * planes)


def conv2plus1d(cin: int, cout: int, mid: int, stride: int = 1):
    """(1,3,3) conv -> BN -> ReLU -> (3,1,1) conv (torchvision Conv2Plus1D)."""
    return L.EpilogueSequential(
        L.conv3d(cin, mid, (1, 3, 3), (1, stride, stride), (0, 1, 1)),
        L.BatchNorm3d(mid),
        nn.ReLU(inplace=True),
        L.conv3d(mid, cout, (3, 1, 1), (stride, 1, 1), (1, 0, 0)))


def _conv(kind: str, cin: int, cout: int, mid: int, stride: int):
    if kind == TWO_PLUS_ONE:
        return conv2plus1d(cin, cout, mid, stride)
    if kind == SIMPLE:
        return L.conv3d(cin, cout, (3, 3, 3), stride, 1)
    if kind == NO_TEMPORAL:
        return L.conv3d(cin, cout, (1, 3, 3), (1, stride, stride), (0, 1, 1))
    raise ValueError(kind)


class BasicBlock(nn.Module):
    def __init__(self, kind: str, inplanes: int, planes: int, stride: int):
        super().__init__()
        mid = midplanes(inplanes, planes)
        self.conv1 = L.EpilogueSequential(
            _conv(kind, inplanes, planes, mid, stride), L.BatchNorm3d(planes),
            nn.ReLU(inplace=True))
        self.conv2 = nn.Sequential(_conv(kind, planes, planes, mid, 1),
                                   L.BatchNorm3d(planes))
        self.downsample = None
        if stride != 1 or inplanes != planes:
            ds = (1, stride, stride) if kind == NO_TEMPORAL else stride
            self.downsample = L.EpilogueSequential(
                L.conv3d(inplanes, planes, 1, ds), L.BatchNorm3d(planes))

    def forward(self, x):
        res = x if self.downsample is None else self.downsample(x)
        out = self.conv2[0](self.conv1(x))
        # relu(bn2(out) + res): the block epilogue, one K2 launch
        return self.conv2[1](out, residual=res, relu=True)


def _stem(kind: str):
    if kind == "r2plus1d":
        return L.EpilogueSequential(
            L.conv3d(3, 45, (1, 7, 7), (1, 2, 2), (0, 3, 3)),
            L.BatchNorm3d(45), nn.ReLU(inplace=True),
            L.conv3d(45, 64, (3, 1, 1), 1, (1, 0, 0)),
            L.BatchNorm3d(64), nn.ReLU(inplace=True))
    return L.EpilogueSequential(
        L.conv3d(3, 64, (3, 7, 7), (1, 2, 2), (1, 3, 3)),
        L.BatchNorm3d(64), nn.ReLU(inplace=True))


REMATS = (False, "full", "convs")
_CONV_OPS = {torch.ops.aten.convolution.default}


def _save_conv_outputs(ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _CONV_OPS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


@contextlib.contextmanager
def _recompute(inner):
    with inner, L.recomputing():
        yield


def _remat_contexts(policy: str):
    """checkpoint's context_fn: (first forward, recomputation) contexts."""
    if policy == "convs":
        first, again = ckpt.create_selective_checkpoint_contexts(
            _save_conv_outputs)
    else:
        first, again = contextlib.nullcontext(), contextlib.nullcontext()
    return first, _recompute(again)


def run_block(block: nn.Module, x, remat):
    """block(x), rematerialised by the `remat` policy (one of REMATS) while
    autograd records."""
    if remat and torch.is_grad_enabled():
        return ckpt.checkpoint(
            block, x, use_reentrant=False, preserve_rng_state=False,
            context_fn=functools.partial(_remat_contexts, remat))
    return block(x)


class VideoResNet(nn.Module):
    feature_dim = 512

    def __init__(self, conv_makers: Sequence[str], stem: str,
                 layers: Sequence[int] = (2, 2, 2, 2), remat=False):
        super().__init__()
        if remat not in REMATS:
            raise ValueError(f"remat {remat!r}: one of {REMATS}")
        self.remat = remat
        self.stem = _stem(stem)
        inplanes = 64
        for si, ((planes, stride), nblocks, kind) in enumerate(
                zip(_STAGES, layers, conv_makers)):
            blocks = []
            for bi in range(nblocks):
                blocks.append(BasicBlock(kind, inplanes, planes,
                                         stride if bi == 0 else 1))
                inplanes = planes
            self.add_module(f"layer{si + 1}", nn.Sequential(*blocks))

    def forward(self, x):
        x = self.stem(x)
        for name in ("layer1", "layer2", "layer3", "layer4"):
            for block in getattr(self, name):
                x = run_block(block, x, self.remat)
        return L.global_avgpool(x)


def r3d_18(remat=False) -> VideoResNet:
    return VideoResNet((SIMPLE,) * 4, stem="basic", remat=remat)


def mc3_18(remat=False) -> VideoResNet:
    return VideoResNet((SIMPLE,) + (NO_TEMPORAL,) * 3, stem="basic",
                       remat=remat)


def r2plus1d_18(remat=False) -> VideoResNet:
    return VideoResNet((TWO_PLUS_ONE,) * 4, stem="r2plus1d", remat=remat)
