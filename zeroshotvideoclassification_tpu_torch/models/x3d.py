"""X3D-M (Feichtenhofer, X3D: Expanding Architectures for Efficient Video
Recognition, CVPR 2020, arXiv:2004.04730) as an nn.Module.

PyTorchVideo's create_x3d at depth factor 2.2, width factor 2.0,
bottleneck factor 2.25, SE ratio 1/16 and head width 2048 (its `x3d_m`):

  stem     a (1,3,3) conv 3 -> 24, stride (1,2,2), then a (5,1,1)
           channel-wise conv (groups 24), BN and ReLU;
  stages   widths 24 / 48 / 96 / 192, inner widths int(2.25 x width) =
           54 / 108 / 216 / 432, depths ceil(2.2 x (1, 2, 5, 3)) = 3 / 5 /
           11 / 7. A block: a = relu(BN(conv_a 1x1x1 (x))); b = BN(conv_b
           (a)), conv_b a 3x3x3 channel-wise conv, stride (1,2,2) in a
           stage's first block; b = SE(b) on blocks 0, 2, 4, ... of a
           stage; s = swish(b); relu(BN(conv_c 1x1x1 (s)) + shortcut), the
           shortcut of a stage's first block a 1x1x1 conv, stride (1,2,2),
           and BN;
  head     a 1x1x1 conv 192 -> 432, BN and ReLU, the global mean, then a
           bias-free 1x1x1 conv 432 -> 2048 (lin5, no BN) and ReLU: the
           features [N, 2048] float32 (feature_dim). PyTorchVideo's
           dropout and classifier are not created; the zero-shot head takes
           the features.

Modules carry PyTorchVideo's names (blocks.0.conv.conv_t is the stem's
spatial conv and conv_xy its temporal one, as there; blocks.N.res_blocks.B.
branch1_conv / branch1_norm / branch2.conv_a ... norm_c, norm_b.0 the BN and
norm_b.1.block.{0,2} the SE's convs where a block has one; blocks.5.pool.
pre_conv / pre_norm / post_conv). Its published clip is 16 x 224 x 224
(`--size 224`).

Every BN is layers.BatchNorm3d (the BN statistics' ops and K2): relu on
conv_a's, the stem's and the head's, none on conv_b's and the shortcut's,
the residual add and relu on conv_c's. Convs run in the compute dtype over
float32 masters (layers.Conv3d); the SE's convs are plain nn.Conv3d that
set_compute_dtype leaves in float32, and ops/se_swish.py applies them in
float32. Each channel-wise conv (27 a forward) runs in the span
`conv.depthwise`, with its backward bracket `conv.depthwise.backward`.

Input [N, 3, T, H, W] in channels-last-3d memory. `remat` rematerialises
the 26 blocks as VideoResNet's (resnet3d.run_block).
"""

from __future__ import annotations

import torch
from torch import nn

from zeroshotvideoclassification_tpu_torch.models import layers as L
from zeroshotvideoclassification_tpu_torch.models.resnet3d import (
    REMATS,
    run_block,
)
from zeroshotvideoclassification_tpu_torch.ops.se_swish import se_swish
from zeroshotvideoclassification_tpu_torch.utils import profiler

STEM_WIDTH = 24
WIDTHS = (24, 48, 96, 192)
DEPTHS = (3, 5, 11, 7)
BOTTLENECK = 2.25
SE_RATIO = 1.0 / 16
HEAD_INNER = 432


def round_width(width: float, multiplier: float, min_width: int = 8,
                divisor: int = 8) -> int:
    """PyTorchVideo's round_width: width x multiplier to a multiple of
    `divisor`, at least `min_width`, not under 90% of the product."""
    width *= multiplier
    out = max(min_width, int(width + divisor / 2) // divisor * divisor)
    if out < 0.9 * width:
        out += divisor
    return int(out)


def channelwise(conv: L.Conv3d, x: torch.Tensor) -> torch.Tensor:
    """conv(x) for a channel-wise conv, in the span `conv.depthwise` and
    its backward bracket. A bfloat16 x on the CPU is convolved in float32
    over the bfloat16 operands, the output rounded back: PyTorch's CPU
    bfloat16 channels-last channel-wise conv3d gives the stem's (5,1,1)
    conv a wrong weight gradient (as large as the gradient itself)."""
    with profiler.span("conv.depthwise"):
        if x.device.type == "cpu" and x.dtype == torch.bfloat16:
            y = conv._conv_forward(x.float(), conv.weight.to(x.dtype).float(),
                                   conv.bias).to(x.dtype)
        else:
            y = conv(x)
        profiler.backward_bracket("conv.depthwise.backward", (y,), x)
    return y


class _Pair(nn.Module):
    """PyTorchVideo's Conv2plus1d of the stem: conv_t (the spatial conv,
    first) and conv_xy (the temporal channel-wise one)."""

    def __init__(self, width: int):
        super().__init__()
        self.conv_t = L.conv3d(3, width, (1, 3, 3), (1, 2, 2), (0, 1, 1))
        self.conv_xy = L.conv3d(width, width, (5, 1, 1), 1, (2, 0, 0),
                                groups=width)


class Stem(nn.Module):
    def __init__(self, width: int = STEM_WIDTH):
        super().__init__()
        self.conv = _Pair(width)
        self.norm = L.BatchNorm3d(width)

    def forward(self, x):
        h = channelwise(self.conv.conv_xy, self.conv.conv_t(x))
        return self.norm(h, relu=True)


class SqueezeExcitation(nn.Module):
    """The SE's two biased 1x1x1 convs under fvcore's names (block.0,
    block.2); ops/se_swish.py applies them."""

    def __init__(self, channels: int, reduced: int):
        super().__init__()
        self.block = nn.Sequential(
            nn.Conv3d(channels, reduced, 1, bias=True), nn.ReLU(),
            nn.Conv3d(reduced, channels, 1, bias=True), nn.Sigmoid())


class Bottleneck(nn.Module):
    """PyTorchVideo's X3D BottleneckBlock: the branch2 of a block."""

    def __init__(self, cin: int, inner: int, cout: int, stride: int,
                 se: bool):
        super().__init__()
        self.conv_a = L.conv3d(cin, inner, 1)
        self.norm_a = L.BatchNorm3d(inner)
        self.conv_b = L.conv3d(inner, inner, 3, (1, stride, stride), 1,
                               groups=inner)
        self.norm_b = (nn.Sequential(
            L.BatchNorm3d(inner),
            SqueezeExcitation(inner, round_width(inner, SE_RATIO)))
            if se else L.BatchNorm3d(inner))
        self.conv_c = L.conv3d(inner, cout, 1)
        self.norm_c = L.BatchNorm3d(cout)

    def forward(self, x, shortcut):
        h = self.norm_a(self.conv_a(x), relu=True)
        h = channelwise(self.conv_b, h)
        if isinstance(self.norm_b, nn.Sequential):
            bn, se = self.norm_b
            h = se_swish(bn(h), se.block[0], se.block[2])
        else:
            h = se_swish(self.norm_b(h))
        # relu(BN(conv_c) + shortcut): one K2 launch
        return self.norm_c(self.conv_c(h), residual=shortcut, relu=True)


class Block(nn.Module):
    """PyTorchVideo's ResBlock: branch2 plus the shortcut, a 1x1x1 conv
    and BN (branch1_conv, branch1_norm) where the shape changes."""

    def __init__(self, cin: int, inner: int, cout: int, stride: int,
                 se: bool):
        super().__init__()
        self.branch1_conv = self.branch1_norm = None
        if cin != cout or stride != 1:
            self.branch1_conv = L.conv3d(cin, cout, 1, (1, stride, stride))
            self.branch1_norm = L.BatchNorm3d(cout)
        self.branch2 = Bottleneck(cin, inner, cout, stride, se)

    def forward(self, x):
        res = x
        if self.branch1_conv is not None:
            res = self.branch1_norm(self.branch1_conv(x))
        return self.branch2(x, res)


class Stage(nn.Module):
    def __init__(self, cin: int, cout: int, depth: int):
        super().__init__()
        inner = int(BOTTLENECK * cout)
        self.res_blocks = nn.ModuleList(
            Block(cin if i == 0 else cout, inner, cout, 2 if i == 0 else 1,
                  se=i % 2 == 0) for i in range(depth))


class ProjectedPool(nn.Module):
    """The head's pre_conv + BN + ReLU, global mean, post_conv (lin5) +
    ReLU."""

    def __init__(self, cin: int, inner: int, features: int):
        super().__init__()
        self.pre_conv = L.conv3d(cin, inner, 1)
        self.pre_norm = L.BatchNorm3d(inner)
        self.post_conv = L.conv3d(inner, features, 1)

    def forward(self, x):
        h = self.pre_norm(self.pre_conv(x), relu=True)
        # the float32 mean, back in the activations' dtype for lin5
        f = L.global_avgpool(h).to(h.dtype)
        f = self.post_conv(f[:, :, None, None, None])
        return torch.relu(f).flatten(1).float()


class Head(nn.Module):
    def __init__(self, cin: int, inner: int, features: int):
        super().__init__()
        self.pool = ProjectedPool(cin, inner, features)


class X3D(nn.Module):
    feature_dim = 2048

    def __init__(self, remat=False):
        super().__init__()
        if remat not in REMATS:
            raise ValueError(f"remat {remat!r}: one of {REMATS}")
        self.remat = remat
        stages, cin = [], STEM_WIDTH
        for cout, depth in zip(WIDTHS, DEPTHS):
            stages.append(Stage(cin, cout, depth))
            cin = cout
        self.blocks = nn.ModuleList(
            [Stem(), *stages, Head(cin, HEAD_INNER, self.feature_dim)])

    def forward(self, x):
        x = self.blocks[0](x)
        for stage in self.blocks[1:-1]:
            for block in stage.res_blocks:
                x = run_block(block, x, self.remat)
        return self.blocks[-1].pool(x)


def x3d_m(remat=False) -> X3D:
    return X3D(remat=remat)
