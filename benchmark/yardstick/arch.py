"""The measured networks' layers, from their published descriptions: every
conv and linear with its shapes, and every BN epilogue, at a given clip
shape. The FLOP count, the K2 bound and the plain reference read these
lists; none of them reads the program.

R(2+1)D-18 (Tran et al., CVPR 2018; torchvision's r2plus1d_18): a 45-channel
(1,7,7) + (3,1,1) stem, four stages of two BasicBlocks (64 / 128 / 256 /
512 channels, strides 1 / 2 / 2 / 2), each conv a (1,3,3) conv, BN, ReLU
and a (3,1,1) conv with `midplanes` channels between them, a 1x1x1
downsample conv + BN where the shape changes; global average pooling to 512
features. C3D (Tran et al., ICCV 2015): eight biased 3x3x3 convs with ReLU
and five max pools, fc6 8192 -> 4096.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

STAGES = ((64, 1), (128, 2), (256, 2), (512, 2))
EMBED_DIM = 300


@dataclasses.dataclass(frozen=True)
class Conv:
    name: str          # the weight's key without ".weight"
    cin: int
    cout: int
    kernel: Tuple[int, int, int]
    stride: Tuple[int, int, int]
    padding: Tuple[int, int, int]
    bias: bool
    out_thw: Tuple[int, int, int]


@dataclasses.dataclass(frozen=True)
class Epilogue:
    name: str          # the BN's key prefix
    channels: int
    thw: Tuple[int, int, int]
    residual: bool
    relu: bool


@dataclasses.dataclass(frozen=True)
class Linear:
    name: str
    fin: int
    fout: int


def _triple(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v, v)


def _out(thw, k, s, p):
    return tuple((n + 2 * pp - kk) // ss + 1
                 for n, kk, ss, pp in zip(thw, k, s, p))


def midplanes(inplanes: int, planes: int) -> int:
    return (inplanes * planes * 3 * 3 * 3) // (inplanes * 3 * 3 + 3 * planes)


class _Walk:
    def __init__(self, thw):
        self.thw = tuple(thw)
        self.convs: List[Conv] = []
        self.epilogues: List[Epilogue] = []

    def conv(self, name, cin, cout, k, s, p, bias=False, thw=None):
        k, s, p = _triple(k), _triple(s), _triple(p)
        out = _out(self.thw if thw is None else thw, k, s, p)
        self.convs.append(Conv(name, cin, cout, k, s, p, bias, out))
        return out

    def bn(self, name, c, thw, residual=False, relu=True):
        self.epilogues.append(Epilogue(name, c, thw, residual, relu))


def r2plus1d_18(clip_len: int, size: int):
    """-> (convs, epilogues, pooled features) of R(2+1)D-18 on one clip of
    clip_len x size x size, keys as torchvision's under `model.`."""
    w = _Walk((clip_len, size, size))
    w.thw = w.conv("model.stem.0", 3, 45, (1, 7, 7), (1, 2, 2), (0, 3, 3))
    w.bn("model.stem.1", 45, w.thw)
    w.thw = w.conv("model.stem.3", 45, 64, (3, 1, 1), 1, (1, 0, 0))
    w.bn("model.stem.4", 64, w.thw)
    inplanes = 64
    for si, (planes, stride) in enumerate(STAGES):
        for bi in range(2):
            s = stride if bi == 0 else 1
            p = f"model.layer{si + 1}.{bi}"
            mid = midplanes(inplanes, planes)
            x_thw = w.thw
            t = w.conv(f"{p}.conv1.0.0", inplanes, mid, (1, 3, 3), (1, s, s),
                       (0, 1, 1))
            w.bn(f"{p}.conv1.0.1", mid, t)
            t = w.conv(f"{p}.conv1.0.3", mid, planes, (3, 1, 1), (s, 1, 1),
                       (1, 0, 0), thw=t)
            w.bn(f"{p}.conv1.1", planes, t)
            u = w.conv(f"{p}.conv2.0.0", planes, mid, (1, 3, 3), 1, (0, 1, 1),
                       thw=t)
            w.bn(f"{p}.conv2.0.1", mid, u)
            u = w.conv(f"{p}.conv2.0.3", mid, planes, (3, 1, 1), 1, (1, 0, 0),
                       thw=u)
            if s != 1 or inplanes != planes:
                d = w.conv(f"{p}.downsample.0", inplanes, planes, 1, s, 0,
                           thw=x_thw)
                w.bn(f"{p}.downsample.1", planes, d, relu=False)
            w.bn(f"{p}.conv2.1", planes, u, residual=True)
            w.thw = u
            inplanes = planes
    return w.convs, w.epilogues, 512


C3D_CONVS = (("conv1", 3, 64), ("conv2", 64, 128), ("conv3a", 128, 256),
             ("conv3b", 256, 256), ("conv4a", 256, 512), ("conv4b", 512, 512),
             ("conv5a", 512, 512), ("conv5b", 512, 512))
# max pool after the conv: (window = stride, padding)
C3D_POOLS = {"conv1": ((1, 2, 2), (0, 0, 0)), "conv2": ((2, 2, 2), (0, 0, 0)),
             "conv3b": ((2, 2, 2), (0, 0, 0)),
             "conv4b": ((2, 2, 2), (0, 0, 0)),
             "conv5b": ((2, 2, 2), (0, 1, 1))}


def c3d(clip_len: int, size: int):
    """-> (convs, epilogues (none), fc6 input) of C3D on one clip."""
    w = _Walk((clip_len, size, size))
    for name, cin, cout in C3D_CONVS:
        w.thw = w.conv(name, cin, cout, 3, 1, 1, bias=True)
        if name in C3D_POOLS:
            win, pad = C3D_POOLS[name]
            w.thw = _out(w.thw, win, win, pad)
    flat = C3D_CONVS[-1][2] * w.thw[0] * w.thw[1] * w.thw[2]
    return w.convs, w.epilogues, flat


def network(name: str, clip_len: int, size: int):
    """-> (convs, epilogues, linears) of a configuration's network and
    head."""
    if name == "r2plus1d_18":
        convs, epis, feat = r2plus1d_18(clip_len, size)
        lins = [Linear("output2emb_proj.layers.0", feat, feat),
                Linear("output2emb_proj.layers.1", feat, EMBED_DIM)]
    elif name == "c3d":
        convs, epis, flat = c3d(clip_len, size)
        lins = [Linear("fc6", flat, 4096), Linear("regressor", 4096,
                                                  EMBED_DIM)]
    else:
        raise ValueError(f"no description of network {name!r}")
    return convs, epis, lins
