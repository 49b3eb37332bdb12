"""R3D-18 (Tran et al., CVPR 2018; torchvision's r3d_18) with the fork's MLP
head, keys as torchvision's under `model.`.

A (3,7,7) stem of 64 channels (stride (1,2,2)), four stages of two
BasicBlocks (64 / 128 / 256 / 512 channels, strides 1 / 2 / 2 / 2), each
conv a full 3x3x3 conv with stride (s,s,s), then BN; ReLU after the first
and after the residual add; a 1x1x1 downsample conv + BN where the shape
changes; global average pooling to 512 features, then the MLP head.

`describe` and `embed` take the conv of each stage, so that MC3-18
(mc3_18.py), the same network with (1,3,3) convs in stages 2-4, reuses
them.
"""

from __future__ import annotations

import torch

from benchmark.yardstick import arch

SIMPLE, NO_TEMPORAL = "simple", "no_temporal"
KINDS = (SIMPLE,) * 4

# the tests' clip shape on the CPU
TINY = {"clip_len": 4, "size": 32}


def _conv_shape(kind: str, s: int):
    """(kernel, stride, padding) of a block's conv of `kind` at stride s."""
    if kind == SIMPLE:
        return 3, s, 1
    return (1, 3, 3), (1, s, s), (0, 1, 1)


def describe(clip_len: int, size: int, kinds=KINDS):
    """-> (convs, epilogues, linears) on one clip of clip_len x size x
    size."""
    w = arch._Walk((clip_len, size, size))
    w.thw = w.conv("model.stem.0", 3, 64, (3, 7, 7), (1, 2, 2), (1, 3, 3))
    w.bn("model.stem.1", 64, w.thw)
    inplanes = 64
    for si, ((planes, stride), kind) in enumerate(zip(arch.STAGES, kinds)):
        for bi in range(2):
            s = stride if bi == 0 else 1
            p = f"model.layer{si + 1}.{bi}"
            x_thw = w.thw
            t = w.conv(f"{p}.conv1.0", inplanes, planes, *_conv_shape(kind, s))
            w.bn(f"{p}.conv1.1", planes, t)
            u = w.conv(f"{p}.conv2.0", planes, planes, *_conv_shape(kind, 1),
                       thw=t)
            if s != 1 or inplanes != planes:
                ds = (1, s, s) if kind == NO_TEMPORAL else s
                d = w.conv(f"{p}.downsample.0", inplanes, planes, 1, ds, 0,
                           thw=x_thw)
                w.bn(f"{p}.downsample.1", planes, d, relu=False)
            w.bn(f"{p}.conv2.1", planes, u, residual=True)
            w.thw = u
            inplanes = planes
    return w.convs, w.epilogues, arch.mlp_head(512)


def _block(net, P, p, x, quant, state):
    h = net.conv(P, f"{p}.conv1.0", x, quant)
    h = torch.relu(net.bn(P, f"{p}.conv1.1", h, state))
    h = net.conv(P, f"{p}.conv2.0", h, quant)
    res = x
    if f"{p}.downsample.0" in net.spec:
        res = net.bn(P, f"{p}.downsample.1",
                     net.conv(P, f"{p}.downsample.0", x, quant), state)
    return quant(torch.relu(net.bn(P, f"{p}.conv2.1", h, state) + res))


def embed(net, P, v, n_clips, quant, state):
    """Clips v [B * n_clips, 3, T, S, S] -> embeddings [B, 300], not yet
    normalised. The convs' shapes are the description's (net.spec)."""
    h = net.conv(P, "model.stem.0", v, quant)
    h = torch.relu(net.bn(P, "model.stem.1", h, state))
    for si in range(4):
        for bi in range(2):
            p = f"model.layer{si + 1}.{bi}"

            def run(t, p=p):
                return _block(net, P, p, t, quant, state)

            h = net.block(run, h, state)
    f = h.mean(dim=(2, 3, 4))
    return net.mlp_head(P, f.reshape(-1, n_clips, f.shape[1]).mean(dim=1))
