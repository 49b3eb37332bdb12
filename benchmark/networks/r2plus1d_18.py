"""R(2+1)D-18 (Tran et al., CVPR 2018; torchvision's r2plus1d_18) with the
fork's MLP head, keys as torchvision's under `model.`.

A 45-channel (1,7,7) + (3,1,1) stem, four stages of two BasicBlocks (64 /
128 / 256 / 512 channels, strides 1 / 2 / 2 / 2), each conv a (1,3,3)
conv, BN, ReLU and a (3,1,1) conv with `midplanes` channels between them,
a 1x1x1 downsample conv + BN where the shape changes; global average
pooling to 512 features, then the MLP head.
"""

from __future__ import annotations

import torch

from benchmark.yardstick import arch

# the tests' clip shape on the CPU
TINY = {"clip_len": 4, "size": 32}


def describe(clip_len: int, size: int):
    """-> (convs, epilogues, linears) on one clip of clip_len x size x
    size."""
    w = arch._Walk((clip_len, size, size))
    w.thw = w.conv("model.stem.0", 3, 45, (1, 7, 7), (1, 2, 2), (0, 3, 3))
    w.bn("model.stem.1", 45, w.thw)
    w.thw = w.conv("model.stem.3", 45, 64, (3, 1, 1), 1, (1, 0, 0))
    w.bn("model.stem.4", 64, w.thw)
    inplanes = 64
    for si, (planes, stride) in enumerate(arch.STAGES):
        for bi in range(2):
            s = stride if bi == 0 else 1
            p = f"model.layer{si + 1}.{bi}"
            mid = arch.midplanes(inplanes, planes)
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
    return w.convs, w.epilogues, arch.mlp_head(512)


def _block(net, P, p, x, has_down, quant, state):
    h = net.conv(P, f"{p}.conv1.0.0", x, quant)
    h = torch.relu(net.bn(P, f"{p}.conv1.0.1", h, state))
    h = net.conv(P, f"{p}.conv1.0.3", h, quant)
    h = torch.relu(net.bn(P, f"{p}.conv1.1", h, state))
    h = net.conv(P, f"{p}.conv2.0.0", h, quant)
    h = torch.relu(net.bn(P, f"{p}.conv2.0.1", h, state))
    h = net.conv(P, f"{p}.conv2.0.3", h, quant)
    res = x
    if has_down:
        res = net.bn(P, f"{p}.downsample.1",
                     net.conv(P, f"{p}.downsample.0", x, quant), state)
    return quant(torch.relu(net.bn(P, f"{p}.conv2.1", h, state) + res))


def embed(net, P, v, n_clips, quant, state):
    """Clips v [B * n_clips, 3, T, S, S] -> embeddings [B, 300], not yet
    normalised."""
    h = net.conv(P, "model.stem.0", v, quant)
    h = torch.relu(net.bn(P, "model.stem.1", h, state))
    h = net.conv(P, "model.stem.3", h, quant)
    h = torch.relu(net.bn(P, "model.stem.4", h, state))
    for si in range(4):
        for bi in range(2):
            p = f"model.layer{si + 1}.{bi}"
            down = f"{p}.downsample.0" in net.spec

            def run(t, p=p, down=down):
                return _block(net, P, p, t, down, quant, state)

            h = net.block(run, h, state)
    f = h.mean(dim=(2, 3, 4))
    return net.mlp_head(P, f.reshape(-1, n_clips, f.shape[1]).mean(dim=1))
