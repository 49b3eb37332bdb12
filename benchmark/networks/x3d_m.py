"""X3D-M (Feichtenhofer, CVPR 2020, arXiv:2004.04730; PyTorchVideo's
create_x3d at depth factor 2.2, width factor 2.0, bottleneck factor 2.25,
SE ratio 1/16, head width 2048) with the fork's MLP head, keys as
PyTorchVideo's under `model.`.

A stem of a (1,3,3) conv 3 -> 24 (stride (1,2,2)) and a (5,1,1)
channel-wise conv, BN, ReLU; four stages of 3 / 5 / 11 / 7 blocks, widths
24 / 48 / 96 / 192, inner widths 54 / 108 / 216 / 432. A block: 1x1x1 conv,
BN, ReLU; a 3x3x3 channel-wise conv (stride (1,2,2) in a stage's first
block), BN; on blocks 0, 2, 4, ... squeeze-and-excitation (the mean over
T, H, W, two biased 1x1x1 convs to round_width(inner / 16) = 8 / 8 / 16 /
32 and back, ReLU between, a sigmoid gate); Swish; 1x1x1 conv, BN, the
shortcut (a stage's first block: a strided 1x1x1 conv and BN) and ReLU.
The head: 1x1x1 conv 192 -> 432, BN, ReLU, the global mean, a bias-free
1x1x1 conv 432 -> 2048 (lin5) and ReLU, then the MLP head 2048 -> 2048 ->
300. The SE's convs and lin5 act on a [N, C, 1, 1, 1] map.
"""

from __future__ import annotations

import torch

from benchmark.yardstick import arch

WIDTHS = (24, 48, 96, 192)
DEPTHS = (3, 5, 11, 7)
HEAD_INNER, FEATURES = 432, 2048

# the tests' clip shape on the CPU
TINY = {"clip_len": 4, "size": 32}


def se_width(inner: int) -> int:
    """PyTorchVideo's round_width(inner, 1/16): to a multiple of 8, at
    least 8, not under 90% of inner / 16."""
    w = inner / 16
    out = max(8, int(w + 4) // 8 * 8)
    return out + 8 if out < 0.9 * w else out


def describe(clip_len: int, size: int):
    """-> (convs, epilogues, linears) on one clip of clip_len x size x
    size."""
    w = arch._Walk((clip_len, size, size))
    w.thw = w.conv("model.blocks.0.conv.conv_t", 3, 24, (1, 3, 3),
                   (1, 2, 2), (0, 1, 1))
    w.thw = w.conv("model.blocks.0.conv.conv_xy", 24, 24, (5, 1, 1), 1,
                   (2, 0, 0), groups=24)
    w.bn("model.blocks.0.norm", 24, w.thw)
    cin = 24
    for si, (cout, depth) in enumerate(zip(WIDTHS, DEPTHS)):
        inner = int(2.25 * cout)
        for bi in range(depth):
            p = f"model.blocks.{si + 1}.res_blocks.{bi}"
            s = 2 if bi == 0 else 1
            x_thw = w.thw
            t = w.conv(f"{p}.branch2.conv_a", cin, inner, 1, 1, 0)
            w.bn(f"{p}.branch2.norm_a", inner, t)
            t = w.conv(f"{p}.branch2.conv_b", inner, inner, 3, (1, s, s), 1,
                       thw=t, groups=inner)
            if bi % 2 == 0:
                w.bn(f"{p}.branch2.norm_b.0", inner, t, relu=False)
                r = se_width(inner)
                w.conv(f"{p}.branch2.norm_b.1.block.0", inner, r, 1, 1, 0,
                       bias=True, thw=(1, 1, 1))
                w.conv(f"{p}.branch2.norm_b.1.block.2", r, inner, 1, 1, 0,
                       bias=True, thw=(1, 1, 1))
            else:
                w.bn(f"{p}.branch2.norm_b", inner, t, relu=False)
            t = w.conv(f"{p}.branch2.conv_c", inner, cout, 1, 1, 0, thw=t)
            if bi == 0:
                d = w.conv(f"{p}.branch1_conv", cin, cout, 1, (1, s, s), 0,
                           thw=x_thw)
                w.bn(f"{p}.branch1_norm", cout, d, relu=False)
            w.bn(f"{p}.branch2.norm_c", cout, t, residual=True)
            w.thw = t
            cin = cout
    p = "model.blocks.5.pool"
    t = w.conv(f"{p}.pre_conv", cin, HEAD_INNER, 1, 1, 0)
    w.bn(f"{p}.pre_norm", HEAD_INNER, t)
    w.conv(f"{p}.post_conv", HEAD_INNER, FEATURES, 1, 1, 0, thw=(1, 1, 1))
    return w.convs, w.epilogues, arch.mlp_head(FEATURES)


def _se(P, name, b):
    """b x sigmoid(W2 relu(W1 mean(b) + b1) + b2), in float32 (the program
    computes the gate in float32)."""
    m = b.mean(dim=(2, 3, 4))
    w1, w2 = P[name + ".block.0.weight"], P[name + ".block.2.weight"]
    h = torch.relu(m @ w1.flatten(1).t() + P[name + ".block.0.bias"])
    g = torch.sigmoid(h @ w2.flatten(1).t() + P[name + ".block.2.bias"])
    return b * g[:, :, None, None, None]


def _block(net, P, p, x, first, se, quant, state):
    h = net.conv(P, f"{p}.branch2.conv_a", x, quant)
    h = torch.relu(net.bn(P, f"{p}.branch2.norm_a", h, state))
    h = net.conv(P, f"{p}.branch2.conv_b", h, quant)
    if se:
        h = _se(P, f"{p}.branch2.norm_b.1",
                net.bn(P, f"{p}.branch2.norm_b.0", h, state))
    else:
        h = net.bn(P, f"{p}.branch2.norm_b", h, state)
    h = quant(h * torch.sigmoid(h))  # Swish, held in the compute dtype
    h = net.conv(P, f"{p}.branch2.conv_c", h, quant)
    res = x
    if first:
        res = net.bn(P, f"{p}.branch1_norm",
                     net.conv(P, f"{p}.branch1_conv", x, quant), state)
    return quant(torch.relu(net.bn(P, f"{p}.branch2.norm_c", h, state)
                            + res))


def embed(net, P, v, n_clips, quant, state):
    """Clips v [B * n_clips, 3, T, S, S] -> embeddings [B, 300], not yet
    normalised."""
    h = net.conv(P, "model.blocks.0.conv.conv_t", v, quant)
    h = net.conv(P, "model.blocks.0.conv.conv_xy", h, quant)
    h = torch.relu(net.bn(P, "model.blocks.0.norm", h, state))
    for si, depth in enumerate(DEPTHS):
        for bi in range(depth):
            p = f"model.blocks.{si + 1}.res_blocks.{bi}"

            def run(t, p=p, first=bi == 0, se=bi % 2 == 0):
                return _block(net, P, p, t, first, se, quant, state)

            h = net.block(run, h, state)
    p = "model.blocks.5.pool"
    h = net.conv(P, f"{p}.pre_conv", h, quant)
    h = torch.relu(net.bn(P, f"{p}.pre_norm", h, state))
    f = h.mean(dim=(2, 3, 4))[:, :, None, None, None]
    f = torch.relu(net.conv(P, f"{p}.post_conv", f, quant)).flatten(1)
    return net.mlp_head(P, f.reshape(-1, n_clips, f.shape[1]).mean(dim=1))
