"""C3D (Tran et al., ICCV 2015) with the port's C3D head, keys as
c3d.pickle's: eight biased 3x3x3 convs with ReLU and five max pools, fc6
8192 -> 4096 with ReLU, dropout on each clip's fc6 in training, the mean
over clips, then `regressor` 4096 -> 300.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.yardstick import arch

CONVS = (("conv1", 3, 64), ("conv2", 64, 128), ("conv3a", 128, 256),
         ("conv3b", 256, 256), ("conv4a", 256, 512), ("conv4b", 512, 512),
         ("conv5a", 512, 512), ("conv5b", 512, 512))
# max pool after the conv: (window = stride, padding)
POOLS = {"conv1": ((1, 2, 2), (0, 0, 0)), "conv2": ((2, 2, 2), (0, 0, 0)),
         "conv3b": ((2, 2, 2), (0, 0, 0)), "conv4b": ((2, 2, 2), (0, 0, 0)),
         "conv5b": ((2, 2, 2), (0, 1, 1))}

# the tests' clip shape on the CPU: the published one (the last pool needs
# 16 frames)
TINY = {"clip_len": 16, "size": 112}


def describe(clip_len: int, size: int):
    """-> (convs, epilogues (none), linears) on one clip of clip_len x
    size x size."""
    w = arch._Walk((clip_len, size, size))
    for name, cin, cout in CONVS:
        w.thw = w.conv(name, cin, cout, 3, 1, 1, bias=True)
        if name in POOLS:
            win, pad = POOLS[name]
            w.thw = arch._out(w.thw, win, win, pad)
    flat = CONVS[-1][2] * w.thw[0] * w.thw[1] * w.thw[2]
    return w.convs, w.epilogues, [arch.Linear("fc6", flat, 4096),
                                  arch.Linear("regressor", 4096,
                                              arch.EMBED_DIM)]


def embed(net, P, v, n_clips, quant, state):
    """Clips v [B * n_clips, 3, T, S, S] -> embeddings [B, 300], not yet
    normalised; state["dropout"]: (rate, torch.Generator) in training."""
    h = v
    for name, _, _ in CONVS:
        h = torch.relu(net.conv(P, name, h, quant))
        if name in POOLS:
            win, pad = POOLS[name]
            h = F.max_pool3d(h, win, win, pad)
    flat = h.reshape(h.shape[0], -1)  # NCDHW order, as c3d.pickle's fc6
    f = torch.relu(flat @ P["fc6.weight"].t() + P["fc6.bias"])
    dropout = state["dropout"]
    if state["train"] and dropout is not None and dropout[0] > 0:
        rate, gen = dropout
        keep = 1.0 - rate
        mask = torch.rand(f.shape, generator=gen, device=f.device) < keep
        f = torch.where(mask, f / keep, 0.0)
    f = f.reshape(-1, n_clips, f.shape[1]).mean(dim=1)
    return f @ P["regressor.weight"].t() + P["regressor.bias"]
