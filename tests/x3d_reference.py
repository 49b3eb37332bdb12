"""A plain float32 X3D-M with the fork's MLP head, to hold the port's
models/x3d.py to: F.conv3d with groups, a two-pass batch norm, sigmoids,
written from the equations of the X3D paper (Feichtenhofer, CVPR 2020,
arXiv:2004.04730) and PyTorchVideo's create_x3d at X3D-M's factors, over a
dict of tensors keyed as the port's state_dict (PyTorchVideo's module names
under `model.`, the head under `output2emb_proj.layers.{0,1}`).

It imports torch alone: nothing of the port and nothing of JAX.

  stem    (1,3,3) conv 3 -> 24, stride (1,2,2), pad (0,1,1); (5,1,1)
          channel-wise conv, pad (2,0,0); BN; ReLU
  block   a = relu(BN(conv_a x)); b = BN(conv_b a), conv_b 3x3x3
          channel-wise, pad 1, stride (1,2,2) in a stage's first block;
          on blocks 0, 2, 4, ... b = b * sigmoid(W2 relu(W1 mean(b) + b1) +
          b2); s = b * sigmoid(b); relu(BN(conv_c s) + shortcut), the
          shortcut of a stage's first block BN(1x1x1 conv, stride (1,2,2))
  stages  widths 24 / 48 / 96 / 192, inner 54 / 108 / 216 / 432, depths
          3 / 5 / 11 / 7, SE widths 8 / 8 / 16 / 32
  head    relu(BN(1x1x1 conv 192 -> 432)), the mean over T, H, W, relu(lin5
          432 -> 2048, no bias); then clip mean, relu(fc1), fc2, unit norm

Departures from PyTorchVideo's x3d_m, as the port departs: no dropout and
no classifier (the fork's MLP head 2048 -> 2048 -> 300 and the L2 norm
instead); the mean over the whole map where PyTorchVideo pools with a
fixed (T, H / 32, W / 32) window (the same at its 16 x 224 x 224 clip);
weights as the caller gives them (PyTorchVideo zero-initialises norm_c's
scale). Train-mode BN normalises with the batch's biased variance and moves
the running statistics by momentum 0.1 with the unbiased one, eps 1e-5, as
torch's BatchNorm3d.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

EPS = 1e-5
MOMENTUM = 0.1
WIDTHS = (24, 48, 96, 192)
DEPTHS = (3, 5, 11, 7)
SE_WIDTHS = (8, 8, 16, 32)


def _v(t):
    return t.view(1, -1, 1, 1, 1)


def conv(P, name, x, stride=1, padding=0):
    """F.conv3d with the weight `name`; groups from the weight's shape."""
    w = P[name + ".weight"]
    return F.conv3d(x, w, P.get(name + ".bias"), stride, padding, 1,
                    x.shape[1] // w.shape[1])


def batch_norm(P, name, x, train, stats):
    """Two-pass BN of [N, C, T, H, W]; in train mode `stats[name]` gets
    the running statistics' next values (detached)."""
    w, b = P[name + ".weight"], P[name + ".bias"]
    if not train:
        mean, var = P[name + ".running_mean"], P[name + ".running_var"]
        return (x - _v(mean)) * _v(torch.rsqrt(var + EPS) * w) + _v(b)
    n = x.numel() // x.shape[1]
    mean = x.sum(dim=(0, 2, 3, 4)) / n
    d = x - _v(mean)
    var = (d * d).sum(dim=(0, 2, 3, 4)) / n
    stats[name] = (
        (1 - MOMENTUM) * P[name + ".running_mean"] + MOMENTUM * mean.detach(),
        (1 - MOMENTUM) * P[name + ".running_var"]
        + MOMENTUM * var.detach() * n / (n - 1))
    return d * _v(torch.rsqrt(var + EPS) * w) + _v(b)


def squeeze_excite(P, name, b):
    """b * sigmoid(W2 relu(W1 mean(b) + b1) + b2), the convs of `name`'s
    block.0 and block.2 as the matrices they are."""
    m = b.mean(dim=(2, 3, 4))
    w1, w2 = P[name + ".block.0.weight"], P[name + ".block.2.weight"]
    h = torch.relu(m @ w1.flatten(1).t() + P[name + ".block.0.bias"])
    g = torch.sigmoid(h @ w2.flatten(1).t() + P[name + ".block.2.bias"])
    return b * g[:, :, None, None, None]


def block(P, p, x, first, se, train, stats):
    s = (1, 2, 2) if first else 1
    a = torch.relu(batch_norm(P, f"{p}.branch2.norm_a",
                              conv(P, f"{p}.branch2.conv_a", x), train,
                              stats))
    b = conv(P, f"{p}.branch2.conv_b", a, s, 1)
    if se:
        b = batch_norm(P, f"{p}.branch2.norm_b.0", b, train, stats)
        b = squeeze_excite(P, f"{p}.branch2.norm_b.1", b)
    else:
        b = batch_norm(P, f"{p}.branch2.norm_b", b, train, stats)
    c = conv(P, f"{p}.branch2.conv_c", b * torch.sigmoid(b))
    res = x
    if first:
        res = batch_norm(P, f"{p}.branch1_norm",
                         conv(P, f"{p}.branch1_conv", x, s), train, stats)
    return torch.relu(batch_norm(P, f"{p}.branch2.norm_c", c, train, stats)
                      + res)


def backbone(P, v, train, stats):
    """Clips [N, 3, T, S, S] -> features [N, 2048]."""
    h = conv(P, "model.blocks.0.conv.conv_t", v, (1, 2, 2), (0, 1, 1))
    h = conv(P, "model.blocks.0.conv.conv_xy", h, 1, (2, 0, 0))
    h = torch.relu(batch_norm(P, "model.blocks.0.norm", h, train, stats))
    for si, depth in enumerate(DEPTHS):
        for bi in range(depth):
            h = block(P, f"model.blocks.{si + 1}.res_blocks.{bi}", h,
                      bi == 0, bi % 2 == 0, train, stats)
    p = "model.blocks.5.pool"
    h = torch.relu(batch_norm(P, f"{p}.pre_norm",
                              conv(P, f"{p}.pre_conv", h), train, stats))
    f = h.mean(dim=(2, 3, 4))[:, :, None, None, None]
    return torch.relu(conv(P, f"{p}.post_conv", f)).flatten(1)


def forward(P, x, train, stats=None):
    """x [B, nc, T, S, S, 3] as the port's model takes it -> unit
    embeddings [B, 300]; in train mode `stats` (a dict) receives every
    BN's next running statistics."""
    stats = {} if stats is None else stats
    b, nc = x.shape[0], x.shape[1]
    v = x.reshape(b * nc, *x.shape[2:]).permute(0, 4, 1, 2, 3)
    f = backbone(P, v, train, stats)
    f = f.reshape(b, nc, -1).mean(dim=1)
    h = torch.relu(f @ P["output2emb_proj.layers.0.weight"].t()
                   + P["output2emb_proj.layers.0.bias"])
    emb = (h @ P["output2emb_proj.layers.1.weight"].t()
           + P["output2emb_proj.layers.1.bias"])
    return emb / torch.clamp_min(
        torch.linalg.vector_norm(emb, dim=-1, keepdim=True), 1e-12)


def loss(emb, z, weight):
    """The masked MSE: the weighted mean over samples of each one's mean
    squared error, over max(sum of weights, 1)."""
    per = torch.mean(torch.square(emb - z), dim=-1)
    return torch.sum(per * weight) / torch.clamp_min(torch.sum(weight), 1.0)
