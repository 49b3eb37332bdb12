"""Plain PyTorch forward passes of the measured networks, in float32, over a
dict of parameters keyed as the published models' (torchvision's
r2plus1d_18 under `model.`, the fork's MLP head, C3D's c3d.pickle names).

No kernel, no cache, no batching of the program: conv3d, a two-pass batch
norm, ReLU, pooling and linears as the papers describe them. `quant` wraps
every conv's input, weight and output and every block's output, the
tensors the program holds in its compute dtype (the identity for the
float32 reference; the lower-precision control rounds them). Under a process group the batch
statistics are those of the global batch (sums all-reduced, with the
all-reduce's gradient in the backward), as a synchronised BN computes them.
This module imports nothing of the program.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils import checkpoint as ckpt

from benchmark.yardstick import arch

BN_EPS = 1e-5


def identity(t):
    return t


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        x = x.clone()
        dist.all_reduce(x)
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g)
        return g


def _global_sum(t, synced: bool):
    return _AllReduceSum.apply(t) if synced else t


def batch_norm(x, weight, bias, synced=False, eps=BN_EPS):
    """Train-mode BN of [N, C, T, H, W] with the batch's biased statistics,
    two passes (mean, then the mean square of the deviation)."""
    dims = (0, 2, 3, 4)
    count = float(x.numel() // x.shape[1])
    if synced:
        count *= dist.get_world_size()
    mean = _global_sum(x.sum(dims), synced) / count
    d = x - mean.view(1, -1, 1, 1, 1)
    var = _global_sum((d * d).sum(dims), synced) / count
    scale = torch.rsqrt(var + eps) * weight
    return d * scale.view(1, -1, 1, 1, 1) + bias.view(1, -1, 1, 1, 1)


def batch_norm_eval(x, weight, bias, mean, var, eps=BN_EPS):
    scale = torch.rsqrt(var + eps) * weight
    return ((x - mean.view(1, -1, 1, 1, 1)) * scale.view(1, -1, 1, 1, 1)
            + bias.view(1, -1, 1, 1, 1))


class Net:
    """One network at one clip shape: forward(params, x, ...) -> unit
    embeddings [B, 300] from x [B, n_clips, T, S, S, 3]."""

    def __init__(self, network: str, clip_len: int, size: int):
        self.name = network
        self.clip_len, self.size = clip_len, size
        self.convs, self.epilogues, self.linears = arch.network(
            network, clip_len, size)
        self.spec = {c.name: c for c in self.convs}

    # ------------------------------------------------------------ pieces --
    def conv(self, P, name, x, quant):
        c = self.spec[name]
        b = P.get(name + ".bias") if c.bias else None
        return quant(F.conv3d(quant(x), quant(P[name + ".weight"]), b,
                              c.stride, c.padding))

    def bn(self, P, name, x, state):
        if state.get("record") is not None:
            state["record"][name] = (x.mean(dim=(0, 2, 3, 4)),
                                     x.var(dim=(0, 2, 3, 4), unbiased=False))
        if state["train"]:
            return batch_norm(x, P[name + ".weight"], P[name + ".bias"],
                              state["synced"])
        return batch_norm_eval(x, P[name + ".weight"], P[name + ".bias"],
                               P[name + ".running_mean"],
                               P[name + ".running_var"])

    def block(self, P, p, x, has_down, quant, state):
        h = self.conv(P, f"{p}.conv1.0.0", x, quant)
        h = torch.relu(self.bn(P, f"{p}.conv1.0.1", h, state))
        h = self.conv(P, f"{p}.conv1.0.3", h, quant)
        h = torch.relu(self.bn(P, f"{p}.conv1.1", h, state))
        h = self.conv(P, f"{p}.conv2.0.0", h, quant)
        h = torch.relu(self.bn(P, f"{p}.conv2.0.1", h, state))
        h = self.conv(P, f"{p}.conv2.0.3", h, quant)
        res = x
        if has_down:
            res = self.bn(P, f"{p}.downsample.1",
                          self.conv(P, f"{p}.downsample.0", x, quant), state)
        return quant(torch.relu(self.bn(P, f"{p}.conv2.1", h, state) + res))

    def r2plus1d_features(self, P, x, quant, state, remat):
        h = self.conv(P, "model.stem.0", x, quant)
        h = torch.relu(self.bn(P, "model.stem.1", h, state))
        h = self.conv(P, "model.stem.3", h, quant)
        h = torch.relu(self.bn(P, "model.stem.4", h, state))
        for si in range(4):
            for bi in range(2):
                p = f"model.layer{si + 1}.{bi}"
                down = f"{p}.downsample.0" in self.spec

                def run(t, p=p, down=down):
                    return self.block(P, p, t, down, quant, state)

                if remat and torch.is_grad_enabled():
                    h = ckpt.checkpoint(run, h, use_reentrant=False,
                                        preserve_rng_state=False)
                else:
                    h = run(h)
        return h.mean(dim=(2, 3, 4))

    def c3d_features(self, P, x, quant):
        h = x
        for name, _, _ in arch.C3D_CONVS:
            h = torch.relu(self.conv(P, name, h, quant))
            if name in arch.C3D_POOLS:
                win, pad = arch.C3D_POOLS[name]
                h = F.max_pool3d(h, win, win, pad)
        flat = h.reshape(h.shape[0], -1)  # NCDHW order, as c3d.pickle's fc6
        return torch.relu(flat @ P["fc6.weight"].t() + P["fc6.bias"])

    # ----------------------------------------------------------- forward --
    def forward(self, P, x, train: bool, quant=identity, synced=False,
                dropout=None, remat=False, record=None):
        """x [B, nc, T, S, S, 3] float32 -> unit embeddings [B, 300].
        `dropout`: (rate, torch.Generator) for C3D's head in training;
        `record`: a dict that receives each BN's batch (mean, var)."""
        b, nc = x.shape[0], x.shape[1]
        v = x.reshape(b * nc, *x.shape[2:]).permute(0, 4, 1, 2, 3)
        v = v.contiguous()
        state = {"train": train, "synced": synced, "record": record}
        if self.name == "c3d":
            f = self.c3d_features(P, v, quant)
            if train and dropout is not None and dropout[0] > 0:
                rate, gen = dropout
                keep = 1.0 - rate
                mask = torch.rand(f.shape, generator=gen,
                                  device=f.device) < keep
                f = torch.where(mask, f / keep, 0.0)
            f = f.reshape(b, nc, -1).mean(dim=1)
            emb = f @ P["regressor.weight"].t() + P["regressor.bias"]
        else:
            f = self.r2plus1d_features(P, v, quant, state, remat)
            f = f.reshape(b, nc, -1).mean(dim=1)
            h = torch.relu(f @ P["output2emb_proj.layers.0.weight"].t()
                           + P["output2emb_proj.layers.0.bias"])
            emb = (h @ P["output2emb_proj.layers.1.weight"].t()
                   + P["output2emb_proj.layers.1.bias"])
        return emb / torch.clamp_min(
            torch.linalg.vector_norm(emb, dim=-1, keepdim=True), 1e-12)
