"""Plain PyTorch forward passes of the measured networks, in float32, over a
dict of parameters keyed as the published models' (each network's file
under benchmark/networks/ says whose keys).

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

from benchmark import harness

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
    embeddings [B, 300] from x [B, n_clips, T, S, S, 3]. The network's
    layers and its forward are benchmark/networks/<network>.py's, found
    under `root`; the pieces they share are here."""

    def __init__(self, network: str, clip_len: int, size: int,
                 root: str = harness.ROOT):
        self.clip_len, self.size = clip_len, size
        self.network = harness.load_network(root, network)
        self.convs, self.epilogues, self.linears = self.network.describe(
            clip_len, size)
        self.spec = {c.name: c for c in self.convs}

    # ------------------------------------------------------------ pieces --
    def conv(self, P, name, x, quant):
        c = self.spec[name]
        b = P.get(name + ".bias") if c.bias else None
        return quant(F.conv3d(quant(x), quant(P[name + ".weight"]), b,
                              c.stride, c.padding, 1, c.groups))

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

    @staticmethod
    def block(run, x, state):
        """run(x), recomputed in the backward under `state["remat"]`."""
        if state["remat"] and torch.is_grad_enabled():
            return ckpt.checkpoint(run, x, use_reentrant=False,
                                   preserve_rng_state=False)
        return run(x)

    @staticmethod
    def mlp_head(P, f):
        """The fork's MLP head over clip-mean features [B, F]."""
        h = torch.relu(f @ P["output2emb_proj.layers.0.weight"].t()
                       + P["output2emb_proj.layers.0.bias"])
        return (h @ P["output2emb_proj.layers.1.weight"].t()
                + P["output2emb_proj.layers.1.bias"])

    # ----------------------------------------------------------- forward --
    def forward(self, P, x, train: bool, quant=identity, synced=False,
                dropout=None, remat=False, record=None):
        """x [B, nc, T, S, S, 3] float32 -> unit embeddings [B, 300].
        `dropout`: (rate, torch.Generator) for a head with dropout in
        training; `remat`: recompute the blocks in the backward;
        `record`: a dict that receives each BN's batch (mean, var)."""
        b, nc = x.shape[0], x.shape[1]
        v = x.reshape(b * nc, *x.shape[2:]).permute(0, 4, 1, 2, 3)
        v = v.contiguous()
        state = {"train": train, "synced": synced, "record": record,
                 "remat": remat, "dropout": dropout}
        emb = self.network.embed(self, P, v, nc, quant, state)
        return emb / torch.clamp_min(
            torch.linalg.vector_norm(emb, dim=-1, keepdim=True), 1e-12)
