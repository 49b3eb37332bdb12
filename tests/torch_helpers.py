"""Helpers shared by the PyTorch port's tests and chip_smoke.py: seeded
synthetic clips, a bf16 ulp distance, and seeded BatchNorm statistics.
Imports numpy and torch only."""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


def synthetic_clip(seed: int, frames: int, height: int,
                   width: int) -> np.ndarray:
    """uint8 [frames, height, width, 3]: a moving colour grating plus noise,
    whose colour, orientation, frequencies and noise level come from `seed`.
    Clips of different seeds differ in their global statistics, so even a
    random-weight model gives them clearly different embeddings (i.i.d.
    noise clips all pool to nearly the same one)."""
    r = np.random.default_rng(seed)
    color = r.uniform(0, 1, 3)
    fy, ft = r.uniform(0.02, 0.4, 2)
    th = r.uniform(0, np.pi)
    t = np.arange(frames)[:, None, None, None]
    y = np.arange(height)[None, :, None, None]
    x = np.arange(width)[None, None, :, None]
    g = np.sin(fy * (y * np.cos(th) + x * np.sin(th)) + 3 * ft * t)
    v = 255 * (0.5 * color + 0.35 * g * r.uniform(0.2, 1, 3))
    v = v + r.normal(0, r.uniform(2, 30), (frames, height, width, 3))
    return np.clip(v, 0, 255).astype(np.uint8)


def bf16_ulps(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest |got - want| in units of one bf16 ulp of `want` (the spacing
    of bf16 numbers at |want|; subnormals count at the smallest normal),
    computed on got's device."""
    got = got.detach().float()
    want = want.detach().float().to(got.device)
    mag = torch.clamp_min(want.abs(), 2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return float(((got - want).abs() / ulp).max()) if want.numel() else 0.0


@torch.no_grad()
def calibrate_bn(model: nn.Module, x: torch.Tensor, seed: int) -> nn.Module:
    """Give a seeded random model BN statistics like a trained one's, in
    place: a random per-channel scale U(0.05, 0.25) and bias N(0, 0.2) from
    a CPU generator seeded with `seed`, and running mean/var set to the
    per-channel mean and variance of the activations that reach each BN
    when `model` embeds `x` (one forward, layer by layer). Every epilogue
    then applies a different affine to each channel, and the embeddings of
    different clips stay apart: with identity statistics, or random ones
    that ignore the activations, a deep random network maps every clip to
    nearly the same embedding. The small scales keep each residual branch
    small beside its shortcut; with scales near 1 the normalised random
    network amplifies bf16 rounding far beyond what a trained one does."""
    g = torch.Generator().manual_seed(seed)

    def measure(bn, args):
        a = args[0].float()
        dims = (0, *range(2, a.dim()))
        bn.running_mean.copy_(a.mean(dims))
        bn.running_var.copy_(a.var(dims, unbiased=False))

    hooks = []
    for m in model.modules():
        if isinstance(m, nn.BatchNorm3d):
            c = m.num_features
            m.weight.copy_(torch.rand(c, generator=g) * 0.2 + 0.05)
            m.bias.copy_(torch.randn(c, generator=g) * 0.2)
            hooks.append(m.register_forward_pre_hook(measure))
    try:
        with torch.inference_mode():
            model(x)
    finally:
        for h in hooks:
            h.remove()
    return model


@torch.no_grad()
def copy_bn(src: nn.Module, dst: nn.Module) -> nn.Module:
    """Copy every BN's scale, bias and running statistics from `src` to
    `dst` (same architecture, any device or compute dtype)."""
    bns = [[m for m in net.modules() if isinstance(m, nn.BatchNorm3d)]
           for net in (src, dst)]
    assert len(bns[0]) == len(bns[1])
    for a, b in zip(*bns):
        for name in ("weight", "bias", "running_mean", "running_var"):
            getattr(b, name).copy_(getattr(a, name))
    return dst
