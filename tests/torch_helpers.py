"""Helpers shared by the PyTorch port's tests and chip_smoke.py: seeded
synthetic clips, random BN statistics for JAX trees, a bf16 ulp distance,
float64 sums of the BN statistics, seeded BatchNorm statistics, seeded C3D
weights that carry the input, a seeded Adam state, and the removal of a
test's large files. Imports numpy and torch only."""

from __future__ import annotations

import pathlib

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


def randomize_bn(params, state, rng):
    """Random BN scale/bias and running mean/var in the JAX package's
    (params, model_state) trees of numpy arrays, in place."""
    for k, v in params.items():
        if not isinstance(v, dict):
            continue
        if set(v) == {"scale", "bias"}:
            c = v["scale"].shape[0]
            v["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
            v["bias"] = rng.normal(0, 0.2, c).astype(np.float32)
            state[k]["mean"] = rng.normal(0, 0.2, c).astype(np.float32)
            state[k]["var"] = rng.uniform(0.5, 2.0, c).astype(np.float32)
        elif k in state:
            randomize_bn(v, state[k], rng)


def bf16_ulps(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest |got - want| in units of one bf16 ulp of `want` (the spacing
    of bf16 numbers at |want|; subnormals count at the smallest normal),
    computed on got's device."""
    got = got.detach().float()
    want = want.detach().float().to(got.device)
    mag = torch.clamp_min(want.abs(), 2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return float(((got - want).abs() / ulp).max()) if want.numel() else 0.0


def bn_sums_ref64(x: torch.Tensor, m0: torch.Tensor,
                  chunk: int = 2 ** 20) -> torch.Tensor:
    """float64 [3, C]: the sums of s = x - m0, of s^2 and of |s| over every
    row of a [..., C] tensor, taken over chunks of rows (the BN statistics'
    sums held to float64, ops/bn_stats.py)."""
    c = x.shape[-1]
    flat = x.reshape(-1, c)
    ref = torch.zeros(3, c, dtype=torch.float64, device=x.device)
    for i in range(0, flat.shape[0], chunk):
        d = flat[i:i + chunk].double() - m0.double()
        ref += torch.stack([d.sum(0), (d * d).sum(0), d.abs().sum(0)])
    return ref


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


@torch.no_grad()
def calibrate_c3d(model: nn.Module, seed: int) -> nn.Module:
    """Give a C3D (models/c3d.C3D, or a ZeroShotModel holding one) seeded
    weights under which the features depend on the clip, in place: conv
    and fc6 weights N(0, 2 / fan_in) (He's), biases N(0, 0.01), from a CPU
    generator seeded with `seed`. Under torch's default init (U(+-1 /
    sqrt(fan_in)), which init_weights gives C3D) a conv + ReLU keeps about
    a sixth of its input's second moment and adds its bias: after eight
    layers the biases alone set the features, every clip gets nearly the
    same embedding, and a comparison would hold nothing of the convs."""
    g = torch.Generator().manual_seed(seed)
    layers = [m for m in model.modules()
              if isinstance(m, nn.Conv3d) and m.bias is not None]
    layers.append(model.fc6)
    for m in layers:
        fan_in = m.weight[0].numel()
        m.weight.copy_(torch.randn(m.weight.shape, generator=g)
                       * (2.0 / fan_in) ** 0.5)
        m.bias.copy_(torch.randn(m.bias.shape, generator=g) * 0.01)
    return model


@torch.no_grad()
def seed_adam(optimizer, model: nn.Module, seed: int, count: int = 1000):
    """Give `optimizer` (train/optimizer.GuardedAdam over `model`'s
    parameters) the state of a run well under way, from a CPU generator
    seeded with `seed`: first moments 3e-3 N(0, 1), second moments 1e-3
    U(0.5, 2), step count `count`. From zero moments Adam's first updates are
    lr * g / |g|, so two runs whose gradients differ only in float32
    summation order land up to 2 * lr apart wherever a gradient entry is
    near zero; from this state such noise moves a weight by < 1e-6 while the
    update itself moves it by ~1e-4. A model whose mlp head holds one
    shard of --tp (ZeroShotModel.tp) gets that shard of the whole head's
    moments: the same draws as the whole model's."""
    from zeroshotvideoclassification_tpu_torch.models import bridge

    g = torch.Generator().manual_seed(seed)
    optimizer.count.fill_(int(count))
    tp, index = getattr(model, "tp", (1, 0))
    for key, p in model.named_parameters():
        shape = list(p.shape)
        if key in bridge.TP_AXES:
            shape[bridge.TP_AXES[key]] *= tp
        m = 3e-3 * torch.randn(shape, generator=g)
        v = 1e-3 * (torch.rand(shape, generator=g) * 1.5 + 0.5)
        st = optimizer.state[p]
        st["step"] = optimizer.count
        for slot, t in (("exp_avg", m), ("exp_avg_sq", v)):
            st[slot] = bridge.shard_head({key: t}, tp, index)[key].to(
                p.device)
    return optimizer


LARGE_FILE_BYTES = 1 << 20


def remove_large_files(root) -> None:
    """Delete every file of LARGE_FILE_BYTES or more under `root` (a test's
    temporary directory), at any depth. The port's tests write full-width
    checkpoints and tensor files of 100-750 MB; pytest keeps the temporary
    directories of its last three runs, so left in place they would add up
    to about 9 GB a whole tier-1 run and fill a small disk within two or
    three runs, and the tests that write late in a run would then fail on
    ENOSPC."""
    for path in pathlib.Path(root).rglob("*"):
        if (path.is_file() and not path.is_symlink()
                and path.stat().st_size >= LARGE_FILE_BYTES):
            path.unlink()
