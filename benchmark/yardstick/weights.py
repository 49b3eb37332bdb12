"""Seeded weights of a network, made on the device in a few large calls:
every conv weight from one normal draw (He init over the fan-in: a group's
input channels times the kernel), every linear from one uniform draw
(+-1/sqrt(fan-in)), the biased convs' biases from one small uniform draw,
BN scale 1 and shift 0. The benchmark hands the same dict to the program
and to the reference.

Serving also needs BN running statistics: `calibrate` takes each BN's batch
statistics of the plain reference's train-mode forward over a few seeded
clips, so that eval-mode BN normalises as a trained network's would.
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict

import torch


def subseed(seed: int, tag: str) -> int:
    """A 63-bit seed for one purpose of a run's seed (any whole number)."""
    h = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def make(net, seed: int, device) -> Dict[str, torch.Tensor]:
    """name -> float32 tensor on `device` for every parameter of `net` (a
    reference.models.Net)."""
    device = torch.device(device)
    g = torch.Generator(device).manual_seed(subseed(seed, "weights"))
    out: Dict[str, torch.Tensor] = {}
    convs = net.convs
    fans = [c.cin // c.groups * math.prod(c.kernel) for c in convs]
    sizes = [c.cout * f for c, f in zip(convs, fans)]
    flat = torch.randn(sum(sizes), generator=g, device=device)
    std = torch.tensor([math.sqrt(2.0 / f) for f in fans], device=device)
    flat.mul_(torch.repeat_interleave(
        std, torch.tensor(sizes, device=device)))
    for c, w in zip(convs, flat.split(sizes)):
        out[c.name + ".weight"] = w.view(c.cout, c.cin // c.groups,
                                         *c.kernel)
    biased = [c for c in convs if c.bias]
    if biased:
        b = torch.rand(sum(c.cout for c in biased), generator=g,
                       device=device).sub_(0.5).mul_(0.02)
        for c, v in zip(biased, b.split([c.cout for c in biased])):
            out[c.name + ".bias"] = v
    lins = net.linears
    sizes = [lin.fout * lin.fin + lin.fout for lin in lins]
    u = torch.rand(sum(sizes), generator=g, device=device).mul_(2).sub_(1)
    for lin, v in zip(lins, u.split(sizes)):
        v = v * (1.0 / math.sqrt(lin.fin))
        out[lin.name + ".weight"] = v[:lin.fout * lin.fin].view(lin.fout,
                                                                 lin.fin)
        out[lin.name + ".bias"] = v[lin.fout * lin.fin:]
    for e in net.epilogues:
        out[e.name + ".weight"] = torch.ones(e.channels, device=device)
        out[e.name + ".bias"] = torch.zeros(e.channels, device=device)
    return out


@torch.no_grad()
def calibrate(net, params, seed: int, clips: int, device) -> None:
    """Add `<bn>.running_mean` / `.running_var` to `params`: the batch
    statistics of each BN in a train-mode float32 forward of the plain
    reference over `clips` seeded clips in the transform's range."""
    if not net.epilogues:
        return
    g = torch.Generator(device).manual_seed(subseed(seed, "calibration"))
    x = torch.rand((clips, 1, net.clip_len, net.size, net.size, 3),
                   generator=g, device=device).mul_(-0.5)
    seen = {}
    net.forward(params, x, train=True, record=seen)
    for e in net.epilogues:
        mean, var = seen[e.name]
        params[e.name + ".running_mean"] = mean.clone()
        params[e.name + ".running_var"] = var.clone()
