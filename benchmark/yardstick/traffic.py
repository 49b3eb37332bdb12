"""The train cells' input: a pool of host batches made from the seed, which
the window cycles. Each batch is what the program's host pipeline hands
its device half: uint8 canvases holding the crop's source window of every
clip's frames, six per-sample taps of the resize -> crop -> flip chain,
target embeddings, labels and weights.

The frames are smooth moving content, as decoded video is: each clip a
seeded texture (coarse and finer detail, resized up bicubically) seen
through a window that drifts from frame to frame, with its brightness
breathing; made on the device.

The taps are the chain of the reference's training transform (short side
to 128, a random 112 crop, a flip with p = 0.5; bilinear with torch's
align_corners=False and the given scale), for frames of the sizes the
traffic names, rebased into the static canvas window (a frozen copy of the
program's data/transform_params.py and HostPipeline._assemble).
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from benchmark.yardstick.weights import subseed

EMBED_DIM = 300


def class_embeddings(n: int, seed: int) -> np.ndarray:
    """[n, 300] seeded unit vectors (the stand-in for Word2Vec class
    embeddings)."""
    rng = np.random.default_rng(subseed(seed, "classes"))
    e = rng.standard_normal((n, EMBED_DIM)).astype(np.float32)
    return e / np.linalg.norm(e, axis=1, keepdims=True)


def _axis(length, scale, crop0, crop, reverse):
    """torch align_corners=False source taps for one axis of a batch."""
    dst = np.arange(crop, dtype=np.float32)[None, :]
    dst = np.where(reverse[:, None], np.float32(crop - 1) - dst, dst)
    r = crop0[:, None].astype(np.float32) + dst
    rscale = (1.0 / scale.astype(np.float64)).astype(np.float32)
    src = np.maximum(rscale[:, None] * (r + np.float32(0.5)) - np.float32(0.5),
                     np.float32(0.0))
    i0 = np.floor(src)
    w = (src - i0).astype(np.float32)
    lim = (length[:, None] - 1).astype(np.int64)
    i0 = np.minimum(i0.astype(np.int64), lim)
    return i0, np.minimum(i0 + 1, lim), w


def train_taps(rng: np.random.Generator, b: int, crop: int, short: int,
               source_hw, window) -> Dict[str, np.ndarray]:
    """Taps of b training samples: frames of a size drawn from
    `source_hw`, rebased into a window of `window` (h, w)."""
    hw = np.asarray(source_hw, np.int64)[rng.integers(0, len(source_hw), b)]
    h, w = hw[:, 0], hw[:, 1]
    scale = short / np.minimum(h, w).astype(np.float64)
    hr, wr = np.floor(h * scale).astype(np.int64), np.floor(
        w * scale).astype(np.int64)
    ci = np.array([rng.integers(0, max(a - crop, 0) + 1) for a in hr])
    cj = np.array([rng.integers(0, max(a - crop, 0) + 1) for a in wr])
    flip = rng.random(b) < 0.5
    y0, y1, wy = _axis(h, scale, ci, crop, np.zeros(b, bool))
    x0, x1, wx = _axis(w, scale, cj, crop, flip)
    oy = np.clip(y0.min(axis=1), 0, np.maximum(h - window[0], 0))
    ox = np.clip(x0.min(axis=1), 0, np.maximum(w - window[1], 0))
    out = {"y0": y0 - oy[:, None], "y1": y1 - oy[:, None], "wy": wy,
           "x0": x0 - ox[:, None], "x1": x1 - ox[:, None], "wx": wx}
    for k in ("y0", "y1", "x0", "x1"):
        if out[k].min() < 0 or out[k].max() >= window[0 if k[0] == "y"
                                                      else 1]:
            raise ValueError(f"taps {k} leave the {window} window")
        out[k] = out[k].astype(np.int32)
    return out


def window_hw(crop: int, short: int, canvas_hw) -> tuple:
    """The static canvas window the program ships (HostPipeline's
    _window_hw)."""
    ext = int(math.ceil(crop * min(canvas_hw) / float(short))) + 2
    return min(canvas_hw[0], ext), min(canvas_hw[1], ext)


def smooth_clips(g: torch.Generator, n: int, frames: int, hw, device,
                 margin: int = 24) -> torch.Tensor:
    """[n, frames, h, w, 3] uint8 of smooth moving content."""
    import torch.nn.functional as F

    h, w = hw
    big = (h + 2 * margin, w + 2 * margin)
    coarse = torch.rand((n, 3, 8, 8), generator=g, device=device)
    fine = torch.rand((n, 3, big[0] // 12, big[1] // 12), generator=g,
                      device=device)
    tex = (0.75 * F.interpolate(coarse, size=big, mode="bicubic",
                                align_corners=False)
           + 0.25 * F.interpolate(fine, size=big, mode="bicubic",
                                  align_corners=False)) * 255.0
    motion = torch.rand((n, 7), generator=g, device=device).cpu().numpy()
    out = torch.empty((n, frames, h, w, 3), dtype=torch.uint8, device=device)
    for t in range(frames):
        gain = 0.85 + 0.15 * np.sin(6.3 * motion[:, 6] + 0.05 * t)
        for k in range(n):
            a, b, f0, f1, p0, p1 = motion[k, :6]
            dy = int(margin + (margin - 1) * a * np.sin(0.2 * f0 * t + 6.3 * p0))
            dx = int(margin + (margin - 1) * b * np.cos(0.2 * f1 * t + 6.3 * p1))
            out[k, t] = (tex[k, :, dy:dy + h, dx:dx + w] * gain[k]).clamp_(
                0, 255).permute(1, 2, 0).to(torch.uint8)
    return out


def train_pool(cfg: dict, traffic: dict, seed: int, device, rank: int = 0,
               ) -> List[Dict[str, np.ndarray]]:
    """`traffic["pool"]` host batches of `traffic["batch"]` rows for data
    shard `rank`; every row of every batch differs."""
    bs, frames = traffic["batch"], cfg["n_clips"] * cfg["clip_len"]
    crop, short = cfg["size"], traffic["short_side"]
    win = window_hw(crop, short, traffic["canvas_hw"])
    classes = traffic["classes"]
    embed = class_embeddings(classes, seed)
    g = torch.Generator(device).manual_seed(subseed(seed, f"canvas.{rank}"))
    pool = []
    for k in range(traffic["pool"]):
        rng = np.random.default_rng(subseed(seed, f"batch.{k}.{rank}"))
        canvas = smooth_clips(g, bs, frames, win, device).cpu().numpy()
        label = rng.integers(0, classes, bs).astype(np.int32)
        hb = {"canvas": canvas, "label": label, "z": embed[label].copy(),
              "weight": np.ones(bs, np.float32)}
        hb.update(train_taps(rng, bs, crop, short, traffic["source_hw"],
                             win))
        pool.append(hb)
    return pool
