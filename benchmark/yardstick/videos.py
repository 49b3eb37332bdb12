"""The serve cell's videos: JPEG frame directories (`<video>/images/
img_%05d.jpg`, the reference's active loader) made from the seed, with
smooth moving content: a seeded smooth texture (coarse and finer detail
resized up with cubic interpolation) seen through a window that drifts
and whose brightness breathes, so that the JPEGs compress as camera video
does rather than as noise. One task a video on a thread pool (cv2 releases
the interpreter lock while it encodes).
"""

from __future__ import annotations

import concurrent.futures as cf
import os
from typing import List

import numpy as np

from benchmark.yardstick.weights import subseed


def _video(path: str, n: int, hw, quality: int, rng) -> int:
    import cv2

    h, w = hw
    margin = 96
    th, tw = h + 2 * margin, w + 2 * margin
    coarse = rng.integers(0, 256, (6, 8, 3)).astype(np.uint8)
    fine = rng.integers(0, 256, (th // 12, tw // 12, 3)).astype(np.uint8)
    tex = (0.75 * cv2.resize(coarse, (tw, th), interpolation=cv2.INTER_CUBIC)
           + 0.25 * cv2.resize(fine, (tw, th),
                               interpolation=cv2.INTER_CUBIC))
    amp = rng.uniform(20, margin - 2, 2)
    freq = rng.uniform(0.01, 0.05, 3)
    phase = rng.uniform(0, 2 * np.pi, 3)
    images = os.path.join(path, "images")
    os.makedirs(images)
    total = 0
    for t in range(n):
        dy = int(margin + amp[0] * np.sin(freq[0] * t + phase[0]))
        dx = int(margin + amp[1] * np.cos(freq[1] * t + phase[1]))
        gain = 0.85 + 0.15 * np.sin(freq[2] * t + phase[2])
        frame = np.clip(tex[dy:dy + h, dx:dx + w] * gain, 0, 255)
        ok, buf = cv2.imencode(".jpg", frame.astype(np.uint8),
                               [cv2.IMWRITE_JPEG_QUALITY, quality])
        if not ok:
            raise RuntimeError(f"cv2 could not encode frame {t} of {path}")
        with open(os.path.join(images, "img_%05d.jpg" % (t + 1)), "wb") as f:
            f.write(buf.tobytes())
        total += len(buf)
    return total


def make(root: str, count: int, frames, hw, quality: int, seed: int,
         threads: int):
    """`count` videos under `root` whose frame counts are spread evenly
    over [frames[0], frames[1]], in an order drawn from the seed (every
    seed makes the same sizes). -> (paths, frame counts, mean bytes a
    frame)."""
    rng = np.random.default_rng(subseed(seed, "videos"))
    counts = rng.permutation(np.round(np.linspace(
        frames[0], frames[1], count)).astype(np.int64))
    seeds = rng.integers(0, 2 ** 63 - 1, count)
    paths: List[str] = [os.path.join(root, f"v{i:03d}") for i in
                        range(count)]
    with cf.ThreadPoolExecutor(max_workers=threads) as pool:
        sizes = list(pool.map(
            lambda a: _video(a[0], int(a[1]), hw, quality,
                             np.random.default_rng(int(a[2]))),
            zip(paths, counts, seeds)))
    return paths, [int(c) for c in counts], sum(sizes) / float(counts.sum())
