"""GIF sample dumps for debugging the input pipeline (--save_samples).

A copy of zeroshotvideoclassification_tpu/utils/gif.py, importing the port's
data/stillimages.py. imageio is imported inside batch2gif, so the port runs
without it (the trainer warns and goes on).

Parity target: the reference's auxiliary/transforms.py:59-77 (batch2gif).
Note the reference's inverse_transform still assumed the disabled mean/std
normalization (SURVEY quirk #5 — stale); this version inverts the scheme that
was actually applied.
"""

from __future__ import annotations

import numpy as np

from zeroshotvideoclassification_tpu_torch.data.stillimages import (
    KINETICS_MEAN,
    KINETICS_STD,
)


def inverse_transform(frames: np.ndarray, mode: str = "active") -> np.ndarray:
    """[T, H, W, 3] float -> uint8 frames.

    mode='active': invert the video chain (x/255 - 1)/2 (transforms.py:117).
    mode='meanstd': invert per-channel Kinetics mean/std (the SUN path /
    upstream scheme)."""
    if mode == "active":
        out = (frames * 2.0 + 1.0) * 255.0
    elif mode == "meanstd":
        out = (frames * KINETICS_STD + KINETICS_MEAN) * 255.0
    else:
        raise ValueError(mode)
    return np.clip(np.round(out), 0, 255).astype(np.uint8)


def batch2gif(frames: np.ndarray, label: int, savepath: str,
              classes=None, mode: str = "active", fps: int = 8) -> str:
    """Write one clip ([T, H, W, 3] float, model-input scale) as a GIF."""
    import imageio

    images = inverse_transform(np.asarray(frames), mode)
    name = str(classes[int(label)]) if classes is not None else ""
    path = savepath + name.replace("/", "_") + ".gif"
    # imageio >= 2.28 deprecated fps for the pillow GIF plugin
    imageio.mimsave(path, list(images), duration=1000.0 / fps)
    return path
