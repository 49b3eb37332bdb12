"""SUN397 still-image -> fake-video pretraining path (host side).

Parity target: reference/auxiliary/auxiliary_stillimages.py:31-144.
A still image is inflated into an n_clips*clip_len video by sampling a random
zoom/pan trajectory of square crop boxes and resizing each to crop_size
(the paper's 'synthetic camera motion'). Host responsibilities here:
  * load + bound the image (min side into [172, 512]; channel fixes)
  * draw the trajectory: random (start, end) boxes + side lengths,
    np.linspace interpolation, .astype(int) — exact reference integer math
  * emit per-frame bilinear gather indices for the device kernel
    (ops.resample.fused_image_motion_transform)

Crop resize parity: with Config.sun_antialias (default) the device kernel
reproduces PIL's antialiased bilinear — the reference's torchvision Resize on
PIL crops (auxiliary_stillimages.py:56-62,130-134) — via
ops.resample.fused_image_motion_transform_aa (taps derived on device from the
integer trajectory; oracle-tested against PIL and torch antialias=True).
--no-sun_antialias restores the plain 2-tap half-pixel bilinear.
Remaining documented divergence (pretraining-only path): the HOST image
bound uses cv2 bilinear where the reference used skimage anti_aliasing
resize. Per-channel Kinetics mean/std normalization is kept (quirk #5: the
SUN path normalizes differently from the video path).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

# torchvision Kinetics stats (auxiliary_stillimages.py:52-53)
KINETICS_MEAN = np.array([0.43216, 0.394666, 0.37645], np.float32)
KINETICS_STD = np.array([0.22803, 0.22145, 0.216989], np.float32)

# per-channel affine for the device kernel: out = (v/255 - mean) / std
CH_SCALE = (1.0 / (255.0 * KINETICS_STD)).astype(np.float32)
CH_OFFSET = (-KINETICS_MEAN / KINETICS_STD).astype(np.float32)


def load_and_bound_image(path: str) -> Optional[np.ndarray]:
    """imread + min-side bound into [172, 512] + channel fixes -> RGB uint8.

    Parity: auxiliary_stillimages.py:73-113 (integer-scale upscaling for small
    images, float-scale downscaling for large ones, grayscale/2ch/RGBA fixes).
    """
    try:
        import cv2

        img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        if img is None:
            return None
        if img.ndim == 3 and img.shape[2] >= 3:
            img = cv2.cvtColor(img[:, :, :3], cv2.COLOR_BGR2RGB)
    except Exception:
        return None
    if img.size == 0:
        return None

    m = min(img.shape[:2])
    if m < 172:
        scale = int(172.0 / m)  # integer scale, reference :95
        new = (scale * img.shape[0], scale * img.shape[1])
        img = _resize_u8(img, new)
    elif m > 512:
        scale = 512.0 / m
        new = (int(scale * img.shape[0]), int(scale * img.shape[1]))
        img = _resize_u8(img, new)

    if img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 1):
        img = np.repeat(img.reshape(img.shape[0], img.shape[1], 1), 3, 2)
    if img.shape[2] == 2:
        img = np.stack([img[:, :, 0], img[:, :, 1], img[:, :, 1]], 2)
    # (no 4-channel branch: RGBA was already truncated to 3 at imread above —
    # the reference needed one because its skimage path had no earlier fix)
    return np.ascontiguousarray(img)


def _resize_u8(img: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    import cv2

    return cv2.resize(img, (hw[1], hw[0]), interpolation=cv2.INTER_LINEAR)


def camera_motion_trajectory(
    img_hw: Tuple[int, int],
    crop_size: int,
    n_steps: int,
    rng: np.random.Generator,
) -> np.ndarray:
    """-> int trajectory [n_steps, 3] of (y, x, side).

    Parity: auxiliary_stillimages.py:114-127 — start/end boxes drawn
    uniformly, side lengths in [crop, fitting-bound), linspace interpolated
    then truncated to int."""
    s = img_hw
    start = [int(rng.integers(0, max(s[i] - crop_size, 1))) for i in range(2)]
    start_side = int(rng.integers(
        crop_size, max(min(s[0] - start[0], s[1] - start[1]), crop_size + 1)))
    end = [int(rng.integers(0, max(s[i] - crop_size, 1))) for i in range(2)]
    end_side = int(rng.integers(
        crop_size, max(min(s[0] - end[0], s[1] - end[1]), crop_size + 1)))
    trajectory = [
        np.linspace(start[0], end[0], n_steps).astype(int),
        np.linspace(start[1], end[1], n_steps).astype(int),
        np.linspace(start_side, end_side, n_steps).astype(int),
    ]
    return np.stack(trajectory).T


def motion_resample_indices(
    trajectory: np.ndarray,  # [T, 3] (y, x, side)
    img_hw: Tuple[int, int],
    crop_size: int,
):
    """Per-frame separable gather indices for crop(side)->resize(crop_size).

    The resize maps output pixel d to source coordinate
    y + (d + 0.5) * extent / crop_size - 0.5 (half-pixel bilinear with the
    out/in size ratio: the crop target is an explicit (112, 112) size).

    `extent` is the box side CLAMPED to the image per axis: the reference
    slices img[y:y+side, x:x+side] with numpy (which truncates at the
    border) and Resize((112,112))-STRETCHES whatever survived
    (auxiliary_stillimages.py:132-134) — reachable when the bound image's
    min side is in [87, 111] (the integer-scale quirk in
    load_and_bound_image keeps those unscaled, so side=112 boxes overhang).
    Sampling each axis over its clamped extent reproduces that stretch;
    boxes that fit (extent == side, the overwhelmingly common case) are
    untouched."""
    dst = np.arange(crop_size, dtype=np.float64)[None, :]  # [1, S]
    side = trajectory[:, 2].astype(np.float64)

    def axis(origin, limit):
        ext = np.minimum(side, limit - origin.astype(np.float64))  # [T]
        ratio = ext[:, None] / float(crop_size)
        src_rel = np.maximum((dst + 0.5) * ratio - 0.5, 0.0)  # [T, S]
        src_rel = np.minimum(src_rel, ext[:, None] - 1.0)
        src = origin[:, None].astype(np.float64) + src_rel
        i0 = np.floor(src)
        w = (src - i0).astype(np.float32)
        lim = limit - 1
        i0 = np.minimum(i0.astype(np.int64), lim).astype(np.int32)
        i1 = np.minimum(i0 + 1, lim).astype(np.int32)
        return i0, i1, w

    y0, y1, wy = axis(trajectory[:, 0], img_hw[0])
    x0, x1, wx = axis(trajectory[:, 1], img_hw[1])
    return y0, y1, wy, x0, x1, wx
