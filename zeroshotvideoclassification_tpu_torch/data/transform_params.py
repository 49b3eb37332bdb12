"""Host-side computation of per-sample transform parameters.

The reference applies its transform chain per sample on CPU worker processes
(reference/auxiliary/transforms.py:41-56):
  uint8 -> float in [-0.5, 0]  ->  bilinear resize (short side -> 128, torch
  align_corners=False, scale-factor coordinate math)  ->  Random/Center crop
  112  ->  train-only horizontal flip (p=0.5).

Here the host only *draws the randomness and computes scalars* — resized
dims, crop offsets, flip flags — and the actual pixel work happens in one
fused device kernel (ops/resample.py). This module must replicate the exact
integer/rounding semantics of the reference so the device output is
bit-comparable to the CPU chain.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np


def short_side_for_crop(crop_size: int) -> int:
    """Resize target: 128 for the 112 crop, 256 for 224 (transforms.py:42);
    generalized to smaller debug crops (anything <= 112 keeps 128)."""
    return 128 if crop_size <= 112 else 256


def resized_dims(h: int, w: int, short_side: int) -> Tuple[int, int, float]:
    """(H', W', scale) after torch F.interpolate(scale_factor=short/min(h,w)).

    torch computes the output size as floor(dim * scale) and — crucially —
    uses the *given* scale (not H'/h) in the coordinate transform
    (verified empirically against torch 2.13; see tests/test_transforms.py).
    """
    scale = float(short_side) / min(h, w)
    return int(math.floor(h * scale)), int(math.floor(w * scale)), scale


@dataclasses.dataclass
class TransformParams:
    """Per-sample scalars consumed by ops.resample.fused_decode_transform.

    All arrays have leading batch dimension B.
    src_hw:   int32 [B, 2] actual (h, w) of the frames inside the canvas
    scale:    float32 [B]  the torch scale factor (short_side / min(h, w))
    crop_ij:  int32 [B, 2] crop top-left in resized coordinates
    flip:     bool [B]     horizontal flip (applied after crop, like the ref)
    """

    src_hw: np.ndarray
    scale: np.ndarray
    crop_ij: np.ndarray
    flip: np.ndarray

    @staticmethod
    def zeros(batch: int) -> "TransformParams":
        return TransformParams(
            src_hw=np.ones((batch, 2), np.int32),
            scale=np.ones((batch,), np.float32),
            crop_ij=np.zeros((batch, 2), np.int32),
            flip=np.zeros((batch,), bool),
        )


def make_transform_params(
    src_hw: np.ndarray,
    crop_size: int,
    is_validation: bool,
    rng: Optional[np.random.Generator] = None,
    short_side: Optional[int] = None,
) -> TransformParams:
    """Draw per-sample transform scalars for a batch.

    Parity details:
      * short side target: 128 when crop 112 else 256 (transforms.py:42)
      * RandomCrop: i ~ U{0, H'-112} INCLUSIVE (python random.randint,
        transforms.py:144-146)
      * CenterCrop: i = round((H'-112)/2) (banker's rounding via python
        round(), transforms.py:87-88)
      * flip: p = 0.5, train only (transforms.py:54-55)
    """
    src_hw = np.asarray(src_hw, dtype=np.int32)
    b = src_hw.shape[0]
    if short_side is None:
        short_side = short_side_for_crop(crop_size)
    if rng is None:
        rng = np.random.default_rng()

    scale = np.empty((b,), np.float32)
    crop_ij = np.empty((b, 2), np.int32)
    flip = np.zeros((b,), bool)
    for k in range(b):
        h, w = int(src_hw[k, 0]), int(src_hw[k, 1])
        hr, wr, s = resized_dims(h, w, short_side)
        scale[k] = s
        if is_validation:
            # python round() = banker's rounding, matching int(round(x)) of
            # the reference for the .5 cases (e.g. (129-112)/2 = 8.5 -> 8)
            crop_ij[k] = (round((hr - crop_size) / 2.0), round((wr - crop_size) / 2.0))
        else:
            crop_ij[k] = (
                rng.integers(0, max(hr - crop_size, 0) + 1),
                rng.integers(0, max(wr - crop_size, 0) + 1),
            )
            flip[k] = rng.random() < 0.5
    return TransformParams(src_hw=src_hw, scale=scale, crop_ij=crop_ij, flip=flip)


@dataclasses.dataclass
class ResampleIndices:
    """Precomputed separable gather indices + lerp weights for a batch.

    The full resize->crop->flip chain collapses into ONE bilinear gather on a
    112x112 grid, because the map output-pixel -> source-coordinate is affine
    and separable per axis. The host computes these small arrays ([B, crop])
    in float64 with torch's exact coordinate semantics; the device kernel is
    then a pure gather+lerp with zero per-sample arithmetic.
    """

    y0: np.ndarray  # int32 [B, crop]
    y1: np.ndarray  # int32 [B, crop]
    wy: np.ndarray  # float32 [B, crop]
    x0: np.ndarray  # int32 [B, crop]
    x1: np.ndarray  # int32 [B, crop]
    wx: np.ndarray  # float32 [B, crop]

    def astuple(self):
        return (self.y0, self.y1, self.wy, self.x0, self.x1, self.wx)


def _axis_indices(
    length: np.ndarray, scale: np.ndarray, crop0: np.ndarray,
    crop_size: int, reverse: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Vectorized per-axis source indices/weights, torch align_corners=False.

    torch (area_pixel_compute_source_index):
      src = (dst + 0.5) / scale - 0.5, clamped to >= 0; i0 = floor(src);
      i1 = min(i0 + 1, L - 1); weight = src - i0.
    `reverse` implements the post-crop horizontal flip (transforms.py:193-194)
    by mirroring the destination column within the crop window.
    """
    b = length.shape[0]
    dst = np.arange(crop_size, dtype=np.float32)[None, :]  # [1, crop]
    dst = np.where(reverse[:, None], np.float32(crop_size - 1) - dst, dst)
    r = crop0[:, None].astype(np.float32) + dst  # resized-space coordinate
    # torch's CPU kernel computes the source index in scalar_t=float32:
    # src = float32(1/scale) * (dst + 0.5) - 0.5 (area_pixel_compute_scale) —
    # mirror that exactly, including the float32 reciprocal.
    rscale = (1.0 / scale.astype(np.float64)).astype(np.float32)
    src = rscale[:, None] * (r + np.float32(0.5)) - np.float32(0.5)
    src = np.maximum(src, np.float32(0.0))
    i0 = np.floor(src)
    w = (src - i0).astype(np.float32)
    lim = (length[:, None] - 1).astype(np.int64)
    i0 = np.minimum(i0.astype(np.int64), lim)
    i1 = np.minimum(i0 + 1, lim)
    return i0.astype(np.int32), i1.astype(np.int32), w


def resample_indices(params: TransformParams, crop_size: int) -> ResampleIndices:
    """Lower TransformParams to the separable gather-index form."""
    h = params.src_hw[:, 0].astype(np.int64)
    w = params.src_hw[:, 1].astype(np.int64)
    scale = params.scale.astype(np.float64)
    no_rev = np.zeros(h.shape[0], dtype=bool)
    y0, y1, wy = _axis_indices(h, scale, params.crop_ij[:, 0], crop_size, no_rev)
    x0, x1, wx = _axis_indices(w, scale, params.crop_ij[:, 1], crop_size, params.flip)
    return ResampleIndices(y0=y0, y1=y1, wy=wy, x0=x0, x1=x1, wx=wx)
