"""Video paths -> host batch -> device batch.

The host half (decode, canvas packing, the 2-tap resample indices) is the
JAX package's zeroshotvideoclassification_tpu/data/pipeline.HostPipeline,
imported as it is; host_batch packs a list of paths with it. device_batch
is the counterpart of the JAX device_batch: the uint8 canvas crosses from
pinned memory without blocking, the transform (K1 on a GPU, its plain
version on the CPU) writes [B, nc*cl, S, S, 3] in the compute dtype, and
the result is viewed as [B, nc, cl, S, S, 3].
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from zeroshotvideoclassification_tpu.data.datasets import VideoTable
from zeroshotvideoclassification_tpu.data.pipeline import HostPipeline
from zeroshotvideoclassification_tpu_torch.ops.resample_cuda import (
    video_transform,
)

_TAPS = ("y0", "y1", "wy", "x0", "x1", "wx")


def _to_device(a, device: torch.device) -> torch.Tensor:
    t = torch.from_numpy(a)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def host_batch(paths: Sequence[str], config, bucket: int,
               class_names: Sequence[str], class_embed: np.ndarray,
               pool=None):
    """Decode + pack `paths` (loader kinds freely mixed) into ONE HostBatch
    of `bucket` rows, in validation mode (centre TSN windows, no flip);
    rows past len(paths), and videos that fail to decode, get weight 0."""
    n = len(paths)
    if not 0 < n <= bucket:
        raise ValueError(f"{n} paths for a batch of {bucket}")
    table = VideoTable(
        name="serve", fnames=np.asarray(list(paths), object),
        label_idx=np.zeros(n, np.int32), classes=list(class_names),
        class_embed=class_embed, loader="auto", is_validation=True,
        n_clips=config.n_clips)
    return next(iter(HostPipeline(table, config.replace(prefetch_depth=0),
                                  bucket, seed=0, pool=pool)))


def device_batch(host_batch, n_clips: int, clip_len: int,
                 out_dtype: torch.dtype, device) -> Dict[str, torch.Tensor]:
    """HostBatch -> {'x': [B, nc, cl, S, S, 3] out_dtype, 'z', 'label',
    'weight'} on `device`."""
    if host_batch.image_mode:
        raise NotImplementedError("the still-image (SUN) transform is not "
                                  "ported yet")
    device = torch.device(device)
    canvas = _to_device(host_batch.canvas, device)
    taps = [_to_device(getattr(host_batch, k), device) for k in _TAPS]
    x = video_transform(canvas, *taps, out_dtype=out_dtype)
    b, _, s, _, c = x.shape
    return {
        "x": x.reshape(b, n_clips, clip_len, s, s, c),
        "z": _to_device(host_batch.z, device),
        "label": _to_device(host_batch.label, device),
        "weight": _to_device(host_batch.weight, device),
    }
