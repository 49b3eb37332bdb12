"""Host input pipeline: decode -> canvas packing -> transform params, then
host batch -> device batch.

The host half (HostBatch, HostPipeline and their helpers) is a copy of
zeroshotvideoclassification_tpu/data/pipeline.py:1-404, numpy only: a
thread-pool decode stage feeding static-shape host batches

  {canvas  uint8 [B, nc*cl, Hc, Wc, 3],     # frames packed top-left
   y0/y1/wy/x0/x1/wx  [B, S],               # fused-transform gather indices
   z [B, 300], label [B] int32, weight [B] float32}

All randomness (TSN starts, crop, flip) is drawn host-side per sample with
numpy, so both packages pack byte-identical batches from the same seed.
Broken/missing samples get weight 0 (the reference's label==-1 convention,
auxiliary_dataset.py:502-505) — batch shapes never change. The last partial
batch is zero-weight-padded (reference uses drop_last=False, dataset.py:28).
Oversize sources (frames larger than the canvas) are host-pre-resized to the
target short side first — a documented double-resample for rare inputs; the
common UCF/HMDB/Kinetics frame sizes take the exact one-resample path.

host_batch packs a list of paths into one batch with it. device_batch is
the counterpart of the JAX device_batch: the uint8 canvas crosses from
pinned memory without blocking, the transform (K1 on a GPU, its plain
version on the CPU) writes [B, nc*cl, S, S, 3] in the compute dtype, and
the result is viewed as [B, nc, cl, S, S, 3]. A still-image batch (SUN)
carries one image per sample and goes to the antialiased transform when it
ships a trajectory (Config.sun_antialias, the default), else to the 2-tap
image-motion transform (K4 on a GPU, its plain version on the CPU).
"""


from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import math
from typing import Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from zeroshotvideoclassification_tpu_torch.data.datasets import VideoTable
from zeroshotvideoclassification_tpu_torch.data.decode import DECODERS
from zeroshotvideoclassification_tpu_torch.data.transform_params import (
    ResampleIndices,
    make_transform_params,
    resample_indices,
)
from zeroshotvideoclassification_tpu_torch.ops.resample import (
    fused_image_motion_transform_aa,
)
from zeroshotvideoclassification_tpu_torch.ops.resample_cuda import (
    image_motion_transform,
    video_transform,
)


def _fit_to_canvas(frames: np.ndarray, canvas_hw, short_side: int) -> np.ndarray:
    """Pre-shrink frames that exceed the canvas (keeps aspect; cv2 bilinear)."""
    t, h, w, _ = frames.shape
    ch, cw = canvas_hw
    if h <= ch and w <= cw:
        return frames
    import cv2

    scale = min(1.0, ch / h, cw / w)
    # never shrink below the resize target's short side
    scale = max(scale, min(1.0, float(short_side) / min(h, w)))
    nh, nw = int(h * scale), int(w * scale)
    if (nh, nw) != (h, w):
        out = np.empty((t, nh, nw, 3), np.uint8)
        for i in range(t):
            out[i] = cv2.resize(frames[i], (nw, nh),
                                interpolation=cv2.INTER_LINEAR)
    else:
        out = frames
    # The short-side floor can push the long side past the canvas for extreme
    # aspect ratios (> ~2.67:1 at the 256x342 default). Center-crop the
    # overflow instead of clamping each dimension independently (which
    # squeezed the frame): aspect is preserved, and the discarded margin is
    # content the downstream 112-crop window would almost never sample.
    if nh > ch:
        top = (nh - ch) // 2
        out = out[:, top:top + ch]
    if nw > cw:
        left = (nw - cw) // 2
        out = out[:, :, left:left + cw]
    return out


@dataclasses.dataclass
class HostBatch:
    canvas: np.ndarray
    y0: np.ndarray
    y1: np.ndarray
    wy: np.ndarray
    x0: np.ndarray
    x1: np.ndarray
    wx: np.ndarray
    z: np.ndarray
    label: np.ndarray
    weight: np.ndarray
    image_mode: bool = False  # SUN path: canvas [B,Hc,Wc,3], indices [B,T,S]
    # Antialiased SUN path (Config.sun_antialias): instead of host-built
    # 2-tap gather indices, ship the raw integer trajectory + true image
    # sizes (~100 bytes/sample) and let the device kernel derive PIL-exact
    # triangle-filter taps (ops.resample.fused_image_motion_transform_aa).
    trajectory: Optional[np.ndarray] = None  # int32 [B, T, 3] (y, x, side)
    img_hw: Optional[np.ndarray] = None      # int32 [B, 2]
    crop_size: int = 112                     # output S (AA kernel static arg)

    def resample_args(self):
        return (self.canvas, self.y0, self.y1, self.wy, self.x0, self.x1, self.wx)


class HostPipeline:
    """Iterable over HostBatch for one VideoTable."""

    def __init__(
        self,
        table: VideoTable,
        config,
        batch_size: int,
        seed: int = 0,
        workers: Optional[int] = None,
        synthetic_source=None,
        pool: Optional[cf.Executor] = None,
    ):
        # `pool`: an external decode executor to reuse across pipelines.
        # Iterating otherwise creates (and tears down) a fresh
        # ThreadPoolExecutor per epoch — fine for training's long epochs,
        # but a serving engine building one single-batch pipeline per
        # request would pay ~cpu_count thread spawns per micro-batch
        # (serve/engine.py passes its persistent pool).
        self.table = table
        self.config = config
        self.bs = batch_size
        self.seed = seed
        self.epoch = 0
        from zeroshotvideoclassification_tpu_torch.data.transform_params import (
            short_side_for_crop,
        )

        self.crop = config.size
        self.short_side = short_side_for_crop(config.size)
        self.canvas_hw = tuple(config.canvas_hw)
        import os as _os
        self.workers = workers if workers is not None else (
            config.decode_workers or (_os.cpu_count() or 1))
        self._pool = pool
        self._source = synthetic_source
        if table.loader == "synthetic" and self._source is None:
            from zeroshotvideoclassification_tpu_torch.data.synthetic import (
                SyntheticVideoSource,
            )
            self._source = SyntheticVideoSource()

    def __len__(self) -> int:
        return (len(self.table) + self.bs - 1) // self.bs

    # -------------------------------------------------------------- decode --
    def _decode_one(self, i: int, rng: np.random.Generator):
        t = self.table
        if int(t.label_idx[i]) < 0:
            # multi-host lockstep padding row (parallel.multihost.shard_table)
            # -> weight-0 sample, no decode
            return None
        nc, cl = t.n_clips, self.config.clip_len
        if t.loader == "synthetic":
            cid, sidx = t.fnames[i]
            frames, ok = self._source.decode(
                int(cid), int(sidx), cl, nc, t.is_validation, rng)
        elif t.loader == "image":
            from zeroshotvideoclassification_tpu_torch.data.stillimages import (
                load_and_bound_image,
            )
            img = load_and_bound_image(str(t.fnames[i]))
            if img is None:
                return None
            return self._fit_image(img)
        else:
            kw = {}
            if (t.loader in ("frame_dir", "auto")
                    and getattr(self.config, "decode_scale", 1) > 1):
                # opt-in DCT-scaled decode (Config.decode_scale): the device
                # transform adapts to whatever size arrives (per-sample
                # src_hw), so only the decode/H2D cost changes
                kw = dict(scale_cap=int(self.config.decode_scale),
                          min_short_side=self.short_side)
            frames, ok = DECODERS[t.loader](
                str(t.fnames[i]), cl, nc, t.is_validation, rng, **kw)
        if not ok or frames is None:
            return None
        return _fit_to_canvas(frames, self.canvas_hw, self.short_side)

    def _fit_image(self, img: np.ndarray) -> np.ndarray:
        """Shrink a bounded SUN image to the canvas if needed (only its min
        side is bounded by the reference; panoramas can exceed the canvas)."""
        h, w = img.shape[:2]
        ch, cw = self.canvas_hw
        if h <= ch and w <= cw:
            return img
        import cv2

        scale = min(ch / h, cw / w)
        nh, nw = max(int(h * scale), self.crop + 1), max(int(w * scale), self.crop + 1)
        return cv2.resize(img, (min(nw, cw), min(nh, ch)),
                          interpolation=cv2.INTER_LINEAR)

    # --------------------------------------------------------------- batch --
    def _window_hw(self):
        """Static (H, W) of the H2D canvas window.

        The device gather references only the crop's source footprint:
        per axis at most ceil(crop / scale) + 2 source rows, and scale =
        short_side / min(h, w) >= short_side / min(canvas_hw) because frames
        are pre-fit to the canvas. Shipping a per-sample window of this
        STATIC worst-case size (offset = the sample's first referenced row,
        pure uint8 indexing) cuts the dead H2D bytes — e.g. 226x342 instead
        of 256x342 rows x 226/342 cols at the default shapes, a ~42% byte
        cut — without changing any device shape across batches."""
        ch, cw = self.canvas_hw
        max_rscale = min(ch, cw) / float(self.short_side)
        ext = int(math.ceil(self.crop * max_rscale)) + 2
        return min(ch, ext), min(cw, ext)

    def _assemble(self, decoded, labels) -> HostBatch:
        if self.table.loader == "image":
            return self._assemble_image(decoded, labels)
        t = self.table
        b = len(decoded)
        nc_cl = t.n_clips * self.config.clip_len
        ch, cw = self.canvas_hw
        src_hw = np.ones((b, 2), np.int32)
        weight = np.zeros((b,), np.float32)
        label = np.full((b,), -1, np.int32)
        z = np.zeros((b, 300), np.float32)
        rng = self._rng
        for k, frames in enumerate(decoded):
            if frames is None:
                continue
            src_hw[k] = (frames.shape[1], frames.shape[2])
            weight[k] = 1.0
            label[k] = labels[k]
            z[k] = t.class_embed[labels[k]]
        params = make_transform_params(
            src_hw, self.crop, t.is_validation, rng, self.short_side)
        idx = resample_indices(params, self.crop)

        window = bool(getattr(self.config, "h2d_window", True))
        wh, ww = self._window_hw() if window else (ch, cw)
        if window and (wh, ww) != (ch, cw):
            # per-sample window offset = first referenced source row/col,
            # clamped so the static window stays inside the canvas; the
            # gather indices are rebased into window coordinates
            # x0 is the elementwise floor index (x1 = min(x0+1, lim) >= x0
            # even under flip), so each axis's first referenced row/col is
            # just its own 0-index minimum
            off_y = np.clip(idx.y0.min(axis=1), 0, ch - wh).astype(np.int64)
            off_x = np.clip(idx.x0.min(axis=1), 0, cw - ww).astype(np.int64)
            idx = ResampleIndices(
                y0=(idx.y0 - off_y[:, None]).astype(np.int32),
                y1=(idx.y1 - off_y[:, None]).astype(np.int32), wy=idx.wy,
                x0=(idx.x0 - off_x[:, None]).astype(np.int32),
                x1=(idx.x1 - off_x[:, None]).astype(np.int32), wx=idx.wx)
        else:
            off_y = off_x = np.zeros((b,), np.int64)

        canvas = np.zeros((b, nc_cl, wh, ww, 3), np.uint8)
        for k, frames in enumerate(decoded):
            if frames is None:
                continue
            win = frames[:, off_y[k]:off_y[k] + wh, off_x[k]:off_x[k] + ww]
            canvas[k, :, :win.shape[1], :win.shape[2]] = win
        return HostBatch(
            canvas=canvas, y0=idx.y0, y1=idx.y1, wy=idx.wy,
            x0=idx.x0, x1=idx.x1, wx=idx.wx,
            z=z, label=label, weight=weight)

    def _assemble_image(self, decoded, labels) -> HostBatch:
        """SUN camera-motion batch: one image + per-frame crop trajectory."""
        from zeroshotvideoclassification_tpu_torch.data.stillimages import (
            camera_motion_trajectory,
            motion_resample_indices,
        )

        t = self.table
        b = len(decoded)
        n_steps = t.n_clips * self.config.clip_len
        ch, cw = self.canvas_hw
        s = self.crop
        aa = bool(getattr(self.config, "sun_antialias", True))
        canvas = np.zeros((b, ch, cw, 3), np.uint8)
        if aa:
            # device-side taps: ship only the trajectory + true sizes; the
            # 2-tap index fields stay as 1-element dummies (HostBatch shape
            # contract) and are never read.
            trajectory = np.zeros((b, n_steps, 3), np.int32)
            img_hw = np.zeros((b, 2), np.int32)
            y0 = y1 = x0 = x1 = np.zeros((b, 1, 1), np.int32)
            wy = wx = np.zeros((b, 1, 1), np.float32)
        else:
            trajectory = img_hw = None
            y0 = np.zeros((b, n_steps, s), np.int32)
            y1 = np.zeros_like(y0)
            wy = np.zeros((b, n_steps, s), np.float32)
            x0 = np.zeros_like(y0)
            x1 = np.zeros_like(y0)
            wx = np.zeros_like(wy)
        weight = np.zeros((b,), np.float32)
        label = np.full((b,), -1, np.int32)
        z = np.zeros((b, 300), np.float32)
        for k, img in enumerate(decoded):
            if img is None:
                continue
            ih, iw = img.shape[:2]
            canvas[k, :ih, :iw] = img
            traj = camera_motion_trajectory((ih, iw), s, n_steps, self._rng)
            if aa:
                trajectory[k] = traj
                img_hw[k] = (ih, iw)
            else:
                y0[k], y1[k], wy[k], x0[k], x1[k], wx[k] = (
                    motion_resample_indices(traj, (ih, iw), s))
            weight[k] = 1.0
            label[k] = labels[k]
            z[k] = t.class_embed[labels[k]]
        return HostBatch(canvas=canvas, y0=y0, y1=y1, wy=wy, x0=x0, x1=x1,
                         wx=wx, z=z, label=label, weight=weight,
                         image_mode=True, trajectory=trajectory,
                         img_hw=img_hw, crop_size=s)

    def _batches(self) -> Iterator[HostBatch]:
        t = self.table
        n = len(t)
        self._rng = np.random.default_rng((self.seed, self.epoch))
        order = np.arange(n)
        if not t.is_validation:
            order = self._rng.permutation(n)
        self.epoch += 1

        # Per-sample child RNGs keep decode deterministic under thread pools.
        child_seeds = self._rng.integers(0, 2**63 - 1, size=n)

        def decode(i):
            return self._decode_one(
                int(order[i]), np.random.default_rng(int(child_seeds[i])))

        import contextlib

        pool_cm = (contextlib.nullcontext(self._pool)
                   if self._pool is not None
                   else cf.ThreadPoolExecutor(max_workers=self.workers))
        with pool_cm as pool:
            for start in range(0, n, self.bs):
                ids = list(range(start, min(start + self.bs, n)))
                decoded = list(pool.map(decode, ids))
                labels = [int(t.label_idx[order[i]]) for i in ids]
                # zero-weight pad the final partial batch to static shape
                while len(decoded) < self.bs:
                    decoded.append(None)
                    labels.append(-1)
                yield self._assemble(decoded, labels)

    def __iter__(self) -> Iterator[HostBatch]:
        """Background-thread prefetch (depth = Config.prefetch_depth):
        decode/pack of batch k+1..k+depth overlaps the consumer's device
        step on batch k — the DataLoader-prefetch analog without processes.

        Early consumer exit (the trainer's 100k-sample epoch cap breaks out
        of every Kinetics epoch, cli/main.py) must not leak the producer:
        the finally block sets a stop flag and drains the queue so the
        producer (whose q.put uses a timeout + stop check) exits and its
        decode pool is torn down."""
        depth = max(int(getattr(self.config, "prefetch_depth", 2)), 0)
        if depth == 0:
            yield from self._batches()
            return
        import queue
        import threading

        q: "queue.Queue" = queue.Queue(maxsize=depth)
        stop = threading.Event()
        _END = object()

        def producer():
            try:
                for b in self._batches():
                    while not stop.is_set():
                        try:
                            q.put(b, timeout=0.1)
                            break
                        except queue.Full:
                            continue
                    if stop.is_set():
                        return
                q.put(_END)
            except BaseException as e:  # surface errors on the consumer side
                if not stop.is_set():
                    q.put(e)

        th = threading.Thread(target=producer, daemon=True)
        th.start()
        try:
            while True:
                item = q.get()
                if item is _END:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            while not q.empty():  # unblock a producer waiting on q.put
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            th.join(timeout=30)


# ------------------------------------------------ host batch -> device ----

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
    device = torch.device(device)
    canvas = _to_device(host_batch.canvas, device)
    if host_batch.image_mode:
        from zeroshotvideoclassification_tpu_torch.data.stillimages import (
            CH_OFFSET,
            CH_SCALE,
        )

        if host_batch.trajectory is not None:
            # antialiased (PIL-parity) path: weights derived on the device
            # from the integer trajectory
            x = fused_image_motion_transform_aa(
                canvas, _to_device(host_batch.trajectory, device),
                _to_device(host_batch.img_hw, device), CH_SCALE, CH_OFFSET,
                crop_size=host_batch.crop_size, out_dtype=out_dtype)
        else:
            taps = [_to_device(getattr(host_batch, k), device) for k in _TAPS]
            x = image_motion_transform(canvas, *taps, CH_SCALE, CH_OFFSET,
                                       out_dtype=out_dtype)
    else:
        taps = [_to_device(getattr(host_batch, k), device) for k in _TAPS]
        x = video_transform(canvas, *taps, out_dtype=out_dtype)
    b, _, s, _, c = x.shape
    return {
        "x": x.reshape(b, n_clips, clip_len, s, s, c),
        "z": _to_device(host_batch.z, device),
        "label": _to_device(host_batch.label, device),
        "weight": _to_device(host_batch.weight, device),
    }
