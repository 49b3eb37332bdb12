"""K1 and K4: the fused input transforms as hand-written CUDA kernels.

fused_video_transform_cuda launches csrc/video_transform.cu (which replaces
the TPU kernel zeroshotvideoclassification_tpu/ops/resample_pallas.py:
fused_video_transform_pallas) on CUDA tensors and counts its launches in
`fused_video_transform_cuda.launches`: a block per band of output rows of
one frame stages the band's source rows in shared memory and writes the
band with 16-byte stores. transform_plan sizes the bands, the shared
memory and the grid (plain Python, tested on the CPU); transform_prepare
splits a call into its allocation and its launch, for timing the launch
alone.
video_transform is the public op: a CPU canvas goes to the plain version
(ops/resample.py), a CUDA canvas to the kernel.

fused_image_motion_transform_cuda launches csrc/image_motion_transform.cu
(which replaces resample_pallas.py:fused_image_motion_transform_pallas, the
SUN camera-motion inflation with 2-tap bilinear crops) and counts its
launches in `fused_image_motion_transform_cuda.launches`;
image_motion_transform is its public op, with the same rule: the plain
version for CPU images, the kernel for CUDA images, nothing in between.
"""

from __future__ import annotations

import functools
import threading

import torch

from zeroshotvideoclassification_tpu_torch import _build
from zeroshotvideoclassification_tpu_torch.ops.resample import (
    channel_affine,
    check_image_motion_args,
    check_transform_args,
    fused_image_motion_transform,
    fused_video_transform,
)

_count_lock = threading.Lock()


K1_MAX_THREADS = 256
K1_SMEM_MAX = 232448     # shared memory a block may use on an H100
_SM_SMEM = 233472        # shared memory of one SM (each block takes 1 KB more)
_K1_SMEM_TARGET = 96 * 1024  # at most, where a band allows: two blocks an SM
_K1_BAND_ROWS = (16, 8, 4, 2, 1)


def _align16(v: int) -> int:
    return -(-v // 16) * 16


def k1_smem_bytes(band_rows: int, stage_rows: int, s: int, wc: int,
                  out_itemsize: int) -> int:
    """Shared memory of one K1 block (csrc/video_transform.cu `Layout`):
    the output tile of a band (+16 bytes to mirror its 16-byte phase), the
    taps (the S column taps and the band's row taps, 12 bytes each) and a
    staging area of `stage_rows` canvas rows (+64 bytes for the phases of
    two runs and a word read past the last byte)."""
    return (_align16(band_rows * s * 3 * out_itemsize + 16)
            + _align16(s * 12 + band_rows * 12)
            + _align16(stage_rows * wc * 3 + 64))


def k1_threads(s: int) -> int:
    """Threads of a K1 block: a multiple of 32, at most 256, that wastes
    the fewest on whole output rows of s columns (224 for s = 112: two rows
    at a time)."""
    return min(K1_MAX_THREADS,
               -(-s * max(1, K1_MAX_THREADS // s) // 32) * 32)


def k1_plan(b: int, t: int, hc: int, wc: int, s: int, out_itemsize: int,
            band_rows: int):
    """One K1 plan at a given band height, or None where two canvas rows
    do not fit: `stage_rows` is the span that `band_rows` output rows touch
    when the crop is at most the canvas tall (band_rows * hc / s, plus 3
    for the floors and the second tap), or as many rows as fit
    (`whole_span` says which); a grid of `bands` x b * t blocks (`blocks`
    in all), `per_sm` of which an H100 SM holds at once."""
    rows = min(band_rows, s)
    want = max(2, min(hc, -(-rows * hc // s) + 3))
    stage = want
    while (stage >= 2 and k1_smem_bytes(rows, stage, s, wc, out_itemsize)
           > K1_SMEM_MAX):
        stage = min(stage - 1, (stage * 3) // 4 + 1)
    if stage < 2:
        return None
    smem = k1_smem_bytes(rows, stage, s, wc, out_itemsize)
    threads = k1_threads(s)
    bands = -(-s // rows)
    return {"band_rows": rows, "stage_rows": stage,
            "whole_span": stage == want, "bands": bands, "frames": b * t,
            "blocks": bands * b * t, "threads": threads,
            "per_sm": max(1, min(2048 // threads, 32,
                                 _SM_SMEM // (smem + 1024))),
            "smem_bytes": smem}


@functools.lru_cache(maxsize=None)
def transform_plan(b: int, t: int, hc: int, wc: int, s: int,
                   out_itemsize: int):
    """How K1 cuts a [b, t, hc, wc, 3] canvas into [b, t, s, s, 3] outputs
    (k1_plan's dict; cached, so treat it as read-only).

    One block per band of output rows of one frame, b * t frames (at most
    65535). A band stages its source rows once; taps spread further than
    the staging area holds (not monotone, a crop past the canvas, a canvas
    too wide) are staged in pieces inside the kernel. The plan takes, in
    this order of preference, the whole span staged, at most 96 KB of
    shared memory (two blocks an SM), the most band rows of 16, 8, 4, 2, 1;
    within the 227 KB a block may use. Raises where even one output row
    and two canvas rows do not fit, or b * t > 65535."""
    if b * t > 65535:
        raise ValueError(f"B*T = {b * t} frames > 65535 per launch")
    fits = [p for rows in _K1_BAND_ROWS
            if (p := k1_plan(b, t, hc, wc, s, out_itemsize, rows))]
    if not fits:
        raise ValueError(f"a {wc}-pixel-wide canvas row and a {s}-pixel "
                         f"output row do not fit the kernel's shared memory")
    return min(fits, key=lambda p: (not p["whole_span"],
                                    p["smem_bytes"] > _K1_SMEM_TARGET,
                                    -p["band_rows"]))


def transform_prepare(canvas, y0, y1, wy, x0, x1, wx,
                      out_dtype=torch.float32):
    """Check the operands, allocate the output and plan the cut ->
    (launch, out): `launch()` enqueues the kernel on the current stream and
    counts one launch (for an empty output it does nothing); out holds the
    result once it has run. Contiguous CUDA tensors only."""
    b, t, hc, wc, s = check_transform_args(canvas, y0, y1, wy, x0, x1, wx,
                                           out_dtype)
    for name, v in zip(("canvas", "y0", "y1", "wy", "x0", "x1", "wx"),
                       (canvas, y0, y1, wy, x0, x1, wx)):
        if not v.is_contiguous():
            raise ValueError(f"{name} must be contiguous for the kernel")
    if canvas.device.type != "cuda":
        raise ValueError(f"fused_video_transform_cuda needs CUDA tensors, "
                         f"got {canvas.device}")
    out = torch.empty((b, t, s, s, 3), dtype=out_dtype, device=canvas.device)
    keep = (canvas, y0, y1, wy, x0, x1, wx)  # alive until the launch is queued
    if out.numel() == 0:
        return (lambda: keep), out
    plan = transform_plan(b, t, hc, wc, s, out.element_size())
    lib = _build.library()
    fn = (lib.zsvc_video_transform_f32 if out_dtype == torch.float32
          else lib.zsvc_video_transform_bf16)
    args = (canvas.data_ptr(), y0.data_ptr(), y1.data_ptr(), wy.data_ptr(),
            x0.data_ptr(), x1.data_ptr(), wx.data_ptr(), out.data_ptr(), b, t,
            hc, wc, s, plan["band_rows"], plan["stage_rows"],
            plan["threads"], plan["smem_bytes"])

    def launch():
        _build.launch(fn, args, canvas.device, "video_transform", plan)
        with _count_lock:
            fused_video_transform_cuda.launches += 1
        return keep

    return launch, out


def fused_video_transform_cuda(canvas, y0, y1, wy, x0, x1, wx,
                               out_dtype=torch.float32):
    """Same contract as ops.resample.fused_video_transform, on contiguous
    CUDA tensors only; raises for anything else. One allocation and one
    launch (none for an empty output)."""
    launch, out = transform_prepare(canvas, y0, y1, wy, x0, x1, wx,
                                    out_dtype)
    launch()
    return out


fused_video_transform_cuda.launches = 0


def video_transform(canvas, y0, y1, wy, x0, x1, wx, out_dtype=torch.float32):
    """The transform on the canvas's device: the plain version on the CPU,
    the kernel on a GPU."""
    if canvas.device.type == "cuda":
        return fused_video_transform_cuda(canvas, y0, y1, wy, x0, x1, wx,
                                          out_dtype)
    if canvas.device.type == "cpu":
        return fused_video_transform(canvas, y0, y1, wy, x0, x1, wx,
                                     out_dtype)
    raise ValueError(f"no transform for device {canvas.device}")


def fused_image_motion_transform_cuda(images, y0, y1, wy, x0, x1, wx,
                                      ch_scale, ch_offset,
                                      out_dtype=torch.float32):
    """Same contract as ops.resample.fused_image_motion_transform, on
    contiguous CUDA tensors only; raises for anything else. ch_scale and
    ch_offset travel as kernel arguments: hand them over as host values."""
    b, hc, wc, t, s = check_image_motion_args(images, y0, y1, wy, x0, x1, wx,
                                              out_dtype)
    for name, v in zip(("images", "y0", "y1", "wy", "x0", "x1", "wx"),
                       (images, y0, y1, wy, x0, x1, wx)):
        if not v.is_contiguous():
            raise ValueError(f"{name} must be contiguous for the kernel")
    if images.device.type != "cuda":
        raise ValueError(f"fused_image_motion_transform_cuda needs CUDA "
                         f"tensors, got {images.device}")
    if b * t > 65535:  # the kernel's grid.y is one (sample, frame) each
        raise ValueError(f"B*T = {b * t} frames > 65535 per launch")
    scale, offset = channel_affine(ch_scale, ch_offset)
    out = torch.empty((b, t, s, s, 3), dtype=out_dtype, device=images.device)
    if out.numel() == 0:
        return out
    lib = _build.library()
    fn = (lib.zsvc_image_motion_transform_f32 if out_dtype == torch.float32
          else lib.zsvc_image_motion_transform_bf16)
    with torch.cuda.device(images.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(images.data_ptr(), y0.data_ptr(), y1.data_ptr(),
                 wy.data_ptr(), x0.data_ptr(), x1.data_ptr(), wx.data_ptr(),
                 out.data_ptr(), *map(float, scale), *map(float, offset),
                 b, t, hc, wc, s, stream)
    _build.check(err, "image_motion_transform")
    with _count_lock:
        fused_image_motion_transform_cuda.launches += 1
    return out


fused_image_motion_transform_cuda.launches = 0


def image_motion_transform(images, y0, y1, wy, x0, x1, wx, ch_scale,
                           ch_offset, out_dtype=torch.float32):
    """The 2-tap image-motion transform on the images' device: the plain
    version on the CPU, the kernel on a GPU."""
    fn = {"cuda": fused_image_motion_transform_cuda,
          "cpu": fused_image_motion_transform}.get(images.device.type)
    if fn is None:
        raise ValueError(f"no transform for device {images.device}")
    return fn(images, y0, y1, wy, x0, x1, wx, ch_scale, ch_offset, out_dtype)
