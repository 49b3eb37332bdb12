"""K1 and K4: the fused input transforms as hand-written CUDA kernels.

fused_video_transform_cuda launches csrc/video_transform.cu (which replaces
the TPU kernel zeroshotvideoclassification_tpu/ops/resample_pallas.py:
fused_video_transform_pallas) on CUDA tensors and counts its launches in
`fused_video_transform_cuda.launches`. video_transform is the public op: a
CPU canvas goes to the plain version (ops/resample.py), a CUDA canvas to the
kernel.

fused_image_motion_transform_cuda launches csrc/image_motion_transform.cu
(which replaces resample_pallas.py:fused_image_motion_transform_pallas, the
SUN camera-motion inflation with 2-tap bilinear crops) and counts its
launches in `fused_image_motion_transform_cuda.launches`;
image_motion_transform is its public op, with the same rule: the plain
version for CPU images, the kernel for CUDA images, nothing in between.
"""

from __future__ import annotations

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


def fused_video_transform_cuda(canvas, y0, y1, wy, x0, x1, wx,
                               out_dtype=torch.float32):
    """Same contract as ops.resample.fused_video_transform, on contiguous
    CUDA tensors only; raises for anything else."""
    b, t, hc, wc, s = check_transform_args(canvas, y0, y1, wy, x0, x1, wx,
                                           out_dtype)
    for name, v in zip(("canvas", "y0", "y1", "wy", "x0", "x1", "wx"),
                       (canvas, y0, y1, wy, x0, x1, wx)):
        if not v.is_contiguous():
            raise ValueError(f"{name} must be contiguous for the kernel")
    if canvas.device.type != "cuda":
        raise ValueError(f"fused_video_transform_cuda needs CUDA tensors, "
                         f"got {canvas.device}")
    if b * t > 65535:  # the kernel's grid.y is one (sample, frame) each
        raise ValueError(f"B*T = {b * t} frames > 65535 per launch")
    out = torch.empty((b, t, s, s, 3), dtype=out_dtype, device=canvas.device)
    if out.numel() == 0:
        return out
    lib = _build.library()
    fn = (lib.zsvc_video_transform_f32 if out_dtype == torch.float32
          else lib.zsvc_video_transform_bf16)
    with torch.cuda.device(canvas.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(canvas.data_ptr(), y0.data_ptr(), y1.data_ptr(),
                 wy.data_ptr(), x0.data_ptr(), x1.data_ptr(), wx.data_ptr(),
                 out.data_ptr(), b, t, hc, wc, s, stream)
    _build.check(err, "video_transform")
    with _count_lock:
        fused_video_transform_cuda.launches += 1
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
