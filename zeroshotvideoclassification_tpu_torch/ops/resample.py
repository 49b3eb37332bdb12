"""Fused input transform, plain PyTorch: bilinear resize + crop + flip +
normalize as a gather + lerp on the uint8 canvas.

Counterpart of zeroshotvideoclassification_tpu/ops/resample.py:
fused_video_transform, in the same layout ([B, T, Hc, Wc, C] uint8 in,
[B, T, S, S, C] out) and the same order of float32 operations: row lerp,
column lerp, then ((v / 255) - 1) / 2, then one cast. It runs on any device;
it is the CPU path of the serving pipeline and the oracle of K1
(ops/resample_cuda.py), which must agree with it.
"""

from __future__ import annotations

import torch

OUT_DTYPES = (torch.float32, torch.bfloat16)


def check_transform_args(canvas, y0, y1, wy, x0, x1, wx, out_dtype):
    """Validate the transform's operands; -> (B, T, Hc, Wc, S)."""
    if (canvas.dtype != torch.uint8 or canvas.dim() != 5
            or canvas.shape[-1] != 3):
        raise ValueError(f"canvas must be uint8 [B, T, Hc, Wc, 3], got "
                         f"{canvas.dtype} {tuple(canvas.shape)}")
    b, t, hc, wc, _ = canvas.shape
    if y0.dim() != 2 or y0.shape[0] != b:
        raise ValueError(f"taps must be [B={b}, S], got {tuple(y0.shape)}")
    s = y0.shape[1]
    for name, v, dt in (("y0", y0, torch.int32), ("y1", y1, torch.int32),
                        ("wy", wy, torch.float32), ("x0", x0, torch.int32),
                        ("x1", x1, torch.int32), ("wx", wx, torch.float32)):
        if v.dtype != dt or tuple(v.shape) != (b, s):
            raise ValueError(f"{name} must be {dt} [{b}, {s}], got "
                             f"{v.dtype} {tuple(v.shape)}")
        if v.device != canvas.device:
            raise ValueError(f"{name} is on {v.device}, canvas on "
                             f"{canvas.device}")
    if out_dtype not in OUT_DTYPES:
        raise ValueError(f"out_dtype must be one of {OUT_DTYPES}, got "
                         f"{out_dtype}")
    return b, t, hc, wc, s


def fused_video_transform(canvas, y0, y1, wy, x0, x1, wx,
                          out_dtype=torch.float32):
    """canvas uint8 [B, T, Hc, Wc, 3]; y0/y1/x0/x1 int32 and wy/wx float32
    [B, S] -> [B, T, S, S, 3] in [-0.5, 0], in `out_dtype`."""
    check_transform_args(canvas, y0, y1, wy, x0, x1, wx, out_dtype)
    img = canvas.float()
    r0 = torch.take_along_dim(img, y0.long()[:, None, :, None, None], dim=2)
    r1 = torch.take_along_dim(img, y1.long()[:, None, :, None, None], dim=2)
    wyb = wy[:, None, :, None, None]
    rows = r0 * (1.0 - wyb) + r1 * wyb                      # [B, T, S, Wc, C]
    c0 = torch.take_along_dim(rows, x0.long()[:, None, None, :, None], dim=3)
    c1 = torch.take_along_dim(rows, x1.long()[:, None, None, :, None], dim=3)
    wxb = wx[:, None, None, :, None]
    out = c0 * (1.0 - wxb) + c1 * wxb                       # [B, T, S, S, C]
    return (((out / 255.0) - 1.0) / 2.0).to(out_dtype)
