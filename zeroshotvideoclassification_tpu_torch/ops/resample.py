"""Fused input transforms, plain PyTorch, on the uint8 canvas.

Counterpart of zeroshotvideoclassification_tpu/ops/resample.py, in the same
layouts and the same order of float32 operations. They run on any device.

  fused_video_transform            bilinear resize + crop + flip + normalize
      as a gather + lerp ([B, T, Hc, Wc, C] uint8 in, [B, T, S, S, C] out):
      row lerp, column lerp, then ((v / 255) - 1) / 2, then one cast. The
      CPU path of the video pipeline and the oracle of K1
      (ops/resample_cuda.fused_video_transform_cuda).
  fused_image_motion_transform     the SUN camera-motion inflation: T crop
      boxes of ONE still image per sample ([B, Hc, Wc, C] uint8, taps
      [B, T, S]), each resized with the same 2-tap lerp, then the
      per-channel affine v * scale + offset. The CPU path of
      --no-sun_antialias and the oracle of K4
      (ops/resample_cuda.fused_image_motion_transform_cuda).
  fused_image_motion_transform_aa  the same inflation with PIL's
      antialiased (scaled triangle filter) resize, from the integer crop
      trajectory: dense weight matrices and two float32 matrix products
      (impl='mxu', the default) or a fixed window of weighted gathers
      (impl='gather'). No TPU kernel stood behind it, so it is plain
      PyTorch on every device; it needs full float32 products and refuses
      TF32.
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


def check_image_motion_args(images, y0, y1, wy, x0, x1, wx, out_dtype):
    """Validate the image-motion transform's operands; -> (B, Hc, Wc, T, S)."""
    if (images.dtype != torch.uint8 or images.dim() != 4
            or images.shape[-1] != 3):
        raise ValueError(f"images must be uint8 [B, Hc, Wc, 3], got "
                         f"{images.dtype} {tuple(images.shape)}")
    b, hc, wc, _ = images.shape
    if y0.dim() != 3 or y0.shape[0] != b:
        raise ValueError(f"taps must be [B={b}, T, S], got {tuple(y0.shape)}")
    t, s = y0.shape[1:]
    for name, v, dt in (("y0", y0, torch.int32), ("y1", y1, torch.int32),
                        ("wy", wy, torch.float32), ("x0", x0, torch.int32),
                        ("x1", x1, torch.int32), ("wx", wx, torch.float32)):
        if v.dtype != dt or tuple(v.shape) != (b, t, s):
            raise ValueError(f"{name} must be {dt} [{b}, {t}, {s}], got "
                             f"{v.dtype} {tuple(v.shape)}")
        if v.device != images.device:
            raise ValueError(f"{name} is on {v.device}, images on "
                             f"{images.device}")
    if out_dtype not in OUT_DTYPES:
        raise ValueError(f"out_dtype must be one of {OUT_DTYPES}, got "
                         f"{out_dtype}")
    return b, hc, wc, t, s


def channel_affine(ch_scale, ch_offset):
    """The per-channel (scale, offset) as two float32 numpy arrays [3], from
    numpy arrays, sequences or tensors (a CUDA tensor is fetched, which
    waits for the device: pass host values on a hot path)."""
    import numpy as np

    out = []
    for name, v in (("ch_scale", ch_scale), ("ch_offset", ch_offset)):
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().numpy()
        v = np.asarray(v, np.float32)
        if v.shape != (3,):
            raise ValueError(f"{name} must hold 3 floats, got {v.shape}")
        out.append(v)
    return out


def fused_image_motion_transform(images, y0, y1, wy, x0, x1, wx, ch_scale,
                                 ch_offset, out_dtype=torch.float32):
    """images uint8 [B, Hc, Wc, 3] (one still image per sample); y0/y1/x0/x1
    int32 and wy/wx float32 [B, T, S] (per-frame taps); ch_scale/ch_offset 3
    floats each -> [B, T, S, S, 3] in `out_dtype`: frame t of sample b is its
    crop box t resized to S x S, then v * scale + offset per channel."""
    b = check_image_motion_args(images, y0, y1, wy, x0, x1, wx, out_dtype)[0]
    scale, offset = (torch.from_numpy(v).to(images.device)
                     for v in channel_affine(ch_scale, ch_offset))
    img = images.float()
    bi = torch.arange(b, device=images.device)[:, None, None]
    r0 = img[bi, y0.long()]                                 # [B, T, S, Wc, C]
    r1 = img[bi, y1.long()]
    wyb = wy[:, :, :, None, None]
    rows = r0 * (1.0 - wyb) + r1 * wyb
    c0 = torch.take_along_dim(rows, x0.long()[:, :, None, :, None], dim=3)
    c1 = torch.take_along_dim(rows, x1.long()[:, :, None, :, None], dim=3)
    wxb = wx[:, :, None, :, None]
    out = c0 * (1.0 - wxb) + c1 * wxb                       # [B, T, S, S, C]
    return (out * scale + offset).to(out_dtype)


def _dense_weights(origin, side, limit, n_src: int, s: int):
    """Normalized triangle-filter weights [B, T, S, n_src] of PIL's
    antialiased bilinear resize of the box [origin, origin + side), clamped
    to `limit`, to `s` outputs: origin/side int32 [B, T], limit int32 [B]."""
    o = origin.float()
    extent = torch.minimum(side.float(), limit.float()[:, None] - o)  # [B, T]
    # tensor / tensor: dividing by a Python number becomes a product with
    # its rounded inverse on a GPU, one ulp off the CPU's quotient, which
    # the filter centres amplify to ~1e-4 of the output
    scale = extent / torch.full_like(extent, float(s))
    fs = torch.clamp_min(scale, 1.0)
    d = torch.arange(s, dtype=torch.float32, device=o.device)
    center = (d + 0.5) * scale[:, :, None] + o[:, :, None]        # [B, T, S]
    h = torch.arange(n_src, dtype=torch.float32, device=o.device)
    arg = (h + 0.5 - center[..., None]) / fs[:, :, None, None]
    w = torch.clamp_min(1.0 - arg.abs(), 0.0)
    valid = (h >= o[..., None]) & (h < (o + extent)[..., None])  # [B, T, n]
    w = w * valid[:, :, None, :]
    return w / torch.clamp_min(w.sum(-1, keepdim=True), 1e-20)


def _window_taps(origin, side, limit, s: int, k: int):
    """The same filter as a fixed window of `k` taps per output: source
    indices int64 and normalized weights, both [B, T, S, k] (weights past
    PIL's window are 0)."""
    o = origin.float()
    lim = limit.float()[:, None]
    extent = torch.minimum(side.float(), lim - o)                 # [B, T]
    scale = extent / torch.full_like(extent, float(s))  # as above
    fs = torch.clamp_min(scale, 1.0)[:, :, None]
    d = torch.arange(s, dtype=torch.float32, device=o.device)
    center = (d + 0.5) * scale[:, :, None]                        # [B, T, S]
    # PIL: xmin = max((int)(center - support + .5), 0),
    #      xmax = min((int)(center + support + .5), in_size)
    lo = torch.clamp_min(torch.floor(center - fs + 0.5), 0.0)
    hi = torch.minimum(torch.floor(center + fs + 0.5), extent[:, :, None])
    j = lo[..., None] + torch.arange(k, dtype=torch.float32, device=o.device)
    arg = (j + 0.5 - center[..., None]) / fs[..., None]
    w = torch.clamp_min(1.0 - arg.abs(), 0.0) * (j < hi[..., None])
    w = w / torch.clamp_min(w.sum(-1, keepdim=True), 1e-20)
    idx = j.to(torch.int32) + origin[:, :, None, None]
    # a min above the max (limit 0, a missing image) clamps to the max, -1,
    # which indexes the last row as in the JAX package; its weight is 0
    idx = torch.clamp(idx, min=torch.zeros_like(limit)[:, None, None, None],
                      max=(limit - 1)[:, None, None, None])
    return idx.long(), w


def fused_image_motion_transform_aa(images, trajectory, img_hw, ch_scale,
                                    ch_offset, crop_size: int = 112,
                                    max_taps: int = 11,
                                    out_dtype=torch.float32,
                                    impl: str = "mxu"):
    """images uint8 [B, Hc, Wc, 3]; trajectory int32 [B, T, 3], per-frame
    (y, x, side) crop boxes; img_hw int32 [B, 2], the true (h, w) inside the
    canvas -> [B, T, S, S, 3] in `out_dtype`: every crop resized to S =
    `crop_size` as PIL's bilinear does it (a triangle filter whose support
    scales with the downscale ratio; boxes overhanging the image are clamped
    per axis and stretched; upscales degrade to plain bilinear), then
    v * scale + offset per channel.

    impl='mxu' (default): out = Wy @ img @ Wx^T with the dense [S, Hc] and
    [S, Wc] weight matrices built in float32 on the device; `max_taps` is
    unused. impl='gather': `max_taps` weighted gathers per axis; `max_taps`
    must cover PIL's widest window on this canvas. Both need float32
    products: on a GPU with TF32 matrix products enabled this raises."""
    if (images.dtype != torch.uint8 or images.dim() != 4
            or images.shape[-1] != 3):
        raise ValueError(f"images must be uint8 [B, Hc, Wc, 3], got "
                         f"{images.dtype} {tuple(images.shape)}")
    b, hc, wc, _ = images.shape
    if (trajectory.dtype != torch.int32 or trajectory.dim() != 3
            or trajectory.shape[0] != b or trajectory.shape[2] != 3):
        raise ValueError(f"trajectory must be int32 [{b}, T, 3], got "
                         f"{trajectory.dtype} {tuple(trajectory.shape)}")
    if img_hw.dtype != torch.int32 or tuple(img_hw.shape) != (b, 2):
        raise ValueError(f"img_hw must be int32 [{b}, 2], got "
                         f"{img_hw.dtype} {tuple(img_hw.shape)}")
    if out_dtype not in OUT_DTYPES:
        raise ValueError(f"out_dtype must be one of {OUT_DTYPES}, got "
                         f"{out_dtype}")
    if images.device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("fused_image_motion_transform_aa needs full "
                           "float32 matmuls: set torch.backends.cuda.matmul."
                           "allow_tf32 = False")
    s, k = int(crop_size), int(max_taps)
    scale, offset = (torch.from_numpy(v).to(images.device)
                     for v in channel_affine(ch_scale, ch_offset))
    img = images.float()
    ty, tx, side = trajectory.unbind(-1)
    if impl not in ("mxu", "gather"):
        raise ValueError(f"impl must be 'mxu' or 'gather', got {impl!r}")
    if impl == "mxu":
        wy = _dense_weights(ty, side, img_hw[:, 0], hc, s)   # [B, T, S, Hc]
        wx = _dense_weights(tx, side, img_hw[:, 1], wc, s)   # [B, T, S, Wc]
        # two batched products with the channel kept beside the contracted
        # axis, so that neither needs a transposed copy of the large
        # intermediate: rows [B, T*S, C*Wc], then out [B*T, S*C, S]
        t = trajectory.shape[1]
        planes = img.permute(0, 1, 3, 2).reshape(b, hc, 3 * wc)
        rows = torch.bmm(wy.reshape(b, t * s, hc), planes)
        out = torch.bmm(rows.view(b * t, s * 3, wc),
                        wx.reshape(b * t, s, wc).transpose(1, 2))
        out = out.view(b, t, s, 3, s) * scale[:, None] + offset[:, None]
        res = torch.empty((b, t, s, s, 3), dtype=out_dtype,
                          device=images.device)
        return res.copy_(out.permute(0, 1, 2, 4, 3))  # one cast-and-permute
    else:
        # PIL's window for a crop of extent E is [floor(c - fs + .5),
        # floor(c + fs + .5)) with fs = E / S: at most floor(2 fs) + 2 taps,
        # and E <= the canvas. Too few taps would drop the window's tail
        # without any error (the weights are renormalized).
        worst_fs = max(hc, wc) / float(s)
        need = int(2 * worst_fs) + 2 if worst_fs > 1.0 else 3
        if k < need:
            raise ValueError(
                f"max_taps={k} cannot cover the worst-case PIL window for "
                f"canvas {hc}x{wc} -> {s}: need >= {need} taps (or use "
                f"impl='mxu', which has no tap cap)")
        yi, wy = _window_taps(ty, side, img_hw[:, 0], s, k)  # [B, T, S, K]
        xi, wx = _window_taps(tx, side, img_hw[:, 1], s, k)
        bi = torch.arange(b, device=images.device)[:, None, None]
        rows = wy[..., 0, None, None] * img[bi, yi[..., 0]]  # [B,T,S,Wc,C]
        for i in range(1, k):
            rows = rows + wy[..., i, None, None] * img[bi, yi[..., i]]
        out = wx[:, :, None, :, 0, None] * torch.take_along_dim(
            rows, xi[:, :, None, :, 0, None], dim=3)         # [B,T,S,S,C]
        for i in range(1, k):
            out = out + wx[:, :, None, :, i, None] * torch.take_along_dim(
                rows, xi[:, :, None, :, i, None], dim=3)
    return (out * scale + offset).to(out_dtype)
