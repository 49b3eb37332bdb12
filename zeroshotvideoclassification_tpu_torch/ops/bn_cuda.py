"""K2: the fused BatchNorm-apply (+ residual) (+ ReLU) epilogue, forward and
backward, as one differentiable op.

    a = scale * rsqrt(var + eps);  b = bias - mean * a      (float32)
    y = [relu](x * a + b [+ residual])                      (float32, one
                                                             rounding to x.dtype)

    g = dy * (y > 0) under ReLU, else dy;  x_hat = x * sinv - mean * sinv
    dx = g * a          d_residual = g
    S1[c] = sum g       S2[c] = sum g * x_hat               (float32)
    d_scale = S2   d_bias = S1   d_mean = -a * S1
    d_var = -1/2 * scale * sinv^2 * S2

Counterpart of zeroshotvideoclassification_tpu/ops/bn_pallas.py. As there,
mean and var are plain differentiable inputs: under batch statistics their
chain rule runs through the graph autograd builds for the statistics
(models/layers.bn_statistics), and the op never needs the cross-batch terms.

  bn_apply_relu          the public op, a torch.autograd.Function on both
                         devices: CUDA tensors go to the two kernels, CPU
                         tensors to the two plain versions. Nothing falls
                         back from a kernel to a plain version.
  bn_apply_relu_cuda     forward kernel (csrc/bn_apply_relu.cu, replaces
                         bn_pallas.py:bn_apply_relu_pallas/_fwd); launches
                         counted in `bn_apply_relu_cuda.launches`
  bn_apply_relu_bwd_cuda backward kernels (same source, replace
                         bn_pallas.py:_bwd): one pass for dx, g and per-chunk
                         partial sums, one small pass that adds the partials
                         in a fixed order (no atomics, bit-reproducible);
                         launches counted in
                         `bn_apply_relu_bwd_cuda.launches`, and the copies
                         made because dy arrived non-contiguous in
                         `bn_apply_relu_bwd_cuda.dy_copies`
  bn_apply_relu_plain, bn_apply_relu_bwd_plain
                         the same two functions in plain PyTorch (float32
                         inside), for the CPU and as the kernels' oracle

Layout: x, residual, y and dy are [..., C], the channel innermost — the JAX
package's layout, and the model's channels-last-3d activations seen through
a permuted view (models/layers.batchnorm_relu). The kernels need them
contiguous: x and residual raise otherwise, dy (which autograd hands over
in whatever layout the next op's backward produced) is copied. The plain
versions take any strides (a CPU convolution may return another memory
layout, e.g. single-threaded).
"""

from __future__ import annotations

import threading

import torch

from zeroshotvideoclassification_tpu_torch import _build

DTYPES = (torch.float32, torch.bfloat16)
_count_lock = threading.Lock()


def check_bn_args(x, scale, bias, mean, var, residual):
    """Validate the epilogue's operands; -> C."""
    if x.dtype not in DTYPES:
        raise ValueError(f"x must be one of {DTYPES}, got {x.dtype}")
    if x.dim() < 1:
        raise ValueError("x must be a [..., C] tensor")
    c = x.shape[-1]
    for name, v in (("scale", scale), ("bias", bias), ("mean", mean),
                    ("var", var)):
        if v.dtype != torch.float32 or tuple(v.shape) != (c,):
            raise ValueError(f"{name} must be float32 [{c}], got {v.dtype} "
                             f"{tuple(v.shape)}")
        if v.device != x.device:
            raise ValueError(f"{name} is on {v.device}, x on {x.device}")
    if residual is not None:
        if (residual.shape != x.shape or residual.dtype != x.dtype
                or residual.device != x.device):
            raise ValueError(
                f"residual must match x ({x.dtype} {tuple(x.shape)} on "
                f"{x.device}), got {residual.dtype} "
                f"{tuple(residual.shape)} on {residual.device}")
    return c


def fold_affine(scale, bias, mean, var, eps):
    """Eval-mode statistics folded into one per-channel affine (a, b), in
    float32 exactly as bn_pallas.py:144-146."""
    sinv = torch.rsqrt(var + eps)
    a = scale * sinv
    return a, bias - mean * a


def bn_apply_relu_plain(x, scale, bias, mean, var, residual=None,
                        relu=True, eps=1e-5):
    """The epilogue as plain PyTorch ops (any device)."""
    check_bn_args(x, scale, bias, mean, var, residual)
    a, b = fold_affine(scale, bias, mean, var, eps)
    y = x.float() * a + b
    if residual is not None:
        y = y + residual.float()
    if relu:
        y = torch.relu(y)
    return y.to(x.dtype)


def bn_apply_relu_cuda(x, scale, bias, mean, var, residual=None, relu=True,
                       eps=1e-5):
    """The epilogue as one launch of the CUDA kernel; contiguous CUDA
    tensors only."""
    c = check_bn_args(x, scale, bias, mean, var, residual)
    for name, v in (("x", x), ("residual", residual)):
        if v is not None and not v.is_contiguous():
            raise ValueError(f"{name} must be contiguous [..., C] (channels "
                             f"innermost) for the kernel")
    if x.device.type != "cuda":
        raise ValueError(f"bn_apply_relu_cuda needs CUDA tensors, got "
                         f"{x.device}")
    a, b = fold_affine(scale, bias, mean, var, eps)
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    lib = _build.library()
    fn = (lib.zsvc_bn_apply_relu_f32 if x.dtype == torch.float32
          else lib.zsvc_bn_apply_relu_bf16)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(),
                 None if residual is None else residual.data_ptr(),
                 a.data_ptr(), b.data_ptr(), y.data_ptr(), x.numel(), c,
                 int(bool(relu)), stream)
    _build.check(err, "bn_apply_relu")
    with _count_lock:
        bn_apply_relu_cuda.launches += 1
    return y


bn_apply_relu_cuda.launches = 0


# ---------------------------------------------------------------- backward ---

_BWD_BLOCK = 256        # columns per block of the backward's first pass
_BWD_MAX_WIDTH = 8192   # largest folded width m * C
_BWD_MAX_TERMS = 8192   # most partial sums (chunks * m) per channel
_BWD_BLOCKS = 2112      # blocks aimed at: 16 for each of an H100's 132 SMs


def bwd_plan(n: int, c: int):
    """How the backward kernel cuts a [n / c, c] tensor: (wf, chunks,
    rows_per_chunk). m consecutive rows fold into one of width wf = m * c,
    with m chosen so that wf fills whole blocks of 256 threads (the least
    idle share, then the smallest m); the ceil(n / wf) folded rows split
    into `chunks` runs of `rows_per_chunk`, enough to fill the card and few
    enough that the second pass stays short."""
    m_min = -(-_BWD_BLOCK // c)
    best = None
    for m in range(m_min, m_min + 32):
        wf = m * c
        if wf > _BWD_MAX_WIDTH and m > m_min:
            break
        tiles = -(-wf // _BWD_BLOCK)
        idle = (tiles * _BWD_BLOCK - wf) / (tiles * _BWD_BLOCK)
        if best is None or idle < best[0] - 1e-9:
            best = (idle, m)
    m = best[1]
    wf = m * c
    rows = -(-n // wf)
    tiles = -(-wf // _BWD_BLOCK)
    chunks = max(1, min(rows, -(-_BWD_BLOCKS // tiles),
                        _BWD_MAX_TERMS // m, 65535))
    rows_per_chunk = -(-rows // chunks)
    chunks = -(-rows // rows_per_chunk)
    return wf, chunks, rows_per_chunk


def _finish_bwd(s1, s2, scale, sinv, a):
    """The per-channel sums -> (d_scale, d_bias, d_mean, d_var), as
    bn_pallas.py:206-213."""
    return s2, s1, -a * s1, -0.5 * scale * sinv * sinv * s2


def bn_apply_relu_bwd_plain(x, y, dy, scale, mean, var, relu=True,
                            want_g=False, eps=1e-5):
    """The backward as plain PyTorch ops (any device, any strides) ->
    (dx, d_scale, d_bias, d_mean, d_var, d_residual or None). `y` is read
    only under relu."""
    sinv = torch.rsqrt(var + eps)
    a = scale * sinv
    g = dy.float()
    if relu:
        g = g * (y.float() > 0.0)
    xh = x.float() * sinv - mean * sinv
    dims = tuple(range(x.dim() - 1))
    s1 = g.sum(dims)
    s2 = (g * xh).sum(dims)
    dx = (g * a).to(x.dtype)
    d_res = g.to(dy.dtype) if want_g else None
    return (dx, *_finish_bwd(s1, s2, scale, sinv, a), d_res)


def bn_apply_relu_bwd_cuda(x, y, dy, scale, mean, var, relu=True,
                           want_g=False, eps=1e-5):
    """The backward as one launch of the two CUDA kernels; same contract as
    bn_apply_relu_bwd_plain, on CUDA tensors with x and y contiguous."""
    c = check_bn_args(x, scale, scale, mean, var, None)  # no bias here
    if x.device.type != "cuda":
        raise ValueError(f"bn_apply_relu_bwd_cuda needs CUDA tensors, got "
                         f"{x.device}")
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"dy must match x ({x.dtype} {tuple(x.shape)} on "
                         f"{x.device}), got {dy.dtype} {tuple(dy.shape)} on "
                         f"{dy.device}")
    for name, v in (("x", x), ("y", y if relu else None)):
        if v is not None and not v.is_contiguous():
            raise ValueError(f"{name} must be contiguous [..., C] (channels "
                             f"innermost) for the kernel")
    if not dy.is_contiguous():
        dy = dy.contiguous()
        with _count_lock:
            bn_apply_relu_bwd_cuda.dy_copies += 1
    sinv = torch.rsqrt(var + eps)
    a = scale * sinv
    dx = torch.empty_like(x)
    g = torch.empty_like(x) if want_g else None
    n = x.numel()
    if n == 0:
        z = torch.zeros_like(scale)
        return dx, z, z.clone(), z.clone(), z.clone(), g
    wf, chunks, rows_per_chunk = bwd_plan(n, c)
    partial = torch.empty((2, chunks, wf), dtype=torch.float32,
                          device=x.device)
    sums = torch.empty((2, c), dtype=torch.float32, device=x.device)
    msinv = mean * sinv
    lib = _build.library()
    fn = (lib.zsvc_bn_bwd_f32 if x.dtype == torch.float32
          else lib.zsvc_bn_bwd_bf16)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), y.data_ptr() if relu else None, dy.data_ptr(),
                 a.data_ptr(), sinv.data_ptr(), msinv.data_ptr(),
                 dx.data_ptr(), None if g is None else g.data_ptr(),
                 partial.data_ptr(), sums.data_ptr(), n, c, wf, chunks,
                 rows_per_chunk, int(bool(relu)), stream)
    _build.check(err, "bn_apply_relu backward")
    with _count_lock:
        bn_apply_relu_bwd_cuda.launches += 1
    return (dx, *_finish_bwd(sums[0], sums[1], scale, sinv, a), g)


bn_apply_relu_bwd_cuda.launches = 0
bn_apply_relu_bwd_cuda.dy_copies = 0


# -------------------------------------------------------------- public op ----

class _BNApplyReLU(torch.autograd.Function):
    """The epilogue with its hand-written backward (jax.custom_vjp in
    bn_pallas.py:130): the kernels on CUDA tensors, the plain versions on
    CPU tensors. Saves x, y (under relu), scale, mean and var."""

    @staticmethod
    def forward(ctx, x, scale, bias, mean, var, residual, relu, eps):
        if x.device.type == "cuda":
            y = bn_apply_relu_cuda(x, scale, bias, mean, var, residual, relu,
                                   eps)
        elif x.device.type == "cpu":
            y = bn_apply_relu_plain(x, scale, bias, mean, var, residual,
                                    relu, eps)
        else:
            raise ValueError(f"no BN epilogue for device {x.device}")
        ctx.save_for_backward(x, y if relu else None, scale, mean, var)
        ctx.relu, ctx.eps, ctx.want_g = relu, eps, residual is not None
        return y

    @staticmethod
    def backward(ctx, dy):
        x, y, scale, mean, var = ctx.saved_tensors
        bwd = (bn_apply_relu_bwd_cuda if x.device.type == "cuda"
               else bn_apply_relu_bwd_plain)
        dx, d_scale, d_bias, d_mean, d_var, d_res = bwd(
            x, y, dy, scale, mean, var, ctx.relu, ctx.want_g, ctx.eps)
        return dx, d_scale, d_bias, d_mean, d_var, d_res, None, None


def bn_apply_relu(x, scale, bias, mean, var, residual=None, relu=True,
                  eps=1e-5):
    """The epilogue on x's device, differentiable in x, scale, bias, mean,
    var and residual."""
    return _BNApplyReLU.apply(x, scale, bias, mean, var, residual,
                              bool(relu), float(eps))
