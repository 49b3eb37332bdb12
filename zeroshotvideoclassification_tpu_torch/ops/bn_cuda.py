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
                         bn_pallas.py:bn_apply_relu_pallas/_fwd). Bound by
                         bytes (x, r read and y written once) and, at the
                         small shapes, by the host: a call is one
                         allocation and one launch and no other PyTorch op.
                         A thread reads and writes 16 bytes a row (8 bf16 /
                         4 float32 consecutive columns of the folded
                         [rows, m * C] view `fwd_plan` picks) and computes
                         its channels' a and b in registers. Launches
                         counted in `bn_apply_relu_cuda.launches`
  fwd_prepare            the same call split into its allocation and its
                         launch, for timing the launch alone
  bn_apply_relu_bwd_cuda backward kernels (same source, replace
                         bn_pallas.py:_bwd). Bound by bytes (x, y, dy read
                         and dx, g written once) and, at the small shapes,
                         by the host: so a call is two launches and three
                         allocations and no other PyTorch op. Pass 1 reads
                         and writes 16 bytes a thread and row (8 bf16 / 4
                         float32 consecutive columns of the folded
                         [rows, m * C] view `bwd_plan` picks), computes
                         rsqrt(var + eps), a and mean * sinv in registers,
                         and leaves one partial sum per block and channel;
                         pass 2 adds the partials in a fixed order (no
                         atomics, bit-reproducible) and writes d_scale,
                         d_bias, d_mean, d_var into one [4, C] tensor.
                         Tensors that are not 16-byte aligned take the same
                         kernel one element a thread. Launches counted in
                         `bn_apply_relu_bwd_cuda.launches`, and the copies
                         made because dy arrived non-contiguous in
                         `bn_apply_relu_bwd_cuda.dy_copies`
  bwd_prepare            the same call split into its allocations and its
                         launch, for timing the launches alone
  bn_apply_relu_plain, bn_apply_relu_bwd_plain
                         the same two functions in plain PyTorch (float32
                         inside; the forward folds the statistics with
                         fold_affine), for the CPU and as the kernels' oracle

Layout: x, residual, y and dy are [..., C], the channel innermost — the JAX
package's layout, and the model's channels-last-3d activations seen through
a permuted view (models/layers.batchnorm_relu). The kernels need them
contiguous: x and residual raise otherwise, dy (which autograd hands over
in whatever layout the next op's backward produced) is copied. The plain
versions take any strides (a CPU convolution may return another memory
layout, e.g. single-threaded).
"""

from __future__ import annotations

import functools
import math
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


# ----------------------------------------------------------------- forward ---

_MAX_THREADS = 512       # threads per block of either kernel, at most
_BWD_MAX_BLOCKS = 264    # backward: most blocks (two for each of an H100's
                         # 132 SMs): the partials pass 2 adds per channel
_BWD_MIN_ROWS = 4        # backward: folded rows per chunk, at least (while
                         # rows last)
_FWD_ROWS = 8            # forward: folded rows per thread ...
_FWD_MIN_BLOCKS = 264    # ... fewer where that leaves under two blocks for
                         # each SM (while rows last)


def _fold(n: int, c: int, vec: int):
    """The folded width both kernels use: m consecutive rows of c make one
    of width m * c, a multiple of `vec`; among those, the m and the block
    size (a multiple of 32 up to 512 threads, `tiles` blocks across the
    width) with the fewest idle threads, then the widest row. -> (m,
    threads, tiles)."""
    step = vec // math.gcd(c, vec)        # m must be a multiple of this
    best = None
    for m in range(step, max(step, _MAX_THREADS * vec // c) + 1, step):
        cols = m * c // vec               # threads that have columns
        tiles = -(-cols // _MAX_THREADS)
        threads = -(-(-(-cols // tiles)) // 32) * 32
        idle = 1.0 - cols / (tiles * threads)
        key = (round(idle, 3), -m)
        if best is None or key < best[0]:
            best = (key, m, threads, tiles)
        if m * c >= n:                    # one folded row holds it all
            break
    return best[1:]


def _plan(n, c, vec, m, threads, tiles, chunks):
    """The plan's dict, with chunks evened out over the folded rows."""
    wf = m * c
    rows = -(-n // wf)
    chunks = max(1, min(chunks, 65535))
    rows_per_chunk = -(-rows // chunks)
    return {"wf": wf, "m": m, "vec": vec, "threads": threads,
            "col_tiles": tiles, "chunks": -(-rows // rows_per_chunk),
            "rows_per_chunk": rows_per_chunk,
            "path": "vector16" if vec > 1 else "scalar"}


@functools.lru_cache(maxsize=None)
def fwd_plan(n: int, c: int, itemsize: int = 2, aligned: bool = True):
    """How the forward cuts a [n / c, c] tensor of `itemsize`-byte elements.

    The folded view and the block size are the backward's (`bwd_plan`): m
    rows fold into one of width wf = m * c, a thread owns `vec` consecutive
    columns (16 bytes; 1 when the tensors are not 16-byte `aligned`), and
    `col_tiles` blocks of `threads` cover the width. There is no reduction,
    so the blocks are not capped: the ceil(n / wf) folded rows split into
    `chunks` of `rows_per_chunk` rows (8 a thread, fewer where that leaves
    under 264 blocks, i.e. two for each of an H100's 132 SMs; at most 65535
    chunks). -> dict with those keys and `path` ("vector16" or "scalar");
    cached, so treat it as read-only."""
    vec = 16 // itemsize if aligned else 1
    m, threads, tiles = _fold(n, c, vec)
    rows = -(-n // (m * c))
    chunks = -(-rows // _FWD_ROWS)
    if tiles * chunks < _FWD_MIN_BLOCKS:
        chunks = min(rows, -(-_FWD_MIN_BLOCKS // tiles))
    return _plan(n, c, vec, m, threads, tiles, chunks)


def fwd_prepare(x, scale, bias, mean, var, residual=None, relu=True,
                eps=1e-5):
    """Check the operands, allocate y and plan the cut -> (launch, y):
    `launch()` enqueues the kernel on the current stream and counts one
    launch (for an empty x it does nothing); y holds the result once it
    has run. x (and residual) must be contiguous CUDA tensors."""
    c = check_bn_args(x, scale, bias, mean, var, residual)
    for name, v in (("x", x), ("residual", residual)):
        if v is not None and not v.is_contiguous():
            raise ValueError(f"{name} must be contiguous [..., C] (channels "
                             f"innermost) for the kernel")
    if x.device.type != "cuda":
        raise ValueError(f"bn_apply_relu_cuda needs CUDA tensors, got "
                         f"{x.device}")
    y = torch.empty_like(x)
    keep = (x, residual, scale, bias, mean, var)  # alive until queued
    if x.numel() == 0:
        return (lambda: keep), y
    aligned = x.data_ptr() % 16 == 0 and (residual is None
                                          or residual.data_ptr() % 16 == 0)
    plan = fwd_plan(x.numel(), c, x.element_size(), aligned)
    lib = _build.library()
    fn = (lib.zsvc_bn_apply_relu_f32 if x.dtype == torch.float32
          else lib.zsvc_bn_apply_relu_bf16)
    args = (x.data_ptr(), None if residual is None else residual.data_ptr(),
            scale.data_ptr(), bias.data_ptr(), mean.data_ptr(),
            var.data_ptr(), float(eps), y.data_ptr(), x.numel(), c,
            plan["wf"], plan["vec"], plan["threads"], plan["col_tiles"],
            plan["chunks"], plan["rows_per_chunk"], int(bool(relu)))

    def launch():
        _build.launch(fn, args, x.device, "bn_apply_relu", plan)
        with _count_lock:
            bn_apply_relu_cuda.launches += 1
        return keep

    return launch, y


def bn_apply_relu_cuda(x, scale, bias, mean, var, residual=None, relu=True,
                       eps=1e-5):
    """The epilogue as one allocation and one launch of the CUDA kernel
    (none for an empty x); contiguous CUDA tensors only."""
    launch, y = fwd_prepare(x, scale, bias, mean, var, residual, relu, eps)
    launch()
    return y


bn_apply_relu_cuda.launches = 0


# ---------------------------------------------------------------- backward ---

@functools.lru_cache(maxsize=None)
def bwd_plan(n: int, c: int, itemsize: int = 2, aligned: bool = True):
    """How the backward cuts a [n / c, c] tensor of `itemsize`-byte elements.

    m consecutive rows fold into one of width wf = m * c; a thread of pass 1
    owns `vec` consecutive columns (16 bytes: 8 bf16 or 4 float32; 1 when the
    tensors are not 16-byte `aligned`), so m makes wf a multiple of vec, and
    among those the plan takes the m and the block size (`threads`, a
    multiple of 32 up to 512; `col_tiles` blocks across the width) with the
    fewest idle threads, then the widest row. The ceil(n / wf) folded rows
    split into `chunks` runs of `rows_per_chunk`: enough blocks to fill the
    card, at most 264 in all (pass 2 adds one partial per block and
    channel, and a block of several hundred threads with two rows each in
    flight keeps the memory system as busy as more blocks would), at most
    65535 chunks. -> dict with those keys and `path` ("vector16" or
    "scalar"); cached, so treat it as read-only."""
    vec = 16 // itemsize if aligned else 1
    m, threads, tiles = _fold(n, c, vec)
    rows = -(-n // (m * c))
    return _plan(n, c, vec, m, threads, tiles,
                 min(-(-rows // _BWD_MIN_ROWS), _BWD_MAX_BLOCKS // tiles))


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


def bwd_prepare(x, y, dy, scale, mean, var, relu=True, want_g=False,
                eps=1e-5):
    """Check the operands, allocate the results and plan the cut ->
    (launch, results): `launch(passes=3)` enqueues pass 1 (bit 1) and pass 2
    (bit 2) on the current stream and counts one launch of the op;
    `results` is what bn_apply_relu_bwd_cuda returns once it has run. x and
    y must be contiguous; n > 0."""
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
    n = x.numel()
    dx = torch.empty_like(x)
    g = torch.empty_like(x) if want_g else None
    aligned = all(v.data_ptr() % 16 == 0
                  for v in (x, dy, y if relu else None) if v is not None)
    plan = bwd_plan(n, c, x.element_size(), aligned)
    blocks = plan["col_tiles"] * plan["chunks"]
    # the partial sums [2][blocks][C] and the results [4][C], one allocation
    scratch = torch.empty((2 * blocks + 4) * c, dtype=torch.float32,
                          device=x.device)
    out = scratch[2 * blocks * c:].view(4, c)
    lib = _build.library()
    fn = (lib.zsvc_bn_bwd_f32 if x.dtype == torch.float32
          else lib.zsvc_bn_bwd_bf16)
    args = (x.data_ptr(), y.data_ptr() if relu else None, dy.data_ptr(),
            scale.data_ptr(), mean.data_ptr(), var.data_ptr(), float(eps),
            dx.data_ptr(), None if g is None else g.data_ptr(),
            scratch.data_ptr(), out.data_ptr(), n, c, plan["wf"],
            plan["vec"], plan["threads"], plan["col_tiles"], plan["chunks"],
            plan["rows_per_chunk"], int(bool(relu)))
    keep = (x, y, dy, scale, mean, var)  # alive until the launch is queued

    def launch(passes=3):
        _build.launch(fn, (*args, passes), x.device, "bn_apply_relu backward",
                      plan)
        with _count_lock:
            bn_apply_relu_bwd_cuda.launches += 1
        return keep

    return launch, (dx, *out.unbind(0), g)


def bn_apply_relu_bwd_cuda(x, y, dy, scale, mean, var, relu=True,
                           want_g=False, eps=1e-5):
    """The backward as one launch of the two CUDA kernels; same contract as
    bn_apply_relu_bwd_plain, on CUDA tensors with x and y contiguous."""
    if x.numel() == 0:
        check_bn_args(x, scale, scale, mean, var, None)
        z = torch.zeros_like(scale)
        return (torch.empty_like(x), z, z.clone(), z.clone(), z.clone(),
                torch.empty_like(x) if want_g else None)
    launch, results = bwd_prepare(x, y, dy, scale, mean, var, relu, want_g,
                                  eps)
    launch()
    return results


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
