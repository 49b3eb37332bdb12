"""K3: the (3,1,1) temporal convolution of R(2+1)D blocks as one op.

    y[n, t, h, w, :] = sum_{dt=0..2} x[n, t + dt - 1, h, w, :] @ W[dt, 0, 0]

stride 1, SAME padding in t (frames outside [0, T) count as zero), float32
accumulation, one rounding to the compute dtype. Counterpart of
zeroshotvideoclassification_tpu/ops/temporal_conv.py, in its layout: x is
[N, T, H, W, Ci] (NDHWC, the port's channels-last-3d seen through a permuted
view) and w is [3, 1, 1, Ci, Co] (DHWIO). As in the JAX package, no model
calls it: the networks' temporal convs go to cuDNN; this is the op kept
beside them for the comparison.

  temporal_conv3          the public op, a torch.autograd.Function: forward
                          is the kernel on CUDA tensors and the plain version
                          on CPU tensors (nothing falls back from one to the
                          other); backward is the gradient of the library
                          convolution (F.conv3d), as the JAX package's
                          custom_vjp takes the XLA convolution's: K3 never
                          had a backward kernel
  temporal_conv3_cuda     the forward kernel (csrc/temporal_conv.cu, replaces
                          temporal_conv.py:_pallas_forward); launches counted
                          in `temporal_conv3_cuda.launches`
  temporal_conv3_plain    three shifted matrix products accumulated in
                          float32, plain PyTorch, any device and any strides
  tile_plan               how the kernel cuts the output into blocks, in
                          Python so that tests reach it without a GPU
"""

from __future__ import annotations

import threading

import torch
import torch.nn.functional as F

from zeroshotvideoclassification_tpu_torch import _build

DTYPES = (torch.float32, torch.bfloat16)
# one block's tile, as csrc/temporal_conv.cu has it: 128 output rows (n, t, p)
# by 64 output channels, staged 16 input channels at a time by 256 threads
TILE_ROWS, TILE_CO, TILE_CI, THREADS = 128, 64, 16, 256
_count_lock = threading.Lock()


def check_tconv_args(x, w):
    """Validate the op's operands; -> (N, T, H, W, Ci, Co)."""
    if x.dim() != 5:
        raise ValueError(f"x must be [N, T, H, W, Ci], got {tuple(x.shape)}")
    n, t, h, wd, ci = x.shape
    if w.dim() != 5 or tuple(w.shape[:4]) != (3, 1, 1, ci):
        raise ValueError(f"w must be [3, 1, 1, {ci}, Co], got "
                         f"{tuple(w.shape)}")
    if x.dtype not in DTYPES or w.dtype != x.dtype:
        raise ValueError(f"x and w must share one of {DTYPES}, got "
                         f"{x.dtype} and {w.dtype}")
    if w.device != x.device:
        raise ValueError(f"w is on {w.device}, x on {x.device}")
    return n, t, h, wd, ci, w.shape[4]


def tile_plan(n: int, t: int, p: int, ci: int, co: int):
    """How the kernel cuts y [n * t * p, co]: the flat rows (n, t, p) into
    `row_tiles` runs of TILE_ROWS and the channels into `co_tiles` runs of
    TILE_CO (each block one pair, the last of each axis ragged), and the
    3 * ci reduction into `ci_steps` steps of TILE_CI per temporal tap."""
    rows = n * t * p
    return {"rows": rows, "row_tiles": -(-rows // TILE_ROWS),
            "co_tiles": -(-co // TILE_CO), "ci_steps": -(-ci // TILE_CI),
            "threads": THREADS}


def temporal_conv3_plain(x, w):
    """The forward as plain PyTorch ops: x [N, T, H, W, Ci] and w
    [3, 1, 1, Ci, Co] of one dtype -> [N, T, H, W, Co] in that dtype."""
    check_tconv_args(x, w)
    xf, wf = x.float(), w[:, 0, 0].float()
    y = xf @ wf[1]
    y[:, 1:] += xf[:, :-1] @ wf[0]
    y[:, :-1] += xf[:, 1:] @ wf[2]
    return y.to(x.dtype)


def temporal_conv3_cuda(x, w):
    """The forward as one launch of the CUDA kernel; contiguous CUDA tensors
    only, same contract as temporal_conv3_plain."""
    n, t, h, wd, ci, co = check_tconv_args(x, w)
    for name, v in (("x", x), ("w", w)):
        if not v.is_contiguous():
            raise ValueError(f"{name} must be contiguous (channels "
                             f"innermost) for the kernel")
    if x.device.type != "cuda":
        raise ValueError(f"temporal_conv3_cuda needs CUDA tensors, got "
                         f"{x.device}")
    plan = tile_plan(n, t, h * wd, ci, co)
    if plan["row_tiles"] >= 2 ** 31 or plan["co_tiles"] > 65535:
        raise ValueError(f"{plan['row_tiles']} x {plan['co_tiles']} tiles "
                         f"exceed one launch's grid")
    y = torch.empty((n, t, h, wd, co), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    if ci == 0:
        return y.zero_()
    lib = _build.library()
    fn = (lib.zsvc_temporal_conv3_f32 if x.dtype == torch.float32
          else lib.zsvc_temporal_conv3_bf16)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), w.data_ptr(), y.data_ptr(), plan["rows"], t,
                 h * wd, ci, co, plan["row_tiles"], plan["co_tiles"], stream)
    _build.check(err, "temporal_conv3")
    with _count_lock:
        temporal_conv3_cuda.launches += 1
    return y


temporal_conv3_cuda.launches = 0


def _library_conv(x, w):
    """The same convolution through F.conv3d (NDHWC in and out)."""
    y = F.conv3d(x.permute(0, 4, 1, 2, 3), w.permute(4, 3, 0, 1, 2),
                 padding=(1, 0, 0))
    return y.permute(0, 2, 3, 4, 1)


class _TemporalConv3(torch.autograd.Function):
    """Forward by the kernel (the plain version on the CPU), backward by the
    library convolution's gradient (jax.custom_vjp over lax.conv in
    temporal_conv.py:96-111)."""

    @staticmethod
    def forward(ctx, x, w):
        if x.device.type == "cuda":
            y = temporal_conv3_cuda(x, w)
        elif x.device.type == "cpu":
            y = temporal_conv3_plain(x, w)
        else:
            raise ValueError(f"no temporal conv for device {x.device}")
        ctx.save_for_backward(x, w)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        with torch.enable_grad():
            xg = x.detach().requires_grad_(ctx.needs_input_grad[0])
            wg = w.detach().requires_grad_(ctx.needs_input_grad[1])
            y = _library_conv(xg, wg)
        wanted = [v for v in (xg, wg) if v.requires_grad]
        grads = iter(torch.autograd.grad(y, wanted, dy))
        return tuple(next(grads) if need else None
                     for need in ctx.needs_input_grad)


def temporal_conv3(x, w, compute_dtype=torch.bfloat16):
    """Stride-1 SAME (3,1,1) conv, NDHWC: x [N, T, H, W, Ci] and w
    [3, 1, 1, Ci, Co] are cast to `compute_dtype` (float32 or bfloat16) and
    the result [N, T, H, W, Co] comes back in it; differentiable in x and
    w."""
    if compute_dtype not in DTYPES:
        raise ValueError(f"compute_dtype must be one of {DTYPES}, got "
                         f"{compute_dtype}")
    return _TemporalConv3.apply(x.to(compute_dtype).contiguous(),
                                w.to(compute_dtype).contiguous())
