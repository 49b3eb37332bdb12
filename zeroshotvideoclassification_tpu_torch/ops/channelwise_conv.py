"""X3D's channel-wise 3D conv (groups = C_in = C_out) as one differentiable
op, with hand-written CUDA kernels for the forward, the data gradient and
the weight gradient (csrc/channelwise_conv.cu) and their plain version.

    y[n, c, t, h, w] = sum_{dt,dh,dw} x[n, c, t + dt - pt, h*sh + dh - ph,
                                       w*sw + dw - pw] * W[c, 0, dt, dh, dw]

x is [N, C, T, H, W] (channels-last-3d memory on CUDA), W [C, 1, kt, kh,
kw] with no bias. The shapes X3D-M takes, and no others: a (3,3,3) kernel at
stride (1,1,1) or (1,2,2) with padding 1, and the stem's (5,1,1) kernel at
stride 1 with padding (2,0,0).

Numerics, on both devices: the weight is rounded to x's dtype (as
layers.Conv3d rounds its cast copy of a float32 master), products are
summed in float32 (float64 for a float64 x), and each output and
data-gradient element is rounded to x's dtype once; the weight gradient is
the float32 sum, in the weight's dtype.

  channelwise_conv3d      the public op, a torch.autograd.Function: CUDA
                          tensors go to the kernels, CPU tensors to the
                          plain versions; nothing falls back from one to the
                          other. Saves x and the weight
  channelwise_fwd_cuda    the forward kernel (after a small one that lays
                          the rounded weights out tap-major); a call counts
                          one launch in `channelwise_fwd_cuda.launches`
  channelwise_dgrad_cuda  the data gradient's kernel (the transposed
                          gather, after the same small one);
                          `channelwise_dgrad_cuda.launches`
  channelwise_wgrad_cuda  the weight gradient's two kernels (per-block
                          float32 partials, then their fixed-order sum: two
                          calls give the same bits); one call counts one
                          launch in `channelwise_wgrad_cuda.launches`
  channelwise_*_plain     F.conv3d and its gradients (torch.nn.grad) in
                          float32 over the rounded operands: the CPU path
                          and the kernels' oracle (PyTorch's CPU bfloat16
                          channels-last channel-wise conv3d gives the stem's
                          (5,1,1) conv a wrong weight gradient)
  kind, gather_plan, wgrad_plan
                          which kernel instance a shape takes and how a call
                          is cut into blocks, in Python so that tests reach
                          them without a GPU; TILES mirrors the file's
                          instances, which check what they are passed
"""

from __future__ import annotations

import functools
import math
import threading

import torch
import torch.nn.functional as F

from zeroshotvideoclassification_tpu_torch import _build

DTYPES = (torch.float32, torch.bfloat16)
# (kernel, stride, padding) -> the kernel instance of csrc/channelwise_conv.cu
KINDS = {((3, 3, 3), (1, 1, 1), (1, 1, 1)): 0,
         ((3, 3, 3), (1, 2, 2), (1, 1, 1)): 1,
         ((5, 1, 1), (1, 1, 1), (2, 0, 0)): 2}
# (rows, columns) of output positions a thread takes, per kernel and kind:
# the mirror of kFwdTiles / kDgradTiles / kWgradTiles in the .cu file
TILES = {"fwd": ((2, 4), (1, 4), (2, 4)),
         "dgrad": ((2, 4), (2, 4), (2, 4)),
         "wgrad": ((2, 4), (1, 4), (2, 4))}
THREADS = 256  # threads a weight-gradient block, at most
GATHER_THREADS = 128  # threads a forward or data-gradient block
SLAB_WORDS = 32  # channel words a weight-gradient block takes, at most
BLOCKS_PER_SM = 2  # weight-gradient blocks (partials) per SM, about

_count_lock = threading.Lock()


def _triple(v):
    return tuple(int(a) for a in v) if isinstance(v, (tuple, list)) else (
        int(v),) * 3


def kind(weight_shape, stride, padding) -> int:
    """The kernel instance of a (kernel, stride, padding); raises on any
    shape X3D does not take."""
    k = tuple(int(a) for a in weight_shape[2:])
    key = (k, _triple(stride), _triple(padding))
    if key not in KINDS:
        raise ValueError(f"channel-wise conv: kernel {k}, stride "
                         f"{key[1]}, padding {key[2]} is not one of "
                         f"{sorted(KINDS)}")
    return KINDS[key]


def check_args(x, weight, stride, padding, bias=None) -> int:
    """Validate the op's operands -> its kind."""
    if bias is not None:
        raise ValueError("channel-wise conv: no bias (X3D's convs have none)")
    if weight.device != x.device:
        raise ValueError(f"weight is on {weight.device}, x on {x.device}")
    return _checked(tuple(x.shape), x.dtype, tuple(weight.shape),
                    weight.dtype, _triple(stride), _triple(padding))


@functools.lru_cache(maxsize=None)
def _checked(x_shape, x_dtype, w_shape, w_dtype, stride, padding) -> int:
    """check_args' checks of shapes and dtypes, once per signature (the
    host launches 81 of these calls a train step)."""
    if len(x_shape) != 5:
        raise ValueError(f"x must be [N, C, T, H, W], got {x_shape}")
    c = x_shape[1]
    if len(w_shape) != 5 or w_shape[:2] != (c, 1):
        raise ValueError(f"weight must be [{c}, 1, kt, kh, kw] for {c} "
                         f"channels, got {w_shape}")
    if not (x_dtype.is_floating_point and w_dtype.is_floating_point):
        raise ValueError(f"floating x and weight, got {x_dtype}, {w_dtype}")
    return kind(w_shape, stride, padding)


@functools.lru_cache(maxsize=None)
def output_shape(x_shape, weight_shape, stride, padding):
    s, p, k = _triple(stride), _triple(padding), weight_shape[2:]
    return (x_shape[0], x_shape[1], *((d + 2 * pp - kk) // ss + 1 for d, kk,
                                      ss, pp in zip(x_shape[2:], k, s, p)))


# ------------------------------------------------------------- plain ----

def _sum_dtype(dtype):
    return torch.float64 if dtype == torch.float64 else torch.float32


def _rounded(weight, dtype):
    """The weight as the conv multiplies it: rounded to x's dtype, in the
    dtype the products are summed in."""
    return weight.detach().to(dtype).to(_sum_dtype(dtype))


def channelwise_fwd_plain(x, weight, stride, padding):
    """y in x's dtype: F.conv3d summed in float32 (float64 for float64)
    over x and the rounded weight, rounded once; channels-last-3d where x
    is (the CPU's conv3d picks its output's layout by its own path)."""
    check_args(x, weight, stride, padding)
    st = _sum_dtype(x.dtype)
    y = F.conv3d(x.to(st), _rounded(weight, x.dtype), None, stride, padding,
                 1, x.shape[1]).to(x.dtype)
    if x.is_contiguous(memory_format=torch.channels_last_3d):
        y = y.contiguous(memory_format=torch.channels_last_3d)
    return y


def channelwise_dgrad_plain(dy, weight, x_shape, stride, padding, dtype):
    """dx in `dtype` (x's): the gradient of the forward's input, summed in
    float32 over dy and the rounded weight, rounded once."""
    st = _sum_dtype(dtype)
    return torch.nn.grad.conv3d_input(
        list(x_shape), _rounded(weight, dtype), dy.to(st), stride, padding,
        1, int(x_shape[1])).to(dtype)


def channelwise_wgrad_plain(x, dy, weight_shape, stride, padding):
    """dW, float32 (float64 for a float64 x) [C, 1, kt, kh, kw]: the sum of
    dy times x shifted by each tap."""
    st = _sum_dtype(x.dtype)
    return torch.nn.grad.conv3d_weight(
        x.to(st), list(weight_shape), dy.to(st), stride, padding, 1,
        int(x.shape[1]))


# -------------------------------------------------------------- plans ----

def words(c, dtype) -> int:
    """32-bit words of a position's channels (2 bf16 or 1 float32 a
    word); raises where C does not fill whole words."""
    per = 4 // dtype.itemsize
    if c % per:
        raise ValueError(f"{c} channels of {dtype}: the kernels take whole "
                         f"32-bit words, an even C in bf16")
    return c // per


def gather_plan(n, out_thw, cw, kind_, which):
    """The forward's ("fwd") or the data gradient's ("dgrad") cut: a
    thread per channel word and tile of (rh, rw) output positions of one
    clip, GATHER_THREADS a block."""
    rh, rw = TILES[which][kind_]
    _, ho, wo = out_thw
    threads = n * math.ceil(ho / rh) * math.ceil(wo / rw) * cw
    return {"rh": rh, "rw": rw, "threads": threads,
            "blocks": math.ceil(threads / GATHER_THREADS)}


def wgrad_plan(n, dy_thw, cw, kind_, sms=132):
    """The weight gradient's cut: slabs of `csw` channel words (the fewest
    slabs of at most SLAB_WORDS words, or up to twice as many where that
    divides cw exactly), `lanes` threads per word in a block, `parts`
    blocks per slab taking the items (tiles of (rh, rw) dy positions of
    one clip) in turn: about BLOCKS_PER_SM x sms blocks in all, each
    leaving one float32 partial per channel and tap."""
    rh, rw = TILES["wgrad"][kind_]
    _, ho, wo = dy_thw
    items = n * math.ceil(ho / rh) * math.ceil(wo / rw)
    slabs = math.ceil(cw / SLAB_WORDS)
    slabs = next((s for s in range(slabs, 2 * slabs + 1) if cw % s == 0),
                 slabs)
    csw = math.ceil(cw / slabs)
    lanes = max(1, THREADS // csw)
    parts = max(1, min(math.ceil(items / lanes),
                       round(BLOCKS_PER_SM * sms / slabs)))
    return {"rh": rh, "rw": rw, "slabs": slabs, "csw": csw, "lanes": lanes,
            "parts": parts, "items": items}


# --------------------------------------------------------------- CUDA ----

def _check_cuda(t, what):
    if t.device.type != "cuda":
        raise ValueError(f"{what} needs CUDA tensors, got {t.device}")
    if t.dtype not in DTYPES:
        raise ValueError(f"{what}: {t.dtype} is not one of {DTYPES}")
    if not t.is_contiguous(memory_format=torch.channels_last_3d):
        raise ValueError(f"{what}: the tensor must be contiguous in "
                         f"channels-last-3d memory")
    if t.data_ptr() % 4:
        raise ValueError(f"{what}: the tensor must be 4-byte aligned")


def _master(weight):
    """The weight as the kernels read it: float32 [C][taps], contiguous
    (a float32 parameter as it is; the kernels round it to x's dtype)."""
    if weight.dtype == torch.float32 and weight.is_contiguous():
        return weight
    return weight.detach().float().contiguous()


def _geometry(src_shape, out_shape, cw):
    n, _, ts, hs, ws = src_shape
    _, _, to, ho, wo = out_shape
    return (n, ts, hs, ws, to, ho, wo, cw)


@functools.lru_cache(maxsize=None)
def _gather_args(src_shape, out_shape, dtype, kind_, which):
    """The gather entry point's integer arguments and its plan, once per
    signature."""
    cw = words(src_shape[1], dtype)
    plan = gather_plan(src_shape[0], out_shape[2:], cw, kind_, which)
    return ((*_geometry(src_shape, out_shape, cw), kind_,
             int(which == "dgrad"), plan["rh"], plan["rw"]), plan)


def _gather(src, weight, out, kind_, which, what):
    args, plan = _gather_args(tuple(src.shape), tuple(out.shape), src.dtype,
                              kind_, which)
    lib = _build.library()
    fn = (lib.zsvc_channelwise_gather_f32 if src.dtype == torch.float32
          else lib.zsvc_channelwise_gather_bf16)
    w = _master(weight)
    wt = torch.empty(w.numel(), dtype=torch.float32, device=w.device)
    _build.launch(fn, (src.data_ptr(), w.data_ptr(), wt.data_ptr(),
                       out.data_ptr(), *args), src.device, what, plan)
    return w, wt  # alive until the launch is queued


def channelwise_fwd_cuda(x, weight, stride, padding):
    """The forward as one call of its two kernels (the weights tap-major,
    then the gather); same contract as channelwise_fwd_plain, on a
    channels-last-3d CUDA x."""
    k = check_args(x, weight, stride, padding)
    _check_cuda(x, "channelwise_fwd_cuda")
    y = torch.empty(output_shape(tuple(x.shape), tuple(weight.shape),
                                 _triple(stride), _triple(padding)),
                    dtype=x.dtype, device=x.device,
                    memory_format=torch.channels_last_3d)
    if y.numel():
        _gather(x, weight, y, k, "fwd", "channel-wise conv")
    with _count_lock:
        channelwise_fwd_cuda.launches += 1
    return y


channelwise_fwd_cuda.launches = 0


def channelwise_dgrad_cuda(dy, weight, x_shape, stride, padding):
    """dx (dy's dtype, channels-last-3d) as one call of its two kernels
    (the weights tap-major, then the transposed gather); same contract as
    channelwise_dgrad_plain, on a channels-last-3d CUDA dy."""
    k = kind(weight.shape, stride, padding)
    _check_cuda(dy, "channelwise_dgrad_cuda")
    if tuple(dy.shape) != output_shape(tuple(x_shape), tuple(weight.shape),
                                       _triple(stride), _triple(padding)):
        raise ValueError(f"dy {tuple(dy.shape)} is not the output of x "
                         f"{tuple(x_shape)}")
    dx = torch.empty(tuple(x_shape), dtype=dy.dtype, device=dy.device,
                     memory_format=torch.channels_last_3d)
    if dx.numel():
        _gather(dy, weight, dx, k, "dgrad", "channel-wise conv backward")
    with _count_lock:
        channelwise_dgrad_cuda.launches += 1
    return dx


channelwise_dgrad_cuda.launches = 0


def channelwise_wgrad_cuda(x, dy, weight_shape, stride, padding):
    """dW, float32 [C, 1, kt, kh, kw], as one call of the two kernels (the
    partials' scratch from torch.empty); same contract as
    channelwise_wgrad_plain, on channels-last-3d CUDA x and dy."""
    k = kind(weight_shape, stride, padding)
    _check_cuda(x, "channelwise_wgrad_cuda")
    _check_cuda(dy, "channelwise_wgrad_cuda")
    if (dy.dtype != x.dtype or tuple(dy.shape) != output_shape(
            tuple(x.shape), tuple(weight_shape), _triple(stride),
            _triple(padding))):
        raise ValueError(f"dy {dy.dtype} {tuple(dy.shape)} is not the "
                         f"output of x {x.dtype} {tuple(x.shape)}")
    c, taps = int(weight_shape[0]), math.prod(weight_shape[2:])
    out = torch.empty((c, 1, *weight_shape[2:]), dtype=torch.float32,
                      device=x.device)
    if x.numel() == 0 or dy.numel() == 0:
        out.zero_()
    else:
        args, plan = _wgrad_args(tuple(x.shape), tuple(dy.shape), x.dtype,
                                 k, _sm_count(x.device))
        partial = torch.empty(plan["parts"] * c * taps, dtype=torch.float32,
                              device=x.device)
        lib = _build.library()
        fn = (lib.zsvc_channelwise_wgrad_f32 if x.dtype == torch.float32
              else lib.zsvc_channelwise_wgrad_bf16)
        _build.launch(fn, (x.data_ptr(), dy.data_ptr(), partial.data_ptr(),
                           out.data_ptr(), *args),
                      x.device, "channel-wise conv weight gradient", plan)
    with _count_lock:
        channelwise_wgrad_cuda.launches += 1
    return out


channelwise_wgrad_cuda.launches = 0


@functools.lru_cache(maxsize=None)
def _wgrad_args(x_shape, dy_shape, dtype, kind_, sms):
    """The weight gradient entry point's integer arguments and its plan,
    once per signature."""
    cw = words(x_shape[1], dtype)
    plan = wgrad_plan(x_shape[0], dy_shape[2:], cw, kind_, sms)
    return ((*_geometry(x_shape, dy_shape, cw), kind_, plan["rh"],
             plan["rw"], plan["csw"], plan["lanes"], plan["parts"]), plan)

_sms = {}


def _sm_count(device):
    i = device.index if device.index is not None else (
        torch.cuda.current_device())
    if i not in _sms:
        _sms[i] = torch.cuda.get_device_properties(i).multi_processor_count
    return _sms[i]


# ----------------------------------------------------------------- op ----

class _ChannelwiseConv3d(torch.autograd.Function):
    """The conv with its hand-written backward: the kernels on CUDA
    tensors, the plain versions on CPU tensors. Saves x and the weight."""

    @staticmethod
    def forward(ctx, x, weight, stride, padding):
        if x.device.type == "cuda":
            y = channelwise_fwd_cuda(x, weight, stride, padding)
        elif x.device.type == "cpu":
            y = channelwise_fwd_plain(x, weight, stride, padding)
        else:
            raise ValueError(f"no channel-wise conv for device {x.device}")
        ctx.save_for_backward(x, weight)
        ctx.conv = (stride, padding)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        stride, padding = ctx.conv
        dx = dw = None
        if x.device.type == "cuda":
            dy = dy.contiguous(memory_format=torch.channels_last_3d)
            if ctx.needs_input_grad[0]:
                dx = channelwise_dgrad_cuda(dy.to(x.dtype), weight, x.shape,
                                            stride, padding)
            if ctx.needs_input_grad[1]:
                dw = channelwise_wgrad_cuda(x, dy.to(x.dtype), weight.shape,
                                            stride, padding)
        else:
            if ctx.needs_input_grad[0]:
                dx = channelwise_dgrad_plain(dy, weight, x.shape, stride,
                                             padding, x.dtype)
            if ctx.needs_input_grad[1]:
                dw = channelwise_wgrad_plain(x, dy.to(x.dtype), weight.shape,
                                             stride, padding)
        if dw is not None:
            dw = dw.to(weight.dtype)
        return dx, dw, None, None


def channelwise_conv3d(x, weight, stride=1, padding=0, bias=None):
    """The channel-wise conv of x [N, C, T, H, W] by weight [C, 1, kt, kh,
    kw] (any float dtype; rounded to x's), differentiable in both; raises
    on a bias and on a kernel, stride or padding X3D does not take."""
    check_args(x, weight, stride, padding, bias)
    return _ChannelwiseConv3d.apply(x, weight, _triple(stride),
                                    _triple(padding))
