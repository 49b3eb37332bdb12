"""The BN statistics as two differentiable ops, which models/layers.
bn_statistics chains (with the sums and the count summed over the data
group in between, where there is one). For a [..., C] tensor x, a float32
[C] shift m0 (the running mean) and n rows (a float32 [1] tensor):

  bn_sums     S[c] = sum (x - m0[c]), Q[c] = sum (x - m0[c])^2 over every
              row (float32); backward dx = dS[c] + (x - m0[c]) * (2 dQ[c])
              (float32, one rounding to x's dtype)
  bn_moments  from [S, Q]: mean = S / n + m0, var = max(Q / n - (S / n)^2,
              0), and the running statistics' next values (1 - momentum) *
              m0 + momentum * mean and (1 - momentum) * running_var +
              momentum * var * n / max(n - 1, 1); backward [dS, dQ]
              from dmean and dvar

They port no TPU kernel: the JAX package leaves these statistics to XLA
(its models/layers.bn_statistics), which fuses both sums into one read of
x. In plain PyTorch they were a chain of full-size float32 ops, forward and
backward, with s = x - m0 saved for the backward, then a dozen [C]-sized
ops forward and eight autograd nodes backward a layer: at the train step's
64 clips the host launching those took longer than the device spends in
the sums (on four H100s, where the host sets the pace, a train step ran
15% slower with those ops). Now the sums read x once, their gradient
reads x once, the op saves only x and m0, and the [C]-sized rest is one
launch each way, reading n from the device.

  bn_sums, bn_moments
                     the public ops, torch.autograd.Functions on both
                     devices: CUDA tensors go to the kernels, CPU tensors to
                     the plain versions. Nothing falls back from a kernel to
                     a plain version. bn_sums saves x (the storage K2 saves
                     already) and m0's value at the forward: BatchNorm3d
                     moves its running mean in place before the backward
                     runs
  bn_sums_cuda       the sums' two kernels (csrc/bn_stats.cu): stage 1 on
                     K2 backward's plan (ops/bn_cuda.bwd_plan: the folded
                     [rows, m * C] view, 16 bytes a thread, at most 264
                     blocks) leaves one partial a block and channel, stage 2
                     adds them in a fixed order (bit-reproducible: the
                     graphs' parity with eager steps needs it). Bound by
                     bytes: x read once. One allocation for the partials,
                     one for the [3, C] result, one call. Launches counted
                     in `bn_sums_cuda.launches`
  sums_prepare       the same call split into its allocations and its
                     launch, for timing the launches alone
  bn_sums_grad_cuda  the gradient's kernel (same source), on K2 forward's
                     plan (ops/bn_cuda.fwd_plan). Bound by bytes: x read and
                     dx written once. Launches counted in
                     `bn_sums_grad_cuda.launches`
  grad_prepare       the same call split into its allocation and its launch
  bn_moments_cuda, bn_moments_grad_cuda
                     the moments' kernels, one thread a channel; launches
                     counted in `.launches` of each
  bn_sums_plain, bn_sums_grad_plain, bn_moments_plain, bn_moments_grad_plain
                     the same functions in plain PyTorch (float32 inside;
                     any strides), for the CPU and as the kernels' oracle:
                     the gradient and the moments bit for bit

bn_sums_cuda and bn_sums_plain return [3, C]: S, Q, and m0 as the forward
read it (the copy the op saves); bn_sums returns the first two rows.
bn_moments_cuda and bn_moments_plain return [6, C]: mean, var, new_mean,
new_var, then s_mean = S / n and d = Q / n - s_mean^2, which the backward
reads with n. The sums' kernels need x contiguous (channels innermost) and raise
otherwise.
"""

from __future__ import annotations

import threading

import torch

from zeroshotvideoclassification_tpu_torch import _build
from zeroshotvideoclassification_tpu_torch.ops.bn_cuda import (
    DTYPES,
    bwd_plan,
    fwd_plan,
)

_count_lock = threading.Lock()


def check_sums_args(x, m0):
    """Validate the op's operands; -> C."""
    if x.dtype not in DTYPES:
        raise ValueError(f"x must be one of {DTYPES}, got {x.dtype}")
    if x.dim() < 1:
        raise ValueError("x must be a [..., C] tensor")
    c = x.shape[-1]
    if m0.dtype != torch.float32 or tuple(m0.shape) != (c,):
        raise ValueError(f"m0 must be float32 [{c}], got {m0.dtype} "
                         f"{tuple(m0.shape)}")
    if m0.device != x.device:
        raise ValueError(f"m0 is on {m0.device}, x on {x.device}")
    return c


def _check_cuda(x, what):
    if x.device.type != "cuda":
        raise ValueError(f"{what} needs CUDA tensors, got {x.device}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous [..., C] (channels innermost) "
                         "for the kernel")


def bn_sums_plain(x, m0):
    """The sums as plain PyTorch ops (any device, any strides) -> float32
    [3, C]: S, Q and a copy of m0."""
    check_sums_args(x, m0)
    s = x.float() - m0
    dims = tuple(range(x.dim() - 1))
    return torch.stack([s.sum(dims), (s * s).sum(dims), m0])


def bn_sums_grad_plain(x, m0, dsums):
    """The gradient of x through the sums as plain PyTorch ops, float32
    [2, C] dsums (dS, dQ) -> dx in x's dtype."""
    check_sums_args(x, m0)
    s = x.float() - m0
    return (dsums[0] + s * (2.0 * dsums[1])).to(x.dtype)


def sums_prepare(x, m0):
    """Check the operands, allocate the partials and the result and plan the
    cut -> (launch, out): `launch()` enqueues both stages on the current
    stream and counts one launch; out (float32 [3, C]) holds S, Q and m0
    once it has run. x must be a contiguous CUDA tensor with n > 0."""
    c = check_sums_args(x, m0)
    _check_cuda(x, "bn_sums_cuda")
    n = x.numel()
    plan = bwd_plan(n, c, x.element_size(), x.data_ptr() % 16 == 0)
    blocks = plan["col_tiles"] * plan["chunks"]
    partial = torch.empty(2 * blocks * c, dtype=torch.float32,
                          device=x.device)
    out = torch.empty((3, c), dtype=torch.float32, device=x.device)
    lib = _build.library()
    fn = (lib.zsvc_bn_sums_f32 if x.dtype == torch.float32
          else lib.zsvc_bn_sums_bf16)
    args = (x.data_ptr(), m0.data_ptr(), partial.data_ptr(), out.data_ptr(),
            n, c, plan["wf"], plan["vec"], plan["threads"],
            plan["col_tiles"], plan["chunks"], plan["rows_per_chunk"])
    keep = (x, m0, partial)  # alive until the launch is queued

    def launch():
        _build.launch(fn, args, x.device, "bn_sums", plan)
        with _count_lock:
            bn_sums_cuda.launches += 1
        return keep

    return launch, out


def bn_sums_cuda(x, m0):
    """The sums as one call of the two CUDA kernels (none for an empty x):
    same contract as bn_sums_plain, on a contiguous CUDA x."""
    if x.numel() == 0:
        c = check_sums_args(x, m0)
        _check_cuda(x, "bn_sums_cuda")
        return torch.cat([x.new_zeros((2, c), dtype=torch.float32),
                          m0[None]])
    launch, out = sums_prepare(x, m0)
    launch()
    return out


bn_sums_cuda.launches = 0


def grad_prepare(x, m0, dsums):
    """Check the operands, allocate dx and plan the cut -> (launch, dx):
    `launch()` enqueues the kernel on the current stream and counts one
    launch. x must be a contiguous CUDA tensor with n > 0, dsums float32
    [2, C] on its device."""
    c = check_sums_args(x, m0)
    _check_cuda(x, "bn_sums_grad_cuda")
    if (dsums.dtype != torch.float32 or tuple(dsums.shape) != (2, c)
            or dsums.device != x.device):
        raise ValueError(f"dsums must be float32 [2, {c}] on {x.device}, "
                         f"got {dsums.dtype} {tuple(dsums.shape)} on "
                         f"{dsums.device}")
    dsums = dsums.contiguous()
    dx = torch.empty_like(x)
    plan = fwd_plan(x.numel(), c, x.element_size(),
                    x.data_ptr() % 16 == 0 and dx.data_ptr() % 16 == 0)
    lib = _build.library()
    fn = (lib.zsvc_bn_sums_grad_f32 if x.dtype == torch.float32
          else lib.zsvc_bn_sums_grad_bf16)
    args = (x.data_ptr(), m0.data_ptr(), dsums.data_ptr(), dx.data_ptr(),
            x.numel(), c, plan["wf"], plan["vec"], plan["threads"],
            plan["col_tiles"], plan["chunks"], plan["rows_per_chunk"])
    keep = (x, m0, dsums)  # alive until the launch is queued

    def launch():
        _build.launch(fn, args, x.device, "bn_sums backward", plan)
        with _count_lock:
            bn_sums_grad_cuda.launches += 1
        return keep

    return launch, dx


def bn_sums_grad_cuda(x, m0, dsums):
    """The gradient as one allocation and one launch of the CUDA kernel
    (none for an empty x); same contract as bn_sums_grad_plain, on a
    contiguous CUDA x."""
    if x.numel() == 0:
        check_sums_args(x, m0)
        return torch.empty_like(x)
    launch, dx = grad_prepare(x, m0, dsums)
    launch()
    return dx


bn_sums_grad_cuda.launches = 0


class _BNSums(torch.autograd.Function):
    """The sums with their hand-written backward: the kernels on CUDA
    tensors, the plain versions on CPU tensors. Saves x and m0's value at
    the forward."""

    @staticmethod
    def forward(ctx, x, m0):
        if x.device.type == "cuda":
            out = bn_sums_cuda(x, m0)
        elif x.device.type == "cpu":
            out = bn_sums_plain(x, m0)
        else:
            raise ValueError(f"no BN sums for device {x.device}")
        ctx.save_for_backward(x, out[2])
        return out[:2]

    @staticmethod
    def backward(ctx, dsums):
        x, m0 = ctx.saved_tensors
        grad = (bn_sums_grad_cuda if x.device.type == "cuda"
                else bn_sums_grad_plain)
        return grad(x, m0, dsums), None


def bn_sums(x, m0):
    """float32 [2, C]: the sums of s = x - m0 and of s^2 over every row of
    a [..., C] tensor x, on x's device; differentiable in x (m0 is a
    constant shift)."""
    return _BNSums.apply(x, m0)


# ------------------------------------------------------------- moments ----

def check_moments_args(sums, n, m0, running_var):
    """Validate the moments' operands; -> C."""
    c = sums.shape[-1]
    for name, v, shape in (("sums", sums, (2, c)), ("n", n, (1,)),
                           ("m0", m0, (c,)),
                           ("running_var", running_var, (c,))):
        if v.dtype != torch.float32 or tuple(v.shape) != shape:
            raise ValueError(f"{name} must be float32 {list(shape)}, got "
                             f"{v.dtype} {tuple(v.shape)}")
        if v.device != sums.device:
            raise ValueError(f"{name} is on {v.device}, sums on "
                             f"{sums.device}")
    return c


def bn_moments_plain(sums, n, m0, running_var, momentum):
    """The moments as plain PyTorch ops (any device) -> float32 [6, C]:
    mean, var, new_mean, new_var, s_mean, d. Divides by the count tensor:
    on a GPU a division by a Python number multiplies by its rounded
    inverse, and d's cancellation amplifies that."""
    check_moments_args(sums, n, m0, running_var)
    keep = 1 - momentum
    s_mean, s_sq = (sums / n).unbind(0)
    mean = s_mean + m0
    d = s_sq - s_mean * s_mean
    var = torch.clamp_min(d, 0.0)
    factor = n / torch.clamp_min(n - 1.0, 1.0)  # unbiased: at least 1 row
    return torch.stack([mean, var, keep * m0 + momentum * mean,
                        keep * running_var + momentum * (var * factor),
                        s_mean, d])


def bn_moments_grad_plain(dmean, dvar, saved, n):
    """The moments' gradient as plain PyTorch ops: float32 [C] dmean and
    dvar, the forward's saved [2, C] (s_mean, d) and the count -> dsums
    [2, C], in the order of autograd's nodes for bn_moments_plain's ops."""
    s_mean, d = saved
    dd = torch.where(d >= 0.0, dvar, torch.zeros_like(dvar))
    g = -dd * s_mean  # each factor of s_mean * s_mean
    return torch.stack([dmean + (g + g), dd]) / n


def _cuda_moments_operands(*tensors):
    for v in tensors:
        if v.device.type != "cuda":
            raise ValueError(f"the moments' kernels need CUDA tensors, got "
                             f"{v.device}")
    return [v.contiguous() for v in tensors]


def bn_moments_cuda(sums, n, m0, running_var, momentum):
    """The moments as one allocation and one launch of their CUDA kernel;
    same contract as bn_moments_plain, on CUDA tensors."""
    c = check_moments_args(sums, n, m0, running_var)
    sums, n, m0, running_var = _cuda_moments_operands(sums, n, m0,
                                                      running_var)
    out = torch.empty((6, c), dtype=torch.float32, device=sums.device)
    _build.launch(_build.library().zsvc_bn_moments,
                  (sums.data_ptr(), n.data_ptr(), m0.data_ptr(),
                   running_var.data_ptr(), 1 - momentum, momentum,
                   out.data_ptr(), c),
                  sums.device, "bn_moments")
    with _count_lock:
        bn_moments_cuda.launches += 1
    return out


bn_moments_cuda.launches = 0


def bn_moments_grad_cuda(dmean, dvar, saved, n):
    """The moments' gradient as one allocation and one launch of its CUDA
    kernel; same contract as bn_moments_grad_plain, on CUDA tensors."""
    c = saved.shape[-1]
    for name, v, shape in (("dmean", dmean, (c,)), ("dvar", dvar, (c,)),
                           ("saved", saved, (2, c)), ("n", n, (1,))):
        if v.dtype != torch.float32 or tuple(v.shape) != shape:
            raise ValueError(f"{name} must be float32 {list(shape)}, got "
                             f"{v.dtype} {tuple(v.shape)}")
    dmean, dvar, saved, n = _cuda_moments_operands(dmean, dvar, saved, n)
    dsums = torch.empty((2, c), dtype=torch.float32, device=saved.device)
    _build.launch(_build.library().zsvc_bn_moments_grad,
                  (dmean.data_ptr(), dvar.data_ptr(), saved.data_ptr(),
                   n.data_ptr(), dsums.data_ptr(), c),
                  saved.device, "bn_moments backward")
    with _count_lock:
        bn_moments_grad_cuda.launches += 1
    return dsums


bn_moments_grad_cuda.launches = 0


class _BNMoments(torch.autograd.Function):
    """The moments with their hand-written backward: the kernels on CUDA
    tensors, the plain versions on CPU tensors. Saves s_mean, d and n."""

    @staticmethod
    def forward(ctx, sums, n, m0, running_var, momentum):
        if sums.device.type == "cuda":
            out = bn_moments_cuda(sums, n, m0, running_var, momentum)
        elif sums.device.type == "cpu":
            out = bn_moments_plain(sums, n, m0, running_var, momentum)
        else:
            raise ValueError(f"no BN moments for device {sums.device}")
        ctx.save_for_backward(out[4:], n)
        mean, var, new_mean, new_var = out[:4].unbind(0)
        ctx.mark_non_differentiable(new_mean, new_var)
        return mean, var, new_mean, new_var

    @staticmethod
    def backward(ctx, dmean, dvar, _new_mean, _new_var):
        saved, n = ctx.saved_tensors
        grad = (bn_moments_grad_cuda if saved.device.type == "cuda"
                else bn_moments_grad_plain)
        return grad(dmean, dvar, saved, n), None, None, None, None


def bn_moments(sums, n, m0, running_var, momentum: float):
    """(mean, var, new_mean, new_var), float32 [C], from the float32 [2, C]
    sums of s = x - m0 and s^2 over n rows (float32 [1] on sums' device: it
    is read there, so a count summed over a data group needs no host
    sync); mean and var differentiable in sums, new_mean and new_var not
    (n, running_var and m0 are constants)."""
    return _BNMoments.apply(sums, n, m0, running_var, float(momentum))
