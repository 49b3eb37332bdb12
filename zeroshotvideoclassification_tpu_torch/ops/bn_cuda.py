"""K2 forward: the fused BatchNorm-apply (+ residual) (+ ReLU) epilogue.

    a = scale * rsqrt(var + eps);  b = bias - mean * a      (float32)
    y = [relu](x * a + b [+ residual])                      (float32, one
                                                             rounding to x.dtype)

bn_apply_relu_cuda launches csrc/bn_apply_relu.cu (which replaces the
forward of the TPU kernel zeroshotvideoclassification_tpu/ops/bn_pallas.py:
bn_apply_relu_pallas) and counts its launches in
`bn_apply_relu_cuda.launches`; bn_apply_relu_plain is the same function in
plain PyTorch; bn_apply_relu is the public op, which sends a CPU tensor to
the plain version and a CUDA tensor to the kernel.

Layout: x and residual are [..., C], the channel innermost — the JAX
package's layout, and the model's channels-last-3d activations seen through
a permuted view (models/layers.batchnorm_relu). The kernel needs them
contiguous and raises otherwise; the plain version takes any strides (a CPU
convolution may return another memory layout, e.g. single-threaded).
The backward half (training) is not ported yet.
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


def bn_apply_relu(x, scale, bias, mean, var, residual=None, relu=True,
                  eps=1e-5):
    """The epilogue on x's device: the plain version on the CPU, the kernel
    on a GPU."""
    if x.device.type == "cuda":
        return bn_apply_relu_cuda(x, scale, bias, mean, var, residual, relu,
                                  eps)
    if x.device.type == "cpu":
        return bn_apply_relu_plain(x, scale, bias, mean, var, residual, relu,
                                   eps)
    raise ValueError(f"no BN epilogue for device {x.device}")
