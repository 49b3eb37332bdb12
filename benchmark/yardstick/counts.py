"""Frozen arithmetic: FLOPs from shapes, the bytes and operations of a K2
epilogue, the bound a kernel's work sets on the card, the grouping of
device kernels by kind, and the published peaks of one NVIDIA H100 SXM.

`epilogue_bytes_flops` and `bound_seconds` are copies of chip_smoke.py's
epilogue_bytes_flops and bound; `kind` of tools/profile_train.py's kind,
with NCCL's kernels and the pools as kinds of their own.
Later changes to the program do not change these.
"""

from __future__ import annotations

import math

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
BF16_FLOPS_PER_S = 989e12
F32_FLOPS_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12


def conv_flops(conv, clips: int) -> int:
    """2 x multiply-adds of one conv over `clips` clips (torch's
    flop_counter convention): each output reads cin / groups channels."""
    out = conv.cout * math.prod(conv.out_thw)
    return (2 * clips * out * (conv.cin // conv.groups)
            * math.prod(conv.kernel))


def forward_flops(convs, linears, clips: int) -> int:
    """Forward FLOPs of the convs and linears over `clips` clips (the
    head's linears run once a clip: one clip a video in training)."""
    return (sum(conv_flops(c, clips) for c in convs)
            + sum(2 * clips * lin.fin * lin.fout for lin in linears))


def train_flops(convs, linears, clips: int) -> int:
    """Forward plus backward: three times the forward (recomputation not
    counted)."""
    return 3 * forward_flops(convs, linears, clips)


def epilogue_bytes_flops(shape, esize, res, relu, backward):
    """Bytes K2 must move for one epilogue (every operand once) and its
    float32 operations."""
    n = math.prod(shape)
    if backward:  # reads x, dy (+ y under relu); writes dx (+ g)
        passes, flops = 3 + int(relu) + int(res), 7 + int(relu)
    else:         # reads x (+ r); writes y
        passes, flops = 2 + int(res), 2 + int(res) + int(relu)
    return n * esize * passes, n * flops


def bound_seconds(nbytes, flops, peak=F32_FLOPS_PER_S) -> float:
    """The least time the card could take: bytes at the published memory
    rate against operations at the published peak of their type."""
    return max(nbytes / HBM_BYTES_PER_S, flops / peak)


def k2_step_bound_seconds(epilogues, clips: int, esize: int = 2) -> float:
    """The bound of one train step's K2 launches: every epilogue forward
    and backward at `clips` clips of `esize`-byte activations."""
    total = 0.0
    for e in epilogues:
        shape = (clips, *e.thw, e.channels)
        for backward in (False, True):
            total += bound_seconds(*epilogue_bytes_flops(
                shape, esize, e.residual, e.relu, backward))
    return total


def kind(name: str) -> str:
    low = name.lower()
    if "bn_bwd" in low:
        return "K2 backward"
    if "bn_apply_relu" in low:
        return "K2 forward"
    if "video_transform" in low:
        return "K1"
    if "nccl" in low:
        return "NCCL"
    if "multi_tensor_apply" in low:
        return "Adam (foreach)"
    if "memcpy" in low or "memset" in low:
        return "copies and memsets"
    if "wgrad" in low:
        return "conv backward (weights)"
    if "dgrad" in low:
        return "conv backward (data)"
    if any(k in low for k in ("padding", "nchwtonhwc", "nhwctonchw",
                              "transpose", "tensortransform")):
        return "cuDNN layout and padding"
    if any(k in low for k in ("fprop", "xmma", "implicit", "cudnn",
                              "cutlass", "gemm", "conv")):
        return "conv forward and other GEMMs"
    if "pool" in low:
        return "pooling"
    if "reduce" in low:
        return "reductions"
    if "elementwise" in low:
        return "elementwise"
    return "other"
