"""Frozen arithmetic of the channel-wise convs (groups = cin = cout, X3D's
3x3x3 and (5,1,1) convs): the bytes a train step's must move and the bound
that sets on the card, counted from a network's description (describe's
convs), whatever implements the conv.

Every operand once, in the activations' dtype: the forward reads x and
writes y, the data gradient reads dy and writes dx, the weight gradient
reads x and dy; the weights (27 or 5 numbers a channel) are left out. The
bound is those bytes at the published 3.35 TB/s: their operations, 2 x
27 multiply-adds an output, would take under half that time even at the
card's float32 peak without tensor cores.
"""

from __future__ import annotations

import math

from benchmark.yardstick import counts


def is_channelwise(conv) -> bool:
    return conv.groups > 1 and conv.groups == conv.cin == conv.cout


def input_thw(conv):
    """The conv's input shape: per axis the largest that gives its output
    (exact for even sizes at stride 2, as every cell's clip has)."""
    return tuple((o - 1) * s + k - 2 * p + s - 1 for o, s, k, p in zip(
        conv.out_thw, conv.stride, conv.kernel, conv.padding))


def step_bytes(convs, clips: int, esize: int = 2) -> int:
    """Bytes of every channel-wise conv of `convs`, forward and backward,
    over `clips` clips of `esize`-byte activations."""
    total = 0
    for c in convs:
        if is_channelwise(c):
            x = c.cin * math.prod(input_thw(c))
            y = c.cout * math.prod(c.out_thw)
            total += 3 * (x + y)  # forward, data gradient, weight gradient
    return total * clips * esize


def step_bound_seconds(convs, clips: int, esize: int = 2) -> float:
    """The least time the card could take for them."""
    return step_bytes(convs, clips, esize) / counts.HBM_BYTES_PER_S
