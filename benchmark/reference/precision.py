"""The control's lower precision: the configuration computes its convs and
holds its activations in bfloat16, and the nearest precision below is fp8.
`fp8` rounds a tensor (a conv's input, weight or output, a block's output)
to float8 e4m3 with one scale a tensor (its largest magnitude at e4m3's
largest finite value), and the gradient that flows back through it to
float8 e5m2 the same way, as fp8 training does; the products accumulate in
float32, as fp8 tensor cores accumulate.
"""

from __future__ import annotations

import torch

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def _round(t: torch.Tensor, dtype, top: float) -> torch.Tensor:
    amax = t.detach().abs().amax().float()
    scale = torch.where(amax > 0, amax / top, torch.ones_like(amax))
    return ((t.float() / scale).to(dtype).float() * scale).to(t.dtype)


class _FP8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return _round(t, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, E5M2_MAX)


def fp8(t: torch.Tensor) -> torch.Tensor:
    return _FP8.apply(t)



INT8_MAX = 127.0


class _Int8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        amax = t.detach().abs().amax().float()
        scale = torch.where(amax > 0, amax / INT8_MAX, torch.ones_like(amax))
        return (torch.round(t.float() / scale).clamp_(-INT8_MAX, INT8_MAX)
                * scale).to(t.dtype)

    @staticmethod
    def backward(ctx, g):
        return g


def int8(t: torch.Tensor) -> torch.Tensor:
    """Symmetric int8 with one scale a tensor (the other precision the
    contract allows below bf16; the gradient passes straight through)."""
    return _Int8.apply(t)
