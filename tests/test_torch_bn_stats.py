"""The BN statistics' two ops (ops/bn_stats.py) on the CPU: the plain
sums against the float32 formulas they replaced in models/layers.
bn_statistics and against float64, their gradient against torch.autograd of
the same sums, the copy of the shift the op keeps for the backward; the
plain moments bit for bit the [C]-sized PyTorch ops they replaced, their
gradient against torch.autograd of those ops; the device dispatch and the
refusals; bn_statistics' outputs, and its gradient through both ops,
against float64. The
CUDA kernels are compared with the plain versions on the card, in
tests/test_torch_cuda.py; bn_statistics with the JAX package's in
tests/test_torch_train.py."""

import numpy as np
import pytest
import torch

from zeroshotvideoclassification_tpu_torch.models import layers as L
from zeroshotvideoclassification_tpu_torch.ops.bn_stats import (
    bn_moments,
    bn_moments_cuda,
    bn_moments_grad_plain,
    bn_moments_plain,
    bn_sums,
    bn_sums_cuda,
    bn_sums_grad_cuda,
    bn_sums_grad_plain,
    bn_sums_plain,
)

SHAPES = [(2, 3, 4, 5, 7), (300, 45), (1, 2, 1, 230)]


def _operands(shape, dtype, offset=0.0, seed=0):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = (rng.normal(size=shape) * rng.uniform(0.3, 2, c) + offset
         + rng.normal(size=c))
    m0 = offset + rng.normal(size=c)
    return (torch.from_numpy(x.astype(np.float32)).to(dtype),
            torch.from_numpy(m0.astype(np.float32)))


@pytest.mark.parametrize("offset", [0.0, 300.0])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_sums_are_the_float32_formulas(shape, dtype, offset):
    """S and Q bit for bit the formulas bn_statistics took before the op
    (s = x - m0 by promotion, s.sum, torch.square(s).sum), within float32
    of float64, and m0 copied as the third row."""
    x, m0 = _operands(shape, dtype, offset)
    out = bn_sums_plain(x, m0)
    dims = tuple(range(x.dim() - 1))
    s = x - m0
    assert out.dtype == torch.float32 and out.shape == (3, shape[-1])
    assert torch.equal(out[0], s.sum(dims))
    assert torch.equal(out[1], torch.square(s).sum(dims))
    assert torch.equal(out[2], m0) and out[2].data_ptr() != m0.data_ptr()
    s64 = (x.double() - m0.double()).reshape(-1, shape[-1])
    np.testing.assert_allclose(out[0].numpy(), s64.sum(0).numpy(),
                               atol=1e-5 * float(s64.abs().sum()))
    np.testing.assert_allclose(out[1].numpy(), (s64 ** 2).sum(0).numpy(),
                               rtol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_gradient_matches_autograd_of_the_sums(shape, dtype):
    """dx through the op, x's dtype, against torch.autograd of
    [sum(x - m0), sum((x - m0)^2)] (float32 rtol 1e-5: autograd orders the
    products of the square's backward another way) and against
    bn_sums_grad_plain bit for bit."""
    x, m0 = _operands(shape, dtype, seed=1)
    dsums = torch.from_numpy(np.random.default_rng(2).normal(
        size=(2, shape[-1])).astype(np.float32))
    dims = tuple(range(x.dim() - 1))
    with torch.enable_grad():
        xa = x.clone().requires_grad_()
        (dx,) = torch.autograd.grad(bn_sums(xa, m0), xa, dsums)
        xb = x.clone().requires_grad_()
        s = xb - m0
        want = torch.stack([s.sum(dims), torch.square(s).sum(dims)])
        (dx_want,) = torch.autograd.grad(want, xb, dsums)
    assert dx.dtype == dtype and dx.shape == x.shape
    assert torch.equal(dx, bn_sums_grad_plain(x, m0, dsums))
    if dtype == torch.float32:
        torch.testing.assert_close(dx, dx_want, rtol=1e-5,
                                   atol=1e-5 * float(dx_want.abs().max()))
    else:  # both round the float32 gradient to bf16 once
        assert float((dx.float() - dx_want.float()).abs().max()) <= (
            2 ** -7 * float(dx_want.float().abs().max()))


def test_backward_uses_the_shift_of_the_forward():
    """BatchNorm3d moves its running mean in place between bn_statistics
    and the backward: the op's gradient is the one of the m0 the forward
    read."""
    x, m0 = _operands((4, 3, 6), torch.float32, seed=3)
    dsums = torch.ones(2, 6)
    want = bn_sums_grad_plain(x, m0, dsums)
    with torch.enable_grad():
        xr = x.clone().requires_grad_()
        sums = bn_sums(xr, m0)
        m0.add_(5.0)  # as running_mean.copy_(new_mean) does
        (dx,) = torch.autograd.grad(sums, xr, dsums)
    assert torch.equal(dx, want)


def test_dispatch_and_refusals():
    x, m0 = _operands((3, 5), torch.float32)
    before = (bn_sums_cuda.launches, bn_sums_grad_cuda.launches)
    with torch.enable_grad():
        xr = x.clone().requires_grad_()
        bn_sums(xr, m0).sum().backward()
    assert (bn_sums_cuda.launches, bn_sums_grad_cuda.launches) == before
    with pytest.raises(ValueError, match="needs CUDA"):
        bn_sums_cuda(x, m0)
    with pytest.raises(ValueError, match="needs CUDA"):
        bn_sums_grad_cuda(x, m0, torch.zeros(2, 5))
    with pytest.raises(ValueError, match="m0 must be float32"):
        bn_sums(x, m0.double())
    with pytest.raises(ValueError, match="m0 must be float32"):
        bn_sums(x, m0[:4])
    with pytest.raises(ValueError, match="x must be one of"):
        bn_sums(x.half(), m0)
    with pytest.raises(ValueError, match="no BN sums for device meta"):
        bn_sums(x.to("meta"), m0.to("meta"))


@pytest.mark.parametrize("offset", [0.0, 300.0])
def test_bn_statistics_gradient_matches_float64(offset):
    """The gradient of x through mean and var (the op's backward and the
    [C]-sized ops around it) against autograd of the same statistics in
    float64, shifted by a running mean near the batch's."""
    x, m0 = _operands((3, 4, 5, 6), torch.float32, offset, seed=4)
    v0 = torch.rand(6) + 0.5
    rng = np.random.default_rng(5)
    gm, gv = (torch.from_numpy(rng.normal(size=6).astype(np.float32))
              for _ in range(2))
    with torch.enable_grad():
        xr = x.clone().requires_grad_()
        mean, var, _, _ = L.bn_statistics(xr, m0, v0)
        (dx,) = torch.autograd.grad((mean * gm + var * gv).sum(), xr)
        x64 = x.double().requires_grad_()
        flat = x64.reshape(-1, 6)
        want = (flat.mean(0) * gm.double()
                + flat.var(0, unbiased=False) * gv.double()).sum()
        (dx64,) = torch.autograd.grad(want, x64)
    torch.testing.assert_close(dx.double(), dx64, rtol=1e-4,
                               atol=1e-4 * float(dx64.abs().max()))



@pytest.mark.parametrize("offset", [0.0, 300.0])
@pytest.mark.parametrize("shape", [(3, 4, 5, 6), (1, 6)])
def test_bn_statistics_from_the_sums_match_float64(shape, offset):
    """mean, var and the running statistics' next values from the op's
    sums and the [C]-sized ops after it, against float64 statistics of the
    same batch (one row: the unbiased factor clamps to 1); mean and var
    carry gradients, new_mean and new_var do not."""
    x, m0 = _operands(shape, torch.float32, offset, seed=8)
    v0 = torch.rand(6, generator=torch.Generator().manual_seed(9)) + 0.5
    with torch.enable_grad():
        mean, var, new_mean, new_var = L.bn_statistics(
            x.clone().requires_grad_(), m0, v0, momentum=0.1)
    assert mean.requires_grad and var.requires_grad
    assert not new_mean.requires_grad and not new_var.requires_grad
    flat = x.double().reshape(-1, 6)
    n = flat.shape[0]
    mean64, var64 = flat.mean(0), flat.var(0, unbiased=False)
    unbiased = var64 * n / max(n - 1, 1)
    scale = float(flat.abs().max())
    for got, want, atol in (
            (mean, mean64, 1e-6 * scale),
            (var, var64, 1e-6 * scale ** 2),
            (new_mean, 0.9 * m0.double() + 0.1 * mean64, 1e-6 * scale),
            (new_var, 0.9 * v0.double() + 0.1 * unbiased,
             1e-6 * scale ** 2)):
        assert got.dtype == torch.float32 and got.shape == (6,)
        torch.testing.assert_close(got.detach().double(), want, rtol=1e-5,
                                   atol=atol)


def _old_moments(sums, n, m0, running_var, momentum):
    """bn_statistics' [C]-sized PyTorch ops before the moments op (its
    group branch: the count a tensor)."""
    s_mean, s_sq = (sums / n).unbind(0)
    mean = s_mean + m0
    var = torch.clamp_min(s_sq - s_mean * s_mean, 0.0)
    unbiased = var.detach() * (n / torch.clamp_min(n - 1.0, 1.0))
    return (mean, var, (1 - momentum) * m0 + momentum * mean.detach(),
            (1 - momentum) * running_var + momentum * unbiased)


def _moments_operands(c=7, rows=96, seed=6):
    rng = np.random.default_rng(seed)
    s = torch.from_numpy(rng.normal(size=(rows, c)).astype(np.float32))
    sums = torch.stack([s.sum(0), (s * s).sum(0)])
    sums[:, 0] = float("nan")  # passes, as through torch.clamp_min
    sums[1, 1] = 0.0  # d < 0: var clamps to 0 and passes no gradient
    m0 = torch.from_numpy(rng.normal(size=c).astype(np.float32))
    rv = torch.from_numpy(rng.uniform(0.5, 2, c).astype(np.float32))
    return sums, torch.tensor([float(rows)]), m0, rv


@pytest.mark.parametrize("rows", [96.0, 1.0])
def test_plain_moments_are_the_ops_they_replace(rows):
    sums, _, m0, rv = _moments_operands()
    n = torch.tensor([rows])
    out = bn_moments_plain(sums, n, m0, rv, 0.1)
    want = _old_moments(sums, n, m0, rv, 0.1)
    assert out.shape == (6, 7) and out.dtype == torch.float32
    for got, w in zip(out[:4], want):
        torch.testing.assert_close(got, w, rtol=0, atol=0, equal_nan=True)
    s_mean = sums[0] / n
    torch.testing.assert_close(out[4], s_mean, rtol=0, atol=0,
                               equal_nan=True)
    torch.testing.assert_close(out[5], sums[1] / n - s_mean * s_mean,
                               rtol=0, atol=0, equal_nan=True)
    assert float(out[1, 1]) == 0.0 and float(out[5, 1]) < 0


def test_moments_gradient_matches_autograd_of_the_ops_they_replace():
    """dsums through the op against torch.autograd of the replaced ops
    (rtol 1e-6: autograd may add dmean and the two products of s_mean^2
    in another order), and bn_moments_grad_plain's own values."""
    sums, n, m0, rv = _moments_operands()
    rng = np.random.default_rng(7)
    gm, gv = (torch.from_numpy(rng.normal(size=7).astype(np.float32))
              for _ in range(2))
    with torch.enable_grad():
        sa = sums.clone().requires_grad_()
        mean, var, new_mean, new_var = bn_moments(sa, n, m0, rv, 0.1)
        assert mean.requires_grad and var.requires_grad
        assert not new_mean.requires_grad and not new_var.requires_grad
        (got,) = torch.autograd.grad((mean * gm + var * gv).sum(), sa)
        sb = sums.clone().requires_grad_()
        mean, var, _, _ = _old_moments(sb, n, m0, rv, 0.1)
        (want,) = torch.autograd.grad((mean * gm + var * gv).sum(), sb)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0, equal_nan=True)
    saved = bn_moments_plain(sums, n, m0, rv, 0.1)[4:]
    assert torch.equal(got[:, 1:], bn_moments_grad_plain(gm, gv, saved,
                                                         n)[:, 1:])
    assert float(got[1, 1]) == 0.0  # d < 0: no gradient through var


def test_moments_dispatch_and_refusals():
    sums, n, m0, rv = _moments_operands()
    before = bn_moments_cuda.launches
    bn_moments(sums, n, m0, rv, 0.1)
    assert bn_moments_cuda.launches == before
    with pytest.raises(ValueError, match="the moments' kernels need CUDA"):
        bn_moments_cuda(sums, n, m0, rv, 0.1)
    with pytest.raises(ValueError, match="running_var must be float32"):
        bn_moments(sums, n, m0, rv[:3], 0.1)
    with pytest.raises(ValueError, match="sums must be float32"):
        bn_moments(sums.double(), n, m0, rv, 0.1)
    with pytest.raises(ValueError, match="n must be float32"):
        bn_moments(sums, n.double(), m0, rv, 0.1)
    with pytest.raises(ValueError, match="no BN moments for device meta"):
        bn_moments(sums.to("meta"), n.to("meta"), m0.to("meta"),
                   rv.to("meta"), 0.1)
