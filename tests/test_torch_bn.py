"""K2 forward, the fused BN-apply (+ residual) (+ ReLU) epilogue: the port's
plain version against the JAX package's Pallas kernel (interpret mode, as
tests/test_bn_pallas.py runs it) and against models/layers.batchnorm_relu,
the device dispatch and validation of the wrappers, and the eval-only BN
module. The CUDA kernel itself is compared with the plain version on the
card, in tests/test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zeroshotvideoclassification_tpu.models import layers as JL
from zeroshotvideoclassification_tpu.ops import bn_pallas
from zeroshotvideoclassification_tpu_torch.models import layers as L
from zeroshotvideoclassification_tpu_torch.ops.bn_cuda import (
    bn_apply_relu,
    bn_apply_relu_cuda,
    bn_apply_relu_plain,
)
from torch_helpers import bf16_ulps


@pytest.fixture
def interpret_pallas(monkeypatch):
    from jax.experimental import pallas as pl

    orig = pl.pallas_call

    def wrapped(*a, **kw):
        kw["interpret"] = True
        return orig(*a, **kw)

    monkeypatch.setattr(bn_pallas.pl, "pallas_call", wrapped)


def _operands(rng, shape, with_res):
    c = shape[-1]
    x = rng.normal(size=shape).astype(np.float32)
    res = rng.normal(size=shape).astype(np.float32) if with_res else None
    stats = (rng.uniform(0.5, 2.0, c), rng.normal(size=c),
             rng.normal(size=c), rng.uniform(0.3, 3.0, c))
    return x, res, [s.astype(np.float32) for s in stats]


def _t(a, device="cpu", dtype=torch.float32):
    return None if a is None else torch.from_numpy(a).to(device, dtype)


@pytest.mark.parametrize("c", [6, 45])
@pytest.mark.parametrize("with_res", [False, True])
@pytest.mark.parametrize("relu", [True, False])
def test_plain_matches_pallas_forward(interpret_pallas, rng, c, with_res,
                                      relu):
    x, res, stats = _operands(rng, (2, 3, 4, 8, c), with_res)
    want = bn_pallas.bn_apply_relu_pallas(
        jnp.asarray(x), *map(jnp.asarray, stats),
        None if res is None else jnp.asarray(res), relu, 1e-5)
    got = bn_apply_relu_plain(_t(x), *map(_t, stats), _t(res), relu, 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6,
                               rtol=0)


def test_plain_matches_pallas_forward_bf16(interpret_pallas, rng):
    """bf16 in and out, float32 inside, one rounding at the store: the
    port and the Pallas kernel round the same float32 value."""
    x, res, stats = _operands(rng, (2, 2, 2, 8, 45), True)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    rb = jnp.asarray(res).astype(jnp.bfloat16)
    want = bn_pallas.bn_apply_relu_pallas(xb, *map(jnp.asarray, stats), rb,
                                          True, 1e-5)
    got = bn_apply_relu_plain(
        torch.tensor(np.asarray(xb.astype(jnp.float32))).bfloat16(),
        *map(_t, stats),
        torch.tensor(np.asarray(rb.astype(jnp.float32))).bfloat16())
    assert got.dtype == torch.bfloat16
    assert bf16_ulps(got, torch.tensor(
        np.asarray(want.astype(jnp.float32)))) <= 1.0


@pytest.mark.parametrize("with_res", [False, True])
def test_layers_batchnorm_relu_matches_jax_eval(rng, with_res):
    """models/layers.batchnorm_relu (eval) against the JAX package's
    default batchnorm_relu(train=False) in float32. The two compute the
    same affine in two algebraic forms ((x - mean) * inv + bias there,
    x * a + b here), whose roundings differ by a few float32 ulps of the
    intermediates (|x * a|, |mean * a| <~ 10): hence 1e-5, not 2e-6."""
    x, res, (scale, bias, mean, var) = _operands(rng, (2, 3, 4, 8, 45),
                                                 with_res)
    want, _ = JL.batchnorm_relu(
        {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
        {"mean": jnp.asarray(mean), "var": jnp.asarray(var)},
        jnp.asarray(x), train=False,
        residual=None if res is None else jnp.asarray(res),
        compute_dtype=jnp.float32)
    to_ncdhw = (0, 4, 1, 2, 3)
    got = L.batchnorm_relu(
        _t(x).permute(to_ncdhw), _t(scale), _t(bias), _t(mean), _t(var),
        None if res is None else _t(res).permute(to_ncdhw), relu=True)
    assert tuple(got.shape) == (2, 45, 3, 4, 8)
    np.testing.assert_allclose(got.permute(0, 2, 3, 4, 1).numpy(),
                               np.asarray(want), atol=1e-5, rtol=0)


def test_batchnorm_relu_takes_any_cpu_layout(rng):
    """A CPU conv may return plain NCDHW memory instead of channels-last
    (single-threaded, it does): the CPU path gives the same values."""
    x, res, (scale, bias, mean, var) = _operands(rng, (2, 3, 4, 8, 45), True)
    stats = (_t(scale), _t(bias), _t(mean), _t(var))
    to_ncdhw = (0, 4, 1, 2, 3)
    last = L.batchnorm_relu(_t(x).permute(to_ncdhw), *stats,
                            _t(res).permute(to_ncdhw))
    plain = L.batchnorm_relu(_t(x).permute(to_ncdhw).contiguous(), *stats,
                             _t(res).permute(to_ncdhw).contiguous())
    assert plain.shape == last.shape
    torch.testing.assert_close(plain, last, atol=0, rtol=0)


def test_bn_module_is_eval_only(rng):
    bn = L.BatchNorm3d(8)
    x = torch.randn(2, 8, 2, 3, 3).to(memory_format=torch.channels_last_3d)
    with pytest.raises(NotImplementedError, match="train-mode"):
        bn(x)
    bn.eval()
    torch.testing.assert_close(bn(x, relu=True),
                               torch.relu(x) / np.sqrt(1 + 1e-5))
    assert set(bn.state_dict()) == {"weight", "bias", "running_mean",
                                    "running_var", "num_batches_tracked"}


def test_dispatch_on_cpu_is_the_plain_version(rng):
    x, res, stats = _operands(rng, (3, 5, 7), True)
    args = (_t(x), *map(_t, stats), _t(res))
    before = bn_apply_relu_cuda.launches
    assert torch.equal(bn_apply_relu(*args), bn_apply_relu_plain(*args))
    assert bn_apply_relu_cuda.launches == before


def test_cuda_wrapper_refuses_cpu_tensors(rng):
    x, _, stats = _operands(rng, (3, 5, 7), False)
    with pytest.raises(ValueError, match="CUDA"):
        bn_apply_relu_cuda(_t(x), *map(_t, stats))


def test_validation_rejects_bad_operands(rng):
    x, res, stats = _operands(rng, (3, 5, 7), True)
    xt, rt, st = _t(x), _t(res), [_t(s) for s in stats]
    with pytest.raises(ValueError, match="contiguous"):
        bn_apply_relu_cuda(xt.transpose(0, 1), *st)
    with pytest.raises(ValueError, match="contiguous"):
        bn_apply_relu_cuda(xt, *st, rt.transpose(0, 1).contiguous()
                           .transpose(0, 1))
    with pytest.raises(ValueError, match="x must be"):
        bn_apply_relu(xt.half(), *st)
    with pytest.raises(ValueError, match="scale"):
        bn_apply_relu(xt, st[0].double(), *st[1:])
    with pytest.raises(ValueError, match="var"):
        bn_apply_relu(xt, *st[:3], st[3][:6])
    with pytest.raises(ValueError, match="residual"):
        bn_apply_relu(xt, *st, rt.bfloat16())
    with pytest.raises(ValueError, match="residual"):
        bn_apply_relu(xt, *st, rt[:2])
