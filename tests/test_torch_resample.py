"""K1, the fused video transform: the port's plain version against the JAX
package's XLA gather and its Pallas kernel (interpret mode, as
tests/test_resample_pallas.py runs it), the device dispatch and validation
of the wrappers, and the device batch built from a shared HostPipeline
batch. The CUDA kernel itself is compared with the plain version on the
card, in tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import jax.numpy as jnp
import zeroshotvideoclassification_tpu.ops.resample_pallas as rp
from zeroshotvideoclassification_tpu.data.transform_params import (
    make_transform_params,
    resample_indices,
)
from zeroshotvideoclassification_tpu.ops.resample import (
    fused_video_transform as jax_transform,
)
from zeroshotvideoclassification_tpu_torch.ops.resample import (
    fused_video_transform,
)
from zeroshotvideoclassification_tpu_torch.ops.resample_cuda import (
    fused_video_transform_cuda,
    video_transform,
)
from torch_helpers import bf16_ulps


@pytest.fixture
def interpret_pallas(monkeypatch):
    orig = pl.pallas_call

    def patched(*args, **kw):
        kw["interpret"] = True
        return orig(*args, **kw)

    monkeypatch.setattr(rp.pl, "pallas_call", patched)


def assert_bf16_within_one_ulp(got, want):
    assert bf16_ulps(torch.as_tensor(np.asarray(got, np.float32)),
                     torch.as_tensor(np.asarray(want, np.float32))) <= 1.0


def _case(rng, b=2, t=3, hc=160, wc=200, validation=False, flip=None):
    canvas = rng.integers(0, 256, (b, t, hc, wc, 3), dtype=np.uint8)
    p = make_transform_params(np.array([[150, 190]] * b), 112, validation,
                              rng)
    if flip is not None:
        p.flip[:] = flip
    return canvas, resample_indices(p, 112).astuple()


def _torch_args(canvas, idx, device="cpu"):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in (canvas, *idx)]


@pytest.mark.parametrize("validation,flip", [(False, None), (True, True),
                                             (True, False)])
def test_plain_matches_jax_gather_f32(rng, validation, flip):
    canvas, idx = _case(rng, validation=validation, flip=flip)
    want = np.asarray(jax_transform(canvas, *idx))
    got = fused_video_transform(*_torch_args(canvas, idx)).numpy()
    assert got.shape == want.shape == (2, 3, 112, 112, 3)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_plain_matches_jax_gather_bf16(rng):
    canvas, idx = _case(rng, flip=[True, False])
    want = np.asarray(jax_transform(canvas, *idx, out_dtype=jnp.bfloat16))
    got = fused_video_transform(*_torch_args(canvas, idx),
                                out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    assert_bf16_within_one_ulp(got.float().numpy(), want.astype(np.float32))


@pytest.mark.parametrize("validation,flip", [(False, None), (True, True)])
def test_plain_matches_pallas_kernel(interpret_pallas, rng, validation, flip):
    canvas, idx = _case(rng, validation=validation, flip=flip)
    want = np.asarray(rp.fused_video_transform_pallas(canvas, *idx))
    got = fused_video_transform(*_torch_args(canvas, idx)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_dispatch_on_cpu_is_the_plain_version(rng):
    canvas, idx = _case(rng, b=1, t=2)
    args = _torch_args(canvas, idx)
    before = fused_video_transform_cuda.launches
    assert torch.equal(video_transform(*args), fused_video_transform(*args))
    assert fused_video_transform_cuda.launches == before


def test_cuda_wrapper_refuses_cpu_tensors(rng):
    canvas, idx = _case(rng, b=1, t=1)
    with pytest.raises(ValueError, match="CUDA"):
        fused_video_transform_cuda(*_torch_args(canvas, idx))


def test_validation_rejects_bad_operands(rng):
    canvas, idx = _case(rng, b=1, t=2)
    args = _torch_args(canvas, idx)
    with pytest.raises(ValueError, match="uint8"):
        video_transform(args[0].float(), *args[1:])
    with pytest.raises(ValueError, match="contiguous"):
        fused_video_transform_cuda(args[0].transpose(2, 3), *args[1:])
    with pytest.raises(ValueError, match="y0"):
        video_transform(args[0], args[1].long(), *args[2:])
    with pytest.raises(ValueError, match="wx"):
        video_transform(*args[:-1], args[-1][:, :50].contiguous())
    with pytest.raises(ValueError, match="out_dtype"):
        video_transform(*args, out_dtype=torch.float16)


def test_plain_takes_any_strides(rng):
    """The plain version reads a strided canvas as it is; only the kernel
    needs contiguous operands."""
    canvas, idx = _case(rng, b=2, t=2)
    args = _torch_args(canvas, idx)
    strided = torch.from_numpy(np.ascontiguousarray(
        canvas.transpose(1, 0, 2, 3, 4))).transpose(0, 1)
    assert not strided.is_contiguous()
    assert torch.equal(video_transform(strided, *args[1:]),
                       video_transform(*args))


def test_device_batch_matches_jax_device_batch(tmp_path, rng):
    """The shared HostPipeline batch through both packages' device_batch."""
    from zeroshotvideoclassification_tpu.config import Config
    from zeroshotvideoclassification_tpu.data.datasets import VideoTable
    from zeroshotvideoclassification_tpu.data.pipeline import (
        HostPipeline,
        device_batch as jax_device_batch,
    )
    from zeroshotvideoclassification_tpu_torch.data.pipeline import (
        device_batch,
    )

    paths = []
    for i in range(3):
        p = tmp_path / f"v{i}.npy"
        np.save(p, rng.integers(0, 256, (10, 60, 80, 3), dtype=np.uint8))
        paths.append(str(p))
    cfg = Config(size=32, clip_len=4, n_clips=2, prefetch_depth=0)
    table = VideoTable(name="t", fnames=np.asarray(paths, object),
                       label_idx=np.zeros(3, np.int32), classes=["a"],
                       class_embed=np.ones((1, 300), np.float32),
                       loader="npy", is_validation=True, n_clips=2)
    hb = next(iter(HostPipeline(table, cfg, 4, seed=0)))
    want = jax_device_batch(hb, 2, 4, out_dtype=jnp.float32)
    got = device_batch(hb, 2, 4, torch.float32, "cpu")
    assert tuple(got["x"].shape) == (4, 2, 4, 32, 32, 3)
    np.testing.assert_allclose(got["x"].numpy(), np.asarray(want["x"]),
                               atol=1e-6, rtol=0)
    np.testing.assert_array_equal(got["weight"].numpy(), [1, 1, 1, 0])
