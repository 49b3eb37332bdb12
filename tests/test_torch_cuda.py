"""The CUDA kernels on the card: each against its plain PyTorch version on
the same CUDA tensors, the wrappers' refusals, and the port's model and
engine running through the kernels.

Every test here needs an NVIDIA GPU with nvcc and skips without one. The
module imports no JAX, so on a machine without it run it without the
repository's conftest (which sets up JAX):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from zeroshotvideoclassification_tpu.data.transform_params import (
    make_transform_params,
    resample_indices,
)
from zeroshotvideoclassification_tpu_torch.ops.bn_cuda import (
    bn_apply_relu,
    bn_apply_relu_cuda,
    bn_apply_relu_plain,
)
from zeroshotvideoclassification_tpu_torch.ops.resample import (
    fused_video_transform,
)
from zeroshotvideoclassification_tpu_torch.ops.resample_cuda import (
    fused_video_transform_cuda,
    video_transform,
)
from torch_helpers import (
    bf16_ulps,
    calibrate_bn,
    copy_bn,
    synthetic_clip,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc (run on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _transform_args(dev, b=3, t=5, hc=226, wc=226, seed=0):
    rng = np.random.default_rng(seed)
    canvas = rng.integers(0, 256, (b, t, hc, wc, 3), dtype=np.uint8)
    p = make_transform_params(np.array([[hc - 10, wc - 6]] * b), 112,
                              False, rng)
    p.flip[:] = np.arange(b) % 2 == 1
    idx = resample_indices(p, 112).astuple()
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in (canvas, *idx)]


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_k1_matches_plain(cuda, out_dtype):
    args = _transform_args(cuda)
    want = fused_video_transform(*args, out_dtype=out_dtype)
    before = fused_video_transform_cuda.launches
    got = video_transform(*args, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert fused_video_transform_cuda.launches == before + 1
    assert got.dtype == out_dtype and got.shape == (3, 5, 112, 112, 3)
    if out_dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=2e-6, rtol=0)
    else:
        assert bf16_ulps(got, want) <= 1.0


def test_k1_odd_canvas_and_refusals(cuda):
    args = _transform_args(cuda, b=2, t=3, hc=131, wc=173, seed=1)
    got = fused_video_transform_cuda(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, fused_video_transform(*args), atol=2e-6,
                               rtol=0)
    with pytest.raises(ValueError, match="contiguous"):
        fused_video_transform_cuda(args[0].transpose(2, 3), *args[1:])
    with pytest.raises(ValueError, match="y1"):
        fused_video_transform_cuda(args[0], args[1], args[2].cpu(),
                                   *args[3:])


def _bn_operands(dev, shape, dtype, with_res, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    c = shape[-1]
    stats = [torch.rand(c, device=dev, generator=g) + 0.5,
             torch.randn(c, device=dev, generator=g),
             torch.randn(c, device=dev, generator=g),
             torch.rand(c, device=dev, generator=g) * 2.7 + 0.3]
    x = torch.randn(shape, device=dev, generator=g).to(dtype)
    r = (torch.randn(shape, device=dev, generator=g).to(dtype)
         if with_res else None)
    return x, stats, r


@pytest.mark.parametrize("c", [45, 921])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_res", [False, True])
@pytest.mark.parametrize("relu", [True, False])
def test_k2_matches_plain(cuda, c, dtype, with_res, relu):
    x, stats, r = _bn_operands(cuda, (4, 3, 9, 11, c), dtype, with_res)
    want = bn_apply_relu_plain(x, *stats, r, relu)
    before = bn_apply_relu_cuda.launches
    got = bn_apply_relu(x, *stats, r, relu)
    torch.cuda.synchronize()
    assert bn_apply_relu_cuda.launches == before + 1
    assert got.dtype == dtype and got.shape == want.shape
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=2e-6, rtol=0)
    else:
        assert bf16_ulps(got, want) <= 1.0


def test_k2_refusals(cuda):
    x, stats, r = _bn_operands(cuda, (2, 3, 4, 45), torch.bfloat16, True)
    with pytest.raises(ValueError, match="contiguous"):
        bn_apply_relu_cuda(x.transpose(1, 2), *stats)
    with pytest.raises(ValueError, match="residual"):
        bn_apply_relu_cuda(x, *stats, r.float())
    with pytest.raises(ValueError, match="scale"):
        bn_apply_relu_cuda(x, stats[0].cpu(), *stats[1:])


def test_k2_index_past_2_pow_31(cuda):
    """An epilogue of more than 2^31 elements takes the kernel's 64-bit
    index path (the bucket-128 forward's largest, 512x16x56x56x144, has
    3.7e9); held against the plain version chunk by chunk."""
    c = 144
    rows = 2 ** 31 // c + 1000
    x, stats, r = _bn_operands(cuda, (rows, c), torch.bfloat16, True)
    assert x.numel() > 2 ** 31
    got = bn_apply_relu_cuda(x, *stats, r, True)
    torch.cuda.synchronize()
    chunk = 2 ** 20
    for s in range(0, rows, chunk):
        e = min(s + chunk, rows)
        want = bn_apply_relu_plain(x[s:e], *stats, r[s:e], True)
        assert bf16_ulps(got[s:e], want) <= 1.0, s


def test_model_forward_runs_through_the_kernels(cuda):
    """The full-depth r2plus1d_18 at a small input, in bf16 on the card,
    launches K2 at each of its 37 epilogues and tracks the CPU f32
    forward. Both share seeded per-channel BN statistics
    (torch_helpers.calibrate_bn)."""
    from zeroshotvideoclassification_tpu_torch.cli.infer import load_model
    from zeroshotvideoclassification_tpu_torch.config import Config
    from zeroshotvideoclassification_tpu_torch.train import eval_step

    cfg32 = Config(network="r2plus1d_18", compute_dtype="float32")
    cfg16 = Config(network="r2plus1d_18", compute_dtype="bfloat16")
    x = torch.from_numpy(np.stack([np.stack(
        [synthetic_clip(k, 8, 64, 64)] * 2) for k in range(2)]))
    x = (x.float() / 255.0 - 1.0) / 2.0
    m_cpu = calibrate_bn(load_model(cfg32, None, "cpu")[0], x, 1)
    m16 = copy_bn(m_cpu, load_model(cfg16, None, cuda)[0])
    want = eval_step(m_cpu, x)
    before = bn_apply_relu_cuda.launches
    got = eval_step(m16, x.to(cuda, torch.bfloat16)).cpu()
    assert bn_apply_relu_cuda.launches - before == 37
    cos = torch.nn.functional.cosine_similarity(got, want, dim=1)
    assert float(cos.min()) > 0.999, cos


def test_engine_on_the_card(cuda, tmp_path):
    from zeroshotvideoclassification_tpu_torch.serve import InferenceEngine

    paths = []
    for k in range(3):
        p = tmp_path / f"v{k}.npy"
        np.save(p, synthetic_clip(k, 12, 64, 86))
        paths.append(str(p))
    embed = np.random.default_rng(0).normal(size=(4, 300)).astype(np.float32)
    engine = InferenceEngine(["a", "b", "c", "d"], embed, n_clips=2,
                             clip_len=4, size=32, max_batch=4, device=cuda)
    try:
        k1 = fused_video_transform_cuda.launches
        k2 = bn_apply_relu_cuda.launches
        res = engine.classify(paths)
        assert [r["video"] for r in res] == paths
        assert all(r["top_class"] in "abcd" for r in res)
        assert fused_video_transform_cuda.launches == k1 + 1
        assert bn_apply_relu_cuda.launches == k2 + 37
    finally:
        engine.close()
